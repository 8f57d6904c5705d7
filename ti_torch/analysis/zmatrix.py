"""Internal coordinates: z-matrix construction and NeRF reconstruction.

The port of ti_tpu/analysis/zmatrix.py to PyTorch (reference
mdqm9/analysis/utils/z_matrix.py and mol_geometry.py, adapted there from the
public olsson-group/sma-md). Every function works on tensors on whatever
device they lie on: construction is vectorised over the leading axes, and
the sequential NeRF reconstruction is a loop over the placement order,
N - 3 steps, each vectorised over the batch, with the log|det J|
accumulated in the loop (where ti_tpu carries it through a ``lax.scan``).

Conventions (kept identical):
- ref_atoms row i = (r_dist, r_angle, r_torsion): distance of atom i to
  r_dist, angle (i, r_dist, r_angle), torsion (i, r_dist, r_angle,
  r_torsion). Rows 0..2 are partially undefined (use -1 placeholders).
- torsions via atan2, range (-pi, pi] (mol_geometry.py:58-81).
- placement uses the (pi - angle) spherical convention of the reference
  ic_to_xyz (mol_geometry.py:114-165), so construct∘deconstruct is exactly
  identity.
- log|det J| counts the atom-2 (2x2) block plus one 3x3 block per placed
  atom (z_matrix.py:160-175, 196-221); atom 1's 1-D block is identity.
- ``+ 1e-300`` inside the logs, as in ti_tpu: it rounds to 0 in float32,
  so a zero distance gives -inf there in both packages.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# geometry primitives (vectorized over any leading axes)
# ---------------------------------------------------------------------------

def compute_distance(x1: Tensor, x2: Tensor) -> Tensor:
    return torch.linalg.norm(x2 - x1, dim=-1)


def compute_angle(x1: Tensor, x2: Tensor, x3: Tensor) -> Tensor:
    """Angle at x2 spanned by (x1, x2, x3), radians in [0, pi]."""
    u = x1 - x2
    v = x3 - x2
    cosang = torch.sum(u * v, dim=-1) / (
        torch.linalg.norm(u, dim=-1) * torch.linalg.norm(v, dim=-1)
    )
    return torch.arccos(torch.clamp(cosang, -1.0, 1.0))


def compute_torsion(x1: Tensor, x2: Tensor, x3: Tensor, x4: Tensor) -> Tensor:
    """Dihedral of the ordered quadruple, atan2 form, range (-pi, pi]."""
    b1 = x2 - x1
    b2 = x3 - x2
    b3 = x4 - x3
    c23 = torch.linalg.cross(b2, b3, dim=-1)
    y = torch.linalg.norm(b2, dim=-1) * torch.sum(b1 * c23, dim=-1)
    x = torch.sum(torch.linalg.cross(b1, b2, dim=-1) * c23, dim=-1)
    return torch.arctan2(y, x)


def ic_to_xyz(
    p1: Tensor, p2: Tensor, p3: Tensor, d: Tensor, ang: Tensor, tor: Tensor
) -> Tuple[Tensor, Tensor]:
    """Place an atom from internal coordinates relative to (p3, p2, p1).

    p3 is the distance reference, p2 the angle reference, p1 the torsion
    reference (reference mol_geometry.py:114-165); p* are (..., 3), d, ang
    and tor (...). Returns (position, |det J| of the (d, ang, tor) ->
    local-xyz map) = d^2 sin(ang).
    """
    th = math.pi - ang
    d_local = torch.stack(
        [d * torch.cos(th), d * torch.sin(th) * torch.cos(tor), d * torch.sin(th) * torch.sin(tor)],
        dim=-1,
    )
    x23 = p3 - p2
    x23 = x23 / torch.linalg.norm(x23, dim=-1, keepdim=True)
    x12 = p2 - p1
    n = torch.linalg.cross(x12, x23, dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    frame = torch.stack([x23, torch.linalg.cross(n, x23, dim=-1), n], dim=-1)  # columns
    pos = p3 + torch.einsum("...ij,...j->...i", frame, d_local)
    det = d**2 * torch.sin(th)  # analytic |det| of the reference J_det matrix
    return pos, torch.abs(det)


# ---------------------------------------------------------------------------
# z-matrix construction (vectorized)
# ---------------------------------------------------------------------------

def _refs_array(ref_atoms) -> np.ndarray:
    """Normalize a ref_atoms list-of-triplets (None-padded) to (N, 3) int."""
    n = len(ref_atoms)
    out = np.zeros((n, 3), dtype=np.int64)
    for i, row in enumerate(ref_atoms):
        for j, v in enumerate(row):
            out[i, j] = -1 if v is None else int(v)
    return out


def construct_z_matrix(X: Tensor, ref_atoms, placing_order=None) -> Tensor:
    """Z-matrix (..., N-1, 3) from cartesians (..., N, 3), on X's device
    and in its dtype.

    Column 0: distances (atoms 1..N-1 to ref0); column 1: angles (atoms
    2..); column 2: torsions (atoms 3..). Mirrors the reference slicing
    (z_matrix.py:56-102) but over arbitrary leading batch axes.
    """
    refs = _refs_array(ref_atoms)
    n = refs.shape[0]
    order = np.arange(n) if placing_order is None else np.asarray(placing_order)

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=X.device)

    i3, i2, i1 = refs[:, 0], refs[:, 1], refs[:, 2]
    x4 = X[..., idx(order), :]
    x3 = X[..., idx(np.maximum(i3[1:], 0)), :]
    x2 = X[..., idx(np.maximum(i2[2:], 0)), :]
    x1 = X[..., idx(np.maximum(i1[3:], 0)), :]

    dist = compute_distance(x4[..., 1:, :], x3)
    ang = compute_angle(x4[..., 2:, :], x3[..., 1:, :], x2)
    tor = compute_torsion(x1, x2[..., 1:, :], x3[..., 2:, :], x4[..., 3:, :])

    z = X.new_zeros(X.shape[:-2] + (n - 1, 3))
    z[..., :, 0] = dist
    z[..., 1:, 1] = ang
    z[..., 2:, 2] = tor
    return z


construct_z_matrix_batch = construct_z_matrix  # batched by broadcasting


# ---------------------------------------------------------------------------
# NeRF reconstruction with log|det J| (a loop over the placement order)
# ---------------------------------------------------------------------------

def deconstruct_z_matrix(z: Tensor, ref_atoms, jacobian: bool = True):
    """Cartesians (..., N, 3) from z-matrices (..., N-1, 3), on z's device.

    Atom 0 at the origin, atom 1 on +x, atom 2 in the xy-plane (reference
    z_matrix.py:186-211), then sequential NeRF placement: one step an atom,
    each over every leading index at once. Returns (cartesian, logdetJ)
    or just cartesian if jacobian=False.
    """
    refs = _refs_array(ref_atoms)
    n = refs.shape[0]

    # protection clamps (reference z_matrix.py:140-143)
    d_all = torch.clamp(z[..., :, 0], min=0.0)
    a_all = torch.clamp(z[..., :, 1], 0.0, math.pi)
    t_all = z[..., :, 2]

    zero = torch.zeros_like(d_all[..., 0])
    pos = [torch.stack([zero, zero, zero], dim=-1),
           torch.stack([d_all[..., 0], zero, zero], dim=-1)]

    # atom 2 in the xy-plane, relative to its distance reference
    flip = bool(refs[2, 0])  # reference: `if ref_atoms[2][0]:`
    ang2 = math.pi - a_all[..., 1] if flip else a_all[..., 1]
    x_base = pos[refs[2, 0]][..., 0]
    pos.append(torch.stack([x_base + d_all[..., 1] * torch.cos(ang2),
                            d_all[..., 1] * torch.sin(ang2), zero], dim=-1))
    logdet = torch.log(torch.abs(d_all[..., 1]) + 1e-300)  # |det| of the 2x2 block = d

    for i in range(3, n):
        r = refs[i]
        p, det = ic_to_xyz(pos[r[2]], pos[r[1]], pos[r[0]],
                           d_all[..., i - 1], a_all[..., i - 1], t_all[..., i - 1])
        pos.append(p)
        logdet = logdet + torch.log(det + 1e-300)

    cart = torch.stack(pos, dim=-2)
    if jacobian:
        return cart, logdet
    return cart


deconstruct_z_matrix_batch = deconstruct_z_matrix  # batched over the leading axes


def compute_jacobian_batch(z: Tensor, ref_atoms) -> Tensor:
    """log|det J| only (reference z_matrix.py:245-297): 2x2 block + per-atom
    3x3 dets, closed form d^2 sin(angle)."""
    d = torch.clamp(z[..., :, 0], min=0.0)
    a = torch.clamp(z[..., :, 1], 0.0, math.pi)
    logdet = torch.log(torch.abs(d[..., 1]) + 1e-300)
    per_atom = torch.log(d[..., 2:] ** 2 * torch.sin(math.pi - a[..., 2:]) + 1e-300)
    return logdet + torch.sum(per_atom, dim=-1)


def valid_z_mask(z: Tensor) -> Tensor:
    """Validity mask per conformation (reference correct_conf_indexes,
    z_matrix.py:300-310): d > 0, 0 <= angle <= pi, -pi < torsion <= pi."""
    ok_d = torch.all(z[..., :, 0] > 0, dim=-1)
    ok_a = torch.all((z[..., 1:, 1] >= 0) & (z[..., 1:, 1] <= math.pi), dim=-1)
    ok_t = torch.all((z[..., 2:, 2] > -math.pi) & (z[..., 2:, 2] <= math.pi), dim=-1)
    return ok_d & ok_a & ok_t
