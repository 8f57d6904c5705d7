"""Divergence (Jacobian-trace) estimators for probability-flow dlogp
(port of ti_tpu/ops/divergence.py).

The functions here act on a batch of independent chains: ``x`` is
(B, ...) and ``f`` maps a batch to a batch with no coupling between
chains, so the Jacobian is block diagonal and one forward-mode tangent
per lane serves every chain at once. The trace is over each chain's
flattened state (d = prod(x.shape[1:])).

- ``divergence_exact``: trace(J) from d forward-mode JVPs against the
  identity basis (``torch.func.jvp`` under ``vmap``).
- ``divergence_hutchinson``: Σ_k w_k z_kᵀ J z_k with rademacher or Haar
  orthogonal probes (``_probe_block``), drawn from a ``torch.Generator``
  or passed in explicitly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.func import jvp, vmap


def _probe_block(generator: torch.Generator, k: int, d: int, mode: str, *,
                 shape=(), dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(*shape, k, d) probe rows Z and (*shape, k) weights w with
    E[Zᵀ diag(w) Z] = I, drawn on the generator's device.

    ``rademacher``: iid ±1 rows, w = 1/k. ``orthogonal``: k ≤ d
    Haar-orthonormal rows (QR of a Gaussian, signs fixed so the frame is
    exactly Haar), w = d/k — unbiased for any J and exact at k = d, where
    QᵀQ = I.
    """
    dev = generator.device
    if mode == "rademacher":
        z = torch.randint(0, 2, (*shape, k, d), generator=generator, device=dev)
        return (2 * z - 1).to(dtype), torch.full((*shape, k), 1.0 / k, dtype=dtype, device=dev)
    if mode == "orthogonal":
        if k > d:
            raise ValueError(
                f"orthogonal probe_mode needs num_probes <= dim ({k} > {d}); "
                "use num_probes=dim (exact) or probe_mode='rademacher'"
            )
        # QR in f32 whatever the compute dtype; probes cast back
        g = torch.randn((*shape, d, k), generator=generator, device=dev, dtype=torch.float32)
        q, r = torch.linalg.qr(g)
        q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[..., None, :]
        return q.transpose(-1, -2).to(dtype), torch.full((*shape, k), d / k, dtype=dtype, device=dev)
    raise ValueError(f"unknown probe_mode {mode!r} (rademacher | orthogonal)")


def hutchinson_var_estimate(est: torch.Tensor, w: torch.Tensor, d: int, mode: str) -> torch.Tensor:
    """Plug-in variance of the Hutchinson trace ESTIMATOR from its K
    per-probe contributions ``est`` (..., K) and weights ``w`` (..., K).

    rademacher: the sample variance over K. orthogonal: the iid plug-in
    times the Haar frame's without-replacement factor (d-K)/(d-1) —
    approximate, exact (zero) at K = d."""
    k = est.shape[-1]
    s2 = est.var(dim=-1, unbiased=False) * (k / max(k - 1, 1))
    if mode == "orthogonal":
        fac = (d - k) / max(d - 1, 1)
        return w.sum(-1) ** 2 * s2 / k * fac
    return s2 / k


def _lane_jvps(f, x: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """J·z for each lane z of ``lanes`` (K, B, ...) -> (K, B, ...)."""
    return vmap(lambda z: jvp(f, (x,), (z,))[1])(lanes)


def divergence_exact(f, x: torch.Tensor):
    """(f(x), trace(J) per chain (B,)) from the d identity-basis JVPs."""
    b = x.shape[0]
    d = x[0].numel()
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    lanes = eye.reshape(d, 1, *x.shape[1:]).expand(d, *x.shape)
    jz = _lane_jvps(f, x, lanes).reshape(d, b, d)
    return f(x), torch.einsum("kbk->b", jz)


def divergence_hutchinson(f, x: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                          num_probes: int = 8, probe_mode: str = "rademacher",
                          return_var: bool = False, z: Optional[torch.Tensor] = None,
                          w: Optional[torch.Tensor] = None):
    """(f(x), Σ_k w_k z_kᵀ J z_k per chain[, its plug-in variance]).

    Probes z (B, K, d) and weights w (B, K) are drawn per chain from
    ``generator`` unless given."""
    b = x.shape[0]
    d = x[0].numel()
    if z is None:
        z, w = _probe_block(generator, num_probes, d, probe_mode, shape=(b,), dtype=x.dtype)
    k = z.shape[1]
    lanes = z.transpose(0, 1).reshape(k, *x.shape)
    jz = _lane_jvps(f, x, lanes).reshape(k, b, d)
    est = (z.transpose(0, 1) * jz).sum(-1).transpose(0, 1)  # (B, K)
    div = (w * est).sum(-1)
    if return_var:
        return f(x), div, hutchinson_var_estimate(est, w, d, probe_mode)
    return f(x), div
