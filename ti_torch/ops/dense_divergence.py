"""Hand-propagated lane-batched JVP for the dense-pair cPaiNN divergence
(port of ti_tpu/ops/dense_divergence.py).

The exact divergence needs 3N tangent lanes through the whole network per
evaluation. This module writes the forward-mode propagation by hand with
the lane axis explicit:

- layer-0 input tangents (s, e) are structurally zero and skipped;
- the positional-encoding tangent factors through the scalar distance
  (d_pe = PE'(dist) * d_dist), so no per-lane encoding is materialised;
- tangent MLP products run with the lane axis folded into rows;
- only the diagonal entries of the readout tangent are computed.

Plain PyTorch, no kernel: it is the reference of kernel B7
(ops/div_kernel.py), whose chunk body is the same math, and a reference
for B3. Per chain, as in the JAX package: ``x`` is (N, 3), ``t`` a scalar,
``temps`` (K,). Conventions follow models/cpainn_dense.py (dst = i,
src = j, r[i, j] = x[j] - x[i]).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.func import jvp

from ti_torch.models.cpainn import state_of
from ti_torch.models.cpainn_dense import _cross, dense_edge_type_matrix, node_features
from ti_torch.models.embeddings import positional_encoding
from ti_torch.ops.graph import EdgeTable
from ti_torch.ops.mlp_block import _mlp_block, _mlp_block_jvp, mlp_weights


def _mlp_tangent_only(x, dx, w):
    """Tangent of the MLP with the lane axis in front: x (..., R, Fin),
    dx (L, ..., R, Fin) -> (L, ..., R, Fout). The primal chain runs once and
    broadcasts over the lanes, so the per-lane work is the linear tangent
    map."""
    return _mlp_block_jvp(x, dx, w)[1]


def dense_divergence(model, params, x: torch.Tensor, t, temps: torch.Tensor, atom_ids,
                     edges: EdgeTable, lane_chunk: Optional[int] = None):
    """(velocity (N, 3), divergence scalar) of one chain with hand-propagated
    tangents. ``params`` None takes the module's own weights. ``lane_chunk``
    bounds how many of the 3N lanes are in flight; None = all at once.
    The complete graph only, as in the JAX package, which ignores a cutoff
    here; the port refuses one."""
    if getattr(model, "cutoff", None) is not None:
        raise NotImplementedError("dense_divergence computes the complete graph only (cutoff=None)")
    p = state_of(model, params)
    f = model.n_features
    n = x.shape[0]
    d = 3 * n
    dev, dt = x.device, x.dtype

    def mlp(rows, prefix):
        return _mlp_block(rows, mlp_weights(p, prefix))

    # ----- primal geometry (pair grid; i = dst, j = src) -----
    r = x[None, :, :] - x[:, None, :]  # r[i, j] = x[j] - x[i]
    eye = torch.eye(n, dtype=dt, device=dev)
    dist = torch.linalg.norm(r + eye[:, :, None], dim=-1) * (1.0 - eye)
    direc = r / (1.0 + dist[..., None])
    mask = (1.0 - eye)[..., None]
    pe = positional_encoding(dist, f, model.length_scale)
    pe_prime = jvp(lambda dd: positional_encoding(dd, f, model.length_scale),
                   (dist,), (torch.ones_like(dist),))[1]

    etype = torch.as_tensor(dense_edge_type_matrix(edges), device=dev).long()
    e0 = p["edge_embed.weight"][etype]  # (N, N, F)
    tt = torch.as_tensor(t, dtype=dt, device=dev).reshape(1)
    s0 = mlp(node_features(model, p, tt, temps.reshape(1, -1), atom_ids, n)[0], "combine")

    # ----- primal forward, stashing per-layer states -----
    s, v, e = s0, torch.zeros((n, f, 3), dtype=dt, device=dev), e0
    layer_states = []
    for layer in range(model.score_layers):
        mp, up = f"message_{layer}", f"update_{layer}"
        in_feats = torch.cat([s[None].expand(n, n, f), e], dim=-1)
        h = mlp(in_feats, f"{mp}.phi") * mlp(pe, f"{mp}.w") * mask
        gates, scale_dir, ds, de, cg = torch.split(h, f, dim=-1)
        q = torch.einsum("ijf,ijc->ifc", cg, direc)
        dv = (torch.einsum("ijf,jfc->ifc", gates, v)
              + torch.einsum("ijf,ijc->ifc", scale_dir, direc) + _cross(q, v))
        s1, v1 = s + ds.sum(1), v + dv
        uv = torch.einsum("nfc,gf->ngc", v1, p[f"{up}.u.weight"])
        vv = torch.einsum("nfc,gf->ngc", v1, p[f"{up}.v.weight"])
        vvn = torch.linalg.norm(vv, dim=-1)
        g_u, scale_sq, add_inv = torch.split(mlp(torch.cat([vvn, s1], -1), f"{up}.mlp"), f, -1)
        layer_states.append((s, v, e))
        v = v1 + g_u[..., None] * uv
        s = s1 + vvn ** 2 * scale_sq + add_inv
        e = e + de
    s_fin, v_fin = s, v
    hr = mlp(s_fin, "readout.mlp")  # (N, 2)
    v_out = torch.einsum("nfc,gf->ngc", v_fin, p["readout.V.weight"])  # (N, 1, 3)
    velocity = hr[:, 1:2] * v_out[:, 0, :]

    # ----- lane-batched tangent propagation -----
    def tangent_chunk(lane_idx):
        """lane_idx (L,) flat (atom, coord) indices -> (L,) diagonal
        Jacobian entries d velocity[atom_l, coord_l] / d x[lane]."""
        L = lane_idx.shape[0]
        onehot_a = F.one_hot(lane_idx // 3, n).to(dt)  # (L, N)
        onehot_c = F.one_hot(lane_idx % 3, 3).to(dt)  # (L, 3)
        # d_r[l, i, j, c] = (δ_{j,a} - δ_{i,a}) δ_{c,c_l}
        d_r = (onehot_a[:, None, :, None] - onehot_a[:, :, None, None]) * onehot_c[:, None, None, :]
        d_dist = (r * d_r).sum(-1) / (dist + eye) * (1.0 - eye)  # (L, N, N)
        d_direc = d_r / (1.0 + dist[..., None]) - r[None] * (d_dist / (1.0 + dist) ** 2)[..., None]
        d_pe = pe_prime[None] * d_dist[..., None]  # (L, N, N, F)

        d_s = torch.zeros((L, n, f), dtype=dt, device=dev)
        d_v = torch.zeros((L, n, f, 3), dtype=dt, device=dev)
        d_e = torch.zeros((L, n, n, f), dtype=dt, device=dev)
        for layer in range(model.score_layers):
            mp, up = f"message_{layer}", f"update_{layer}"
            s, v, e = layer_states[layer]
            in_feats = torch.cat([s[None].expand(n, n, f), e], dim=-1).reshape(n * n, 2 * f)
            w_phi, w_w = mlp_weights(p, f"{mp}.phi"), mlp_weights(p, f"{mp}.w")
            phi_out = _mlp_block(in_feats, w_phi)
            w_out = _mlp_block(pe.reshape(n * n, f), w_w)
            d_w = _mlp_tangent_only(pe.reshape(n * n, f), d_pe.reshape(L, n * n, f), w_w)
            d_h = phi_out[None] * d_w
            if layer > 0:
                d_in = torch.cat([d_s[:, None].expand(L, n, n, f), d_e], -1).reshape(L, n * n, 2 * f)
                d_h = d_h + _mlp_tangent_only(in_feats, d_in, w_phi) * w_out[None]
            h = (phi_out * w_out).reshape(n, n, 5 * f) * mask
            d_h = d_h.reshape(L, n, n, 5 * f) * mask[None]
            gates, scale_dir, ds_, _, cg = torch.split(h, f, dim=-1)
            d_gates, d_scale_dir, d_ds, d_de, d_cg = torch.split(d_h, f, dim=-1)

            q = torch.einsum("ijf,ijc->ifc", cg, direc)
            d_q = (torch.einsum("lijf,ijc->lifc", d_cg, direc)
                   + torch.einsum("ijf,lijc->lifc", cg, d_direc))
            d_dv = (torch.einsum("lijf,jfc->lifc", d_gates, v)
                    + torch.einsum("ijf,ljfc->lifc", gates, d_v)
                    + torch.einsum("lijf,ijc->lifc", d_scale_dir, direc)
                    + torch.einsum("ijf,lijc->lifc", scale_dir, d_direc)
                    + _cross(d_q, v[None]) + _cross(q[None], d_v))
            dv = (torch.einsum("ijf,jfc->ifc", gates, v)
                  + torch.einsum("ijf,ijc->ifc", scale_dir, direc) + _cross(q, v))
            s1, v1 = s + ds_.sum(1), v + dv
            d_s1, d_v1 = d_s + d_ds.sum(2), d_v + d_dv
            d_e = d_e + d_de

            u_k, v_k = p[f"{up}.u.weight"], p[f"{up}.v.weight"]
            uv = torch.einsum("nfc,gf->ngc", v1, u_k)
            vv = torch.einsum("nfc,gf->ngc", v1, v_k)
            d_uv = torch.einsum("lnfc,gf->lngc", d_v1, u_k)
            d_vv = torch.einsum("lnfc,gf->lngc", d_v1, v_k)
            vvn = torch.linalg.norm(vv, dim=-1)
            d_vvn = (vv[None] * d_vv).sum(-1) / (vvn[None] + 1e-30)
            hu_in = torch.cat([vvn, s1], -1)
            w_up = mlp_weights(p, f"{up}.mlp")
            g_u, scale_sq, _ = torch.split(_mlp_block(hu_in, w_up), f, -1)
            d_hu = _mlp_tangent_only(hu_in, torch.cat([d_vvn, d_s1], -1), w_up)
            d_g_u, d_scale_sq, d_add_inv = torch.split(d_hu, f, -1)
            d_v = d_v1 + d_g_u[..., None] * uv[None] + g_u[None, ..., None] * d_uv
            d_s = d_s1 + 2.0 * vvn[None] * d_vvn * scale_sq[None] + (vvn ** 2)[None] * d_scale_sq + d_add_inv

        # readout tangent, diagonal entries only
        d_hr = _mlp_tangent_only(s_fin, d_s, mlp_weights(p, "readout.mlp"))  # (L, N, 2)
        d_v_out = torch.einsum("lnfc,gf->lngc", d_v, p["readout.V.weight"])  # (L, N, 1, 3)
        d_vel = d_hr[:, :, 1:2] * v_out[None, :, 0, :] + hr[None, :, 1:2] * d_v_out[:, :, 0, :]
        return (d_vel * onehot_a[:, :, None] * onehot_c[:, None, :]).sum((1, 2))

    lanes = torch.arange(d, device=dev)
    if lane_chunk is None or lane_chunk >= d:
        return velocity, tangent_chunk(lanes).sum()
    n_chunks = -(-d // lane_chunk)
    pad = n_chunks * lane_chunk - d
    # pad with repeated lane 0, subtract its extra contributions
    lanes_p = torch.cat([lanes, torch.zeros(pad, dtype=lanes.dtype, device=dev)])
    partial = torch.stack([tangent_chunk(c).sum() for c in lanes_p.reshape(n_chunks, lane_chunk)])
    extra = tangent_chunk(lanes[:1])[0] * pad if pad else 0.0
    return velocity, partial.sum() - extra


def dense_divergence_fn(model, params, template, lane_chunk: Optional[int] = None):
    """Per-chain (x, t, temps) -> (velocity, divergence) closure."""

    def f(x, t, temps):
        return dense_divergence(model, params, x, t, temps, template.atom_ids,
                                template.edges, lane_chunk=lane_chunk)

    return f
