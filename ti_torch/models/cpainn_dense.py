"""Dense (N×N) pair formulation of the cPaiNN forward (port of
ti_tpu/models/cpainn_dense.py).

The complete edge list becomes the full (dst=i, src=j) pair grid: gathers
become broadcasts, the edge→node sums become masked contractions, and the
cross term collapses to one contraction because it uses the dst node's
equivariant features. Differentiable (torch.func forward mode serves the
divergence), and the plain reference the pair kernels are checked against.
With ``fused=True`` the message MLPs run as kernel B4 with its tangent
kernel B5 (ops/pallas_kernels.fused_edge_mlp_diff): forward mode only.
"""

from __future__ import annotations

import numpy as np
import torch

from ti_torch.models.cpainn import state_of
from ti_torch.models.embeddings import positional_encoding, temperature_encoding
from ti_torch.ops.graph import EdgeTable
from ti_torch.ops.mlp_block import BF16, _mlp_block, mlp_weights


def dense_edge_type_matrix(edges: EdgeTable) -> np.ndarray:
    """(N, N) int32 with [dst, src] = edge type (diagonal 0, unused)."""
    n = edges.n_nodes
    mat = np.zeros((n, n), dtype=np.int32)
    mat[np.asarray(edges.dst), np.asarray(edges.src)] = np.asarray(edges.edge_type)
    return mat


def _cross(a, b):
    """a × b over the last axis, written by components so every product
    and difference rounds in the operands' dtype."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def node_features(model, p, t, temps, atom_ids, n: int):
    """The combine MLP's input rows: [atom | T0 | T1 | time] encodings
    broadcast over the N nodes, (B, N, (2 + n_cond)·F) in f32."""
    f = model.n_features
    b = t.shape[0]
    ids = torch.as_tensor(atom_ids, device=t.device)
    feats = [p["atom_embed.weight"][ids].expand(b, n, f)]
    n_cond = {"ambient": 2, "latent": 1, "none": 0}[model.conditioning]
    for i in range(n_cond):
        enc = temperature_encoding(temps[:, i], f, model.temp_length, model.temperatures)
        feats.append(enc[:, None, :].expand(b, n, f))
    t_enc = positional_encoding(t, f, model.time_length)
    feats.append(t_enc[:, None, :].expand(b, n, f))
    return torch.cat(feats, dim=-1)


def apply_dense(
    model,
    params,
    x: torch.Tensor,      # (B, N, 3)
    t: torch.Tensor,      # (B,)
    temps: torch.Tensor,  # (B, K)
    atom_ids,             # (N,)
    edges: EdgeTable,
    *,
    compute_dtype=None,
    fused: bool = False,
    packed=None,
) -> torch.Tensor:
    """Batched velocity field, dense-pair layout: (B, N, 3) -> (B, N, 3).

    ``compute_dtype``: None (f32), ``torch.bfloat16`` (bf16 operands, f32
    accumulation) or "bf16_agg" (bf16 dot outputs too); params, positions,
    embeddings and the returned velocity stay f32.

    ``fused=True`` routes the message MLPs over the B·N² pair rows through
    ``fused_edge_mlp_diff`` (kernel B4, and B5 under forward-mode JVPs), in
    f32 only. ``packed`` is the message layers' packed weights
    (``pack_message_layers``), built once by the caller; None packs them
    here.
    """
    p = state_of(model, params)
    f = model.n_features
    b, n, _ = x.shape
    bf16_out = compute_dtype == "bf16_agg"
    cd = BF16 if bf16_out else compute_dtype
    if fused and cd is not None:
        raise ValueError(
            "fused=True is incompatible with compute_dtype: the fused edge-MLP "
            "kernels compute in f32 — use one or the other"
        )
    if fused:
        from ti_torch.ops.pallas_kernels import fused_edge_mlp_diff

        layers = packed if packed is not None else pack_message_layers(model, p, x.device)

        def message_mlps(in_feats, pe_rows, layer):
            rows = in_feats.reshape(b * n * n, -1).contiguous()
            pes = pe_rows.reshape(b * n * n, -1).contiguous()
            return fused_edge_mlp_diff(rows, pes, layers[layer]).reshape(b, n, n, -1)
    else:
        def message_mlps(in_feats, pe_rows, layer):
            pre = f"message_{layer}"
            return mlp(in_feats, f"{pre}.phi") * mlp(pe_rows, f"{pre}.w")

    def c(a):
        return a.to(cd) if cd is not None else a

    def mlp(rows, prefix):
        return _mlp_block(c(rows), mlp_weights(p, prefix), compute_dtype=cd,
                          bf16_out=bf16_out)

    def ein(eq, a, bb):
        if cd is None:
            return torch.einsum(eq, a, bb)
        return torch.einsum(eq, a.float(), bb.float()).to(cd)

    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    # pair grid: i = dst, j = src; r[i, j] = x[j] - x[i]
    r = x[:, None, :, :] - x[:, :, None, :]
    dist = torch.linalg.norm(r + eye[None, :, :, None], dim=-1)  # keep diag finite
    dist = dist * (1.0 - eye)[None]
    direc = c(r / (1.0 + dist[..., None]))
    mask = c((1.0 - eye)[None, :, :, None])

    etype = torch.as_tensor(dense_edge_type_matrix(edges), device=x.device).long()
    if model.cutoff is not None:
        # non-bonded pairs beyond the cutoff drop out; bond pairs stay active
        active = (etype > 0)[None] | (dist <= model.cutoff)
        mask = mask * c(active[..., None].to(x.dtype))
    e = c(p["edge_embed.weight"][etype]).expand(b, n, n, f)

    s = c(mlp(node_features(model, p, t, temps, atom_ids, n), "combine"))
    v = torch.zeros(b, n, f, 3, dtype=cd or x.dtype, device=x.device)
    pe = c(positional_encoding(dist, f, model.length_scale))

    for layer in range(model.score_layers):
        s_src = s[:, None, :, :].expand(b, n, n, f)
        in_feats = torch.cat([s_src, e], dim=-1)
        h = c(message_mlps(in_feats, pe, layer))
        gates, scale_dir, ds, de, cg = torch.split(h * mask, f, dim=-1)

        dv = (
            ein("bijf,bjfc->bifc", gates, v)
            + ein("bijf,bijc->bifc", scale_dir, direc)
            + _cross(ein("bijf,bijc->bifc", cg, direc), v)
        )
        s = s + c(ds.sum(dim=2, dtype=torch.float32))
        v = v + dv
        # de is diagonal-masked; the diagonal entries are never consumed
        e = e + de

        up = f"update_{layer}"
        uv = ein("bnfc,gf->bngc", v, c(p[f"{up}.u.weight"]))
        vv = ein("bnfc,gf->bngc", v, c(p[f"{up}.v.weight"]))
        vv_norm = torch.linalg.norm(vv.float(), dim=-1)
        hu = mlp(torch.cat([c(vv_norm), s], dim=-1), f"{up}.mlp")
        g_u, scale_sq, add_inv = torch.split(hu, f, dim=-1)
        v = v + c(g_u)[..., None] * uv
        s = s + c(vv_norm ** 2 * scale_sq + add_inv)

    hr = mlp(s, "readout.mlp")  # (B, N, 2)
    v_out = ein("bnfc,gf->bngc", v, c(p["readout.V.weight"]))
    return (hr[..., 1:2] * v_out[:, :, 0, :].float()).to(x.dtype)


def pack_message_layers(model, params, device) -> list:
    """The message layers' MLPs packed once, in f32, for the fused kernels,
    each carrying its 3xTF32 split (``with_tf32_weights``), which B5 on the
    tensor cores reads."""
    from ti_torch.ops.pair_layer_kernel import pack_layer, with_tf32_weights

    p = state_of(model, params)
    return [with_tf32_weights(pack_layer(p, i, model.n_features, torch.float32, device))
            for i in range(model.score_layers)]


def dense_velocity_fn(model, params, template, compute_dtype=None):
    """Batched drift (xs (B,N,3), t scalar-or-(B,), temps (B,K)) -> (B,N,3)."""
    p = state_of(model, params)

    def drift(xs, t, temps):
        tb = torch.as_tensor(t, dtype=xs.dtype, device=xs.device).expand(xs.shape[0])
        return apply_dense(model, p, xs, tb, temps, template.atom_ids,
                           template.edges, compute_dtype=compute_dtype)

    return drift
