"""Fused-inference cPaiNN forward in the edge-row formulation (port of
ti_tpu/models/cpainn_fused.py).

The same velocity as ``apply_dense`` on the complete graph, written over
the B·N(N−1) edge rows of the dst-major ``EdgeTable``: gathers over
``src``/``dst``, the message MLPs as kernel B4 (``fused_edge_mlp``) and the
combine, update and readout MLPs as kernel B6 (``fused_mlp``), so no
(rows, 5F) MLP intermediate reaches device memory. The dst-major complete
graph makes the scatter to the nodes a reshape-sum. Inference only: the
kernels have no derivative rules here.

Per forward: one B6 launch for the combine MLP, per message layer one B4
and one B6 (the update), one B6 for the readout — 5 B4 and 7 B6 launches
at 5 layers.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from ti_torch.models.cpainn import state_of
from ti_torch.models.cpainn_dense import _cross, node_features
from ti_torch.models.embeddings import positional_encoding
from ti_torch.ops.graph import EdgeTable
from ti_torch.ops.mlp_block import mlp_weights
from ti_torch.ops.pair_layer_kernel import PairLayerWeights, pack_layer, with_tf32_weights
from ti_torch.ops.pallas_kernels import MLPPack, fused_edge_mlp, fused_mlp, pack_mlp


class FusedWeights(NamedTuple):
    """Every MLP of a CPaiNN packed once for kernels B4 and B6; each message
    layer carries its 3xTF32 split (``with_tf32_weights``), which B4 on the
    tensor cores reads."""

    combine: MLPPack
    messages: List[PairLayerWeights]
    updates: List[MLPPack]
    readout: MLPPack


def pack_fused(model, params, device) -> FusedWeights:
    p = state_of(model, params)
    f, layers = model.n_features, range(model.score_layers)
    return FusedWeights(
        combine=pack_mlp(mlp_weights(p, "combine"), device),
        messages=[with_tf32_weights(pack_layer(p, i, f, torch.float32, device)) for i in layers],
        updates=[pack_mlp(mlp_weights(p, f"update_{i}.mlp"), device) for i in layers],
        readout=pack_mlp(mlp_weights(p, "readout.mlp"), device),
    )


def apply_fused(
    model,
    params,
    x: torch.Tensor,      # (B, N, 3)
    t: torch.Tensor,      # (B,)
    temps: torch.Tensor,  # (B, K)
    atom_ids,             # (N,)
    edges: EdgeTable,
    *,
    packed: FusedWeights = None,
) -> torch.Tensor:
    """Batched velocity field: (B, N, 3) -> (B, N, 3), f32. ``packed`` is
    ``pack_fused``'s result, built once by the caller; None packs here."""
    if getattr(model, "cutoff", None) is not None:
        raise NotImplementedError(
            "apply_fused runs the complete graph only (cutoff=None); use apply_dense"
        )
    if not edges.dst_major_complete:
        raise ValueError("apply_fused needs the dst-major complete edge table")
    p = state_of(model, params)
    pk = packed if packed is not None else pack_fused(model, p, x.device)
    f = model.n_features
    b, n, _ = x.shape
    dev = x.device
    src = torch.as_tensor(edges.src, device=dev).long()
    dst = torch.as_tensor(edges.dst, device=dev).long()
    e_count = src.shape[0]

    # spatial edge features
    r = x[:, src] - x[:, dst]  # (B, E, 3)
    dist = torch.linalg.norm(r, dim=-1)
    edge_dir = r / (1.0 + dist[..., None])

    etype = torch.as_tensor(edges.edge_type, device=dev).long()
    e = p["edge_embed.weight"][etype].expand(b, e_count, f)
    feats = node_features(model, p, t, temps, atom_ids, n).reshape(b * n, -1)
    s = fused_mlp(feats.contiguous(), pk.combine).reshape(b, n, f)
    v = torch.zeros((b, n, f, 3), dtype=x.dtype, device=dev)
    pe = positional_encoding(dist, f, model.length_scale).reshape(b * e_count, f).contiguous()

    for layer in range(model.score_layers):
        in_rows = torch.cat([s[:, src], e], dim=-1).reshape(b * e_count, 2 * f)
        h = fused_edge_mlp(in_rows, pe, pk.messages[layer]).reshape(b, e_count, 5 * f)
        gates, scale_dir, ds, de, cross_gates = torch.split(h, f, dim=-1)

        gated = gates[..., None] * v[:, src]
        scaled_dir = scale_dir[..., None] * edge_dir[:, :, None, :]
        v_dst = v[:, dst]
        cross = _cross(edge_dir[:, :, None, :].expand_as(v_dst), v_dst)
        msgs = scaled_dir + gated + cross_gates[..., None] * cross  # (B, E, F, 3)
        # dst-major complete graph: scatter == reshape-sum
        s = s + ds.reshape(b, n, n - 1, f).sum(2)
        v = v + msgs.reshape(b, n, n - 1, f, 3).sum(2)
        e = e + de

        up = f"update_{layer}"
        uv = torch.einsum("bnfc,gf->bngc", v, p[f"{up}.u.weight"])
        vv = torch.einsum("bnfc,gf->bngc", v, p[f"{up}.v.weight"])
        vv_norm = torch.linalg.norm(vv, dim=-1)
        hu = fused_mlp(torch.cat([vv_norm, s], dim=-1).reshape(b * n, 2 * f),
                       pk.updates[layer]).reshape(b, n, 3 * f)
        g_u, scale_sq, add_inv = torch.split(hu, f, dim=-1)
        v = v + g_u[..., None] * uv
        s = s + vv_norm ** 2 * scale_sq + add_inv

    hr = fused_mlp(s.reshape(b * n, f), pk.readout).reshape(b, n, 2)
    v_out = torch.einsum("bnfc,gf->bngc", v, p["readout.V.weight"])  # (B, N, 1, 3)
    return hr[..., 1:2] * v_out[:, :, 0, :]


def fused_velocity_fn(model, params, template, *, device=None):
    """Batched drift ``(xs (B,N,3), t scalar-or-(B,), temps (B,K)) ->
    (B,N,3)`` through kernels B4 and B6. Packs the weights once, here.
    Runs on ``cuda`` unless ``device`` says otherwise."""
    from ti_torch import resolve_device

    dev = resolve_device(device)
    p = {k: t.detach().to(dev) for k, t in state_of(model, params).items()}
    packed = pack_fused(model, p, dev)

    @torch.no_grad()
    def drift(xs, t, temps):
        tb = torch.as_tensor(t, dtype=xs.dtype, device=xs.device).expand(xs.shape[0])
        return apply_fused(model, p, xs, tb, temps, template.atom_ids, template.edges,
                           packed=packed)

    return drift
