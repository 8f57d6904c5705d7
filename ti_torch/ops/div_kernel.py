"""Whole-network exact divergence of the dense-pair cPaiNN — kernel B7,
hand-written CUDA, with its plain PyTorch version beside it: on the tensor
cores in 3xTF32 (csrc/div_kernel_tf32x3.cu, ``variant="tc"``, every
layer's matrices split and packed by ``pack_tf32_stacks``) or in f32 FMA
(csrc/div_kernel.cu, ``variant="fma"``, kept to be timed beside it).

Port of ti_tpu/ops/div_kernel.py (the Pallas ``_make_kernel``, run by
``_div_kernel_run``). For a batch of chains, the 3N identity-basis tangent
lanes are cut into chunks of L lanes; for each (chain, chunk) the kernel
carries the lanes' tangents through every message and update layer,
recomputing the primal message MLPs per chunk, and writes only the final
node tangents. The math is ops/dense_divergence.py's. Around the call,
in plain PyTorch as in the JAX package: the primal per-layer states and
the lane geometry (``_primal_layer_states``), the packed MLP stacks
(``_pack_mlp_stacks``) and the readout tangent with its diagonal
(``readout_diag``).

Kernel inputs (``DivInputs``, f32, C chains, SL layers, P = N·N pair rows
p = i·N + j, LP = n_chunks·L lanes): s (C,SL,N,F); v (C,SL,3,N,F); e
(C,SL,P,F); pe, pe_prime (C,P,F); direc (C,P,4) [xyz, 0]; geom (C,LP,P,4)
[d_dist, d_direc xyz], zero on the padded lanes of the last chunk; node
(C,SL,14,N,F), the primal node quantities of each layer's update that the
tangent replays (``NODE_ROWS``). Output (C, n_chunks, L, 4, N, F): per lane
d_v (components 0-2) and d_s (3).

``div_kernel`` launches a kernel on a CUDA tensor and takes the plain
version only on a CPU tensor (under either variant); there is no fallback
between the routes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as Fn
from torch.func import jvp

from ti_torch.models.cpainn import state_of
from ti_torch.models.cpainn_dense import _cross, dense_edge_type_matrix, node_features
from ti_torch.models.embeddings import positional_encoding
from ti_torch.ops import _build
from ti_torch.ops.mlp_block import MLPWeights, _mlp_block, _mlp_block_jvp, mlp_weights
from ti_torch.ops.pair_layer_kernel import (
    KERNEL_F,
    KERNEL_MAX_N,
    TC_ROWS,
    _mlp_store,
    _pack_tf32_matrix,
    agg,
    check_width,
    tile_src,
)
from ti_torch.ops.pair_tangent_kernel import _mlp_tan

# rows of DivInputs.node per layer: chirality aggregate q, u(v1), v(v1),
# |v(v1)|, the update MLP's pre-LN h1 and h2, its g_u and scale_sq outputs
NODE_ROWS = ("q0", "q1", "q2", "uv0", "uv1", "uv2", "vv0", "vv1", "vv2", "vvn", "hu_h1",
             "hu_h2", "g_u", "scale_sq")
_LB, _R, _NW = 2, 32, 8  # lanes per sub-block, tile rows, warps (csrc/div_kernel.cu)
# B7's variants: the 3xTF32 tensor-core kernel, or the f32-FMA one
DIV_LIBS = {"tc": "div_kernel_tf32x3", "fma": "div_kernel"}


class MLPStacks(NamedTuple):
    """The MLP weights of every layer, stacked [phi, w, update-mlp] per
    layer (index 3·layer + k): w1 (3SL, 2F, F) zero-padded to 2F rows, w2
    (3SL, F, F), w3 (3SL, F, 5F) zero-padded to 5F columns, vecs (3SL, 6, F)
    = b1, ln1 scale, ln1 bias, b2, ln2 scale, ln2 bias, b3 (3SL, 1, 5F)
    zero-padded; u and v kernels (SL, F, F), (in, out)."""

    w1: torch.Tensor
    w2: torch.Tensor
    w3: torch.Tensor
    vecs: torch.Tensor
    b3: torch.Tensor
    uk: torch.Tensor
    vk: torch.Tensor

    def mlp(self, idx: int, f_in: int) -> MLPWeights:
        """The MLPWeights of stack entry ``idx`` with ``f_in`` input rows."""
        v = self.vecs[idx]
        return MLPWeights(w1=self.w1[idx, :f_in], b1=v[0], ln1_scale=v[1], ln1_bias=v[2],
                          w2=self.w2[idx], b2=v[3], ln2_scale=v[4], ln2_bias=v[5],
                          w3=self.w3[idx], b3=self.b3[idx, 0])


class DivInputs(NamedTuple):
    s: torch.Tensor
    v: torch.Tensor
    e: torch.Tensor
    pe: torch.Tensor
    pe_prime: torch.Tensor
    direc: torch.Tensor
    geom: torch.Tensor
    node: torch.Tensor


def _pad_to(a: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    pad = [0, 0] * a.dim()
    pad[2 * (a.dim() - 1 - dim) + 1] = size - a.shape[dim]
    return Fn.pad(a, pad)


def _pack_mlp_stacks(p, score_layers: int) -> MLPStacks:
    """Stack the phi/w/update MLP weights of a CPaiNN state dict into
    uniform padded arrays (zero padding is exact: padded inputs are zero,
    padded outputs are sliced away)."""
    w1s, w2s, w3s, vecs, b3s = [], [], [], [], []
    for layer in range(score_layers):
        for name in (f"message_{layer}.phi", f"message_{layer}.w", f"update_{layer}.mlp"):
            w = mlp_weights(p, name)
            f = w.w2.shape[0]
            w1s.append(_pad_to(w.w1, 2 * f, 0))
            w2s.append(w.w2)
            w3s.append(_pad_to(w.w3, 5 * f, 1))
            vecs.append(torch.stack([w.b1, w.ln1_scale, w.ln1_bias, w.b2, w.ln2_scale, w.ln2_bias]))
            b3s.append(_pad_to(w.b3[None], 5 * f, 1))
    uk = torch.stack([p[f"update_{l}.u.weight"].t() for l in range(score_layers)])
    vk = torch.stack([p[f"update_{l}.v.weight"].t() for l in range(score_layers)])
    return MLPStacks(*(t.detach().float().contiguous() for t in (
        torch.stack(w1s), torch.stack(w2s), torch.stack(w3s), torch.stack(vecs),
        torch.stack(b3s), uk, vk)))


def _primal_layer_states(model, p, xs, t, temps, atom_ids, etype):
    """Primal forward of C chains stashing the pre-layer (s, v, e) states,
    plus the lane-tangent geometry (the JAX function's keys and layouts,
    with a chain axis in front) and ``node``: per layer the primal node
    quantities of the update that the tangent replays (``NODE_ROWS``,
    (C, SL, 14, N, F))."""
    f = model.n_features
    c, n, _ = xs.shape
    dev, dt = xs.device, xs.dtype
    r = xs[:, None, :, :] - xs[:, :, None, :]  # r[b, i, j] = x[j] - x[i]
    eye = torch.eye(n, dtype=dt, device=dev)
    dist = torch.linalg.norm(r + eye[:, :, None], dim=-1) * (1.0 - eye)
    direc = r / (1.0 + dist[..., None])
    mask = (1.0 - eye)[..., None]
    pe = positional_encoding(dist, f, model.length_scale)
    pe_prime = jvp(lambda dd: positional_encoding(dd, f, model.length_scale),
                   (dist,), (torch.ones_like(dist),))[1]
    e = p["edge_embed.weight"][etype].expand(c, n, n, f)
    tb = torch.as_tensor(t, dtype=dt, device=dev).reshape(-1).expand(c)
    s = _mlp_block(node_features(model, p, tb, temps, atom_ids, n), mlp_weights(p, "combine"))
    v = torch.zeros((c, n, f, 3), dtype=dt, device=dev)

    s_l, v_l, e_l, node = [], [], [], []
    for layer in range(model.score_layers):
        mp, up = f"message_{layer}", f"update_{layer}"
        s_l.append(s)
        v_l.append(v)
        e_l.append(e)
        in_feats = torch.cat([s[:, None].expand(c, n, n, f), e], dim=-1)
        h = (_mlp_block(in_feats, mlp_weights(p, f"{mp}.phi"))
             * _mlp_block(pe, mlp_weights(p, f"{mp}.w"))) * mask
        gates, scale_dir, ds_, de_, cg = torch.split(h, f, dim=-1)
        q = torch.einsum("bijf,bijc->bifc", cg, direc)
        dv = (torch.einsum("bijf,bjfc->bifc", gates, v)
              + torch.einsum("bijf,bijc->bifc", scale_dir, direc) + _cross(q, v))
        s1, v1 = s + ds_.sum(2), v + dv
        e = e + de_
        uv = torch.einsum("bnfc,gf->bngc", v1, p[f"{up}.u.weight"])
        vv = torch.einsum("bnfc,gf->bngc", v1, p[f"{up}.v.weight"])
        w_up = mlp_weights(p, f"{up}.mlp")
        vvn = torch.linalg.norm(vv, dim=-1)
        g_u, scale_sq, add_inv = torch.split(_mlp_block(torch.cat([vvn, s1], -1), w_up), f, -1)
        # what the kernel's update tangent replays; |vv| with 1e-30 in the
        # sqrt as the TPU kernel takes it, so its tangent is finite at 0
        vvk = torch.sqrt((vv ** 2).sum(-1) + 1e-30)
        h1, h2, hu = _mlp_store(torch.cat([vvk, s1], -1), w_up, False)
        node.append(torch.stack([*q.unbind(-1), *uv.unbind(-1), *vv.unbind(-1), vvk, h1, h2,
                                 hu[..., :f], hu[..., f:2 * f]], dim=1))
        v = v1 + g_u[..., None] * uv
        s = s1 + vvn ** 2 * scale_sq + add_inv

    d = 3 * n
    lanes = torch.arange(d, device=dev)
    onehot_a = Fn.one_hot(lanes // 3, n).to(dt)
    onehot_c = Fn.one_hot(lanes % 3, 3).to(dt)
    d_r = (onehot_a[:, None, :, None] - onehot_a[:, :, None, None]) * onehot_c[:, None, None, :]
    d_dist = (r[:, None] * d_r).sum(-1) / (dist + eye)[:, None] * (1.0 - eye)  # (C, D, N, N)
    d_direc = (d_r / (1.0 + dist[:, None, ..., None])
               - r[:, None] * (d_dist / (1.0 + dist[:, None]) ** 2)[..., None])
    return dict(s_l=torch.stack(s_l, 1), v_l=torch.stack(v_l, 1), e_l=torch.stack(e_l, 1),
                s_fin=s, v_fin=v, pe=pe, pe_prime=pe_prime, direc=direc, d_dist=d_dist,
                d_direc=d_direc, node=torch.stack(node, 1))


def pack_inputs(st: dict, lanes_per_chunk: int) -> DivInputs:
    """The kernel's inputs from ``_primal_layer_states``: the pair tensors
    flat over p = i·N + j, v component-major, the lane geometry padded with
    zero lanes to a whole number of chunks."""
    c, sl, n, f = st["s_l"].shape
    d, nn = 3 * n, n * n
    lp = -(-d // lanes_per_chunk) * lanes_per_chunk
    geom = torch.cat([st["d_dist"][..., None], st["d_direc"]], -1).reshape(c, d, nn, 4)
    return DivInputs(
        s=st["s_l"].contiguous(),
        v=st["v_l"].permute(0, 1, 4, 2, 3).contiguous(),
        e=st["e_l"].reshape(c, sl, nn, f).contiguous(),
        pe=st["pe"].reshape(c, nn, f).contiguous(),
        pe_prime=st["pe_prime"].reshape(c, nn, f).contiguous(),
        direc=_pad_to(st["direc"].reshape(c, nn, 3), 4, 2).contiguous(),
        geom=_pad_to(geom, lp, 1).contiguous(),
        node=st["node"].contiguous(),
    )


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def div_kernel_plain(inp: DivInputs, stacks: MLPStacks, lanes_per_chunk: int) -> torch.Tensor:
    """The plain PyTorch version of kernel B7: for each chunk of L lanes,
    every layer's primal message MLPs recomputed, the lanes' tangents
    through the message and update blocks, lane-major, as the TPU kernel
    body does. Returns (C, n_chunks, L, 4, N, F)."""
    c, sl, n, f = inp.s.shape
    L = lanes_per_chunk
    n_chunks = inp.geom.shape[1] // L
    p_idx = torch.arange(n * n, device=inp.s.device)
    mask = (p_idx // n != p_idx % n).to(inp.s.dtype)[:, None]  # (P, 1)
    dirs = [inp.direc[:, None, :, k:k + 1] for k in range(3)]  # (C, 1, P, 1)
    out = []
    for kk in range(n_chunks):
        geo = inp.geom[:, kk * L:(kk + 1) * L]  # (C, L, P, 4)
        dd = geo[..., 0:1]
        ddir = [geo[..., 1 + k:2 + k] for k in range(3)]
        d_s = inp.s.new_zeros((c, L, n, f))
        d_v = inp.s.new_zeros((c, L, 3, n, f))
        d_e = None
        for layer in range(sl):
            s, v, e, nd = inp.s[:, layer], inp.v[:, layer], inp.e[:, layer], inp.node[:, layer]
            w_phi, w_w = stacks.mlp(3 * layer, 2 * f), stacks.mlp(3 * layer + 1, f)
            w_up = stacks.mlp(3 * layer + 2, 2 * f)

            # primal message MLPs, recomputed per chunk
            h1p, h2p, phi_out = _mlp_store(torch.cat([tile_src(s, n), e], -1), w_phi, False)
            h1w, h2w, w_out = _mlp_store(inp.pe, w_w, False)

            # tangent of h = phi(in)·w(pe), lanes on axis 1
            d_pe = inp.pe_prime[:, None] * dd
            d_h = phi_out[:, None] * _mlp_tan(d_pe, w_w, h1w[:, None], h2w[:, None], False)
            if layer > 0:
                d_in = torch.cat([tile_src(d_s, n), d_e], -1)
                d_phi = _mlp_tan(d_in, w_phi, h1p[:, None], h2p[:, None], False)
                d_h = d_h + d_phi * w_out[:, None]
            gates, scale_dir, _, _, cg = torch.split((phi_out * w_out * mask)[:, None], f, -1)
            d_gates, d_scale_dir, d_ds, d_de, d_cg = torch.split(d_h * mask, f, -1)
            d_e = d_de if layer == 0 else d_e + d_de

            # tangent aggregation; q is the primal chirality aggregate
            q = nd[:, None, 0:3]
            d_q = [agg(d_cg * dirs[k] + cg * ddir[k], n) for k in range(3)]
            new_d_v = []
            for k in range(3):
                k1, k2 = (k + 1) % 3, (k + 2) % 3
                a = agg(d_gates * tile_src(v[:, None, k], n) + gates * tile_src(d_v[:, :, k], n)
                        + d_scale_dir * dirs[k] + scale_dir * ddir[k], n)
                d_cross = (d_q[k1] * v[:, None, k2] + q[:, :, k1] * d_v[:, :, k2]
                           - d_q[k2] * v[:, None, k1] - q[:, :, k2] * d_v[:, :, k1])
                new_d_v.append(d_v[:, :, k] + a + d_cross)
            d_s = d_s + agg(d_ds, n)

            # update block, tangent at the stored primal
            uv, vv = nd[:, None, 3:6], nd[:, None, 6:9]
            vvn, g_u, scale_sq = nd[:, None, 9], nd[:, None, 12], nd[:, None, 13]
            d_vv = [new_d_v[k] @ stacks.vk[layer] for k in range(3)]
            d_vvn = (vv[:, :, 0] * d_vv[0] + vv[:, :, 1] * d_vv[1] + vv[:, :, 2] * d_vv[2]) / vvn
            d_hu = _mlp_tan(torch.cat([d_vvn, d_s], -1), w_up, nd[:, None, 10], nd[:, None, 11],
                            False)
            d_g_u, d_scale_sq, d_add_inv = torch.split(d_hu[..., :3 * f], f, -1)
            d_v = torch.stack([new_d_v[k] + d_g_u * uv[:, :, k]
                               + g_u * (new_d_v[k] @ stacks.uk[layer]) for k in range(3)], 2)
            d_s = d_s + 2.0 * vvn * d_vvn * scale_sq + vvn ** 2 * d_scale_sq + d_add_inv
        out.append(torch.cat([d_v, d_s[:, :, None]], 2))
    return torch.stack(out, 1)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


def smem_bytes() -> int:
    """Dynamic shared memory of one B7 CTA (csrc/div_kernel.cu): 12 tiles of
    32 x F f32, the warp-partial buffer, geometry and per-lane sums."""
    f = KERNEL_F
    return 4 * (12 * _R * f + _NW * 3 * f + 4 * _R + _LB * 4 * _R + _LB * 7 * f)


def _check_div_inputs(inp: DivInputs, stacks: MLPStacks, lanes_per_chunk: int):
    """Shape, dtype, device and contiguity checks of kernel B7; returns
    (C, N, SL, n_chunks)."""
    c, sl, n, f = inp.s.shape
    check_width(f, "kernel B7")
    if not 2 <= n <= KERNEL_MAX_N:
        raise ValueError(f"kernel B7 takes 2..{KERNEL_MAX_N} atoms, got {n}")
    L = lanes_per_chunk
    lp = inp.geom.shape[1]
    if L < 1 or lp % L:
        raise ValueError(f"lanes_per_chunk {L} must divide the padded lane count {lp}")
    nn = n * n
    want = {"s": (inp.s, (c, sl, n, f)), "v": (inp.v, (c, sl, 3, n, f)),
            "e": (inp.e, (c, sl, nn, f)), "pe": (inp.pe, (c, nn, f)),
            "pe_prime": (inp.pe_prime, (c, nn, f)), "direc": (inp.direc, (c, nn, 4)),
            "geom": (inp.geom, (c, lp, nn, 4)), "node": (inp.node, (c, sl, len(NODE_ROWS), n, f)),
            "w1": (stacks.w1, (3 * sl, 2 * f, f)), "w2": (stacks.w2, (3 * sl, f, f)),
            "w3": (stacks.w3, (3 * sl, f, 5 * f)), "vecs": (stacks.vecs, (3 * sl, 6, f)),
            "b3": (stacks.b3, (3 * sl, 1, 5 * f)), "uk": (stacks.uk, (sl, f, f)),
            "vk": (stacks.vk, (sl, f, f))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got {tuple(t.shape)} {t.dtype}")
        if t.device != inp.s.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {inp.s.device}")
    return c, n, sl, lp // L


def pack_tf32_stacks(stacks: MLPStacks) -> torch.Tensor:
    """Every layer's matrices split into TF32 hi and lo parts in fragment
    order, as csrc/div_kernel_tf32x3.cu reads them: (SL, 2·23F²), per layer
    phi's w1 (2F x F), w2, w3 (F x 5F), w's w1 (its first F rows: the rest is
    MLPStacks' zero padding), w2, w3 (the layout of ``pack_tf32_weights``),
    then the update MLP's w1 (2F x F), w2 and the first 3F columns of its w3
    (the others are never read), then U and V; each permuted by
    ``pair_layer_kernel._pack_tf32_matrix``. A pure function of the
    tensors; done once per ``divergence_kernel_batch`` call. Each kind of
    matrix is packed for all layers at once: the fragment order is
    k-step-major, so packing the layers' matrices stacked row-wise gives
    the layers' packings one after the other."""
    f, sl = stacks.w2.shape[-1], stacks.uk.shape[0]
    phi, w, up = slice(0, None, 3), slice(1, None, 3), slice(2, None, 3)
    mats = (stacks.w1[phi], stacks.w2[phi], stacks.w3[phi], stacks.w1[w, :f], stacks.w2[w],
            stacks.w3[w], stacks.w1[up], stacks.w2[up], stacks.w3[up, :, :3 * f], stacks.uk,
            stacks.vk)
    return torch.cat([_pack_tf32_matrix(m.reshape(-1, m.shape[-1])).reshape(sl, -1)
                      for m in mats], dim=1).contiguous()


def tc_smem_bytes() -> int:
    """Dynamic shared memory of one CTA of csrc/div_kernel_tf32x3.cu: the
    stacked [ds | de] tile (TC_ROWS x 2F f32), the a2 tangents of both MLPs
    (2 x TC_ROWS x F), five residual tiles of 32 x F, the source geometry
    (4 x 32), the tile rows' geometry tangents (4 x TC_ROWS), the four
    LayerNorms' statistics (8 x 32) and the rows' source atoms (TC_ROWS)."""
    f = KERNEL_F
    return 4 * (TC_ROWS * 2 * f + 2 * TC_ROWS * f + 5 * _R * f + 4 * _R + 4 * TC_ROWS + 8 * _R
                + TC_ROWS)


class DivTcPlan(NamedTuple):
    """How csrc/div_kernel_tf32x3.cu cuts a launch: a CTA takes ``chunks``
    (G) consecutive chunks of one chain, ``groups`` = ceil(n_chunks / G)
    CTAs a chain, ``ctas`` in all; per (layer, dst atom) it stacks its real
    lanes (those below 3N) ``lanes_per_tile`` to a TC_ROWS-row tile."""

    chunks: int
    groups: int
    ctas: int
    lanes_per_tile: int


def _group_tiles(n: int, lanes_per_chunk: int, n_chunks: int, chunks: int, group: int) -> int:
    """Lane tiles of one (layer, dst atom) for the CTA of chunk group ``group``."""
    lb = group * chunks * lanes_per_chunk
    real = min(chunks * lanes_per_chunk, n_chunks * lanes_per_chunk - lb, 3 * n - lb)
    return -(-real // (TC_ROWS // n))


def div_tc_plan(c: int, n: int, lanes_per_chunk: int, n_chunks: int, sms: int,
                chunks: Optional[int] = None) -> DivTcPlan:
    """The plan at ``chunks`` chunks a CTA, or, by default, the G that
    minimises waves x the longest CTA's work (one tile pass for the primal
    of each (layer, dst atom) plus one for each of its lane tiles): at 128
    chains, N = 19, L = 4 all 15 chunks of a chain, one CTA a chain."""
    def plan(g: int) -> DivTcPlan:
        groups = -(-n_chunks // g)
        return DivTcPlan(g, groups, groups * c, TC_ROWS // n)

    if chunks is not None:
        if not 1 <= chunks <= n_chunks:
            raise ValueError(f"chunks_per_cta must be 1..{n_chunks}, got {chunks}")
        return plan(chunks)

    def cost(g: int) -> int:
        p = plan(g)
        longest = max(_group_tiles(n, lanes_per_chunk, n_chunks, g, q) for q in range(p.groups))
        return -(-p.ctas // sms) * (1 + longest)

    return plan(min(range(1, n_chunks + 1), key=lambda g: (cost(g), -g)))


def _div_route(variant: str) -> str:
    """The library a B7 launch takes: ``"tc"`` the 3xTF32 tensor-core
    kernel, ``"fma"`` the f32-FMA kernel."""
    if variant not in DIV_LIBS:
        raise ValueError(f"variant must be one of {tuple(DIV_LIBS)}, got {variant!r}")
    return DIV_LIBS[variant]


def _launch_fma(inp, stacks, L, c, n, sl, n_chunks, out, nodes, d_e):
    lib = _build.load("div_kernel")
    fn = lib.div_kernel_f32
    fn.argtypes = [_P] * 18 + [ctypes.c_int] * 5 + [_P]
    fn.restype = ctypes.c_int
    rc = fn(*(t.data_ptr() for t in (*inp, *stacks, out, nodes, d_e)),
            c, n, sl, L, n_chunks, torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(lib, rc, "div_kernel launch")


def _launch_tc(inp, stacks, L, c, n, sl, n_chunks, out, nodes, d_e, tf32, chunks):
    dev, f = out.device, KERNEL_F
    if tf32 is None:
        tf32 = pack_tf32_stacks(stacks)
    want = (sl, 2 * 23 * f * f)
    if tuple(tf32.shape) != want or tf32.dtype != torch.float32 or tf32.device != dev \
            or not tf32.is_contiguous():
        raise ValueError(f"the 3xTF32 stacks must be {want} float32, contiguous on {dev} "
                         f"(pack_tf32_stacks), got {tuple(tf32.shape)} {tf32.dtype} on {tf32.device}")
    plan = div_tc_plan(c, n, L, n_chunks, torch.cuda.get_device_properties(dev).multi_processor_count,
                       chunks)
    scratch = torch.empty(plan.ctas * 10 * n * f, device=dev, dtype=torch.float32)
    lib = _build.load("div_kernel_tf32x3")
    fn = lib.div_kernel_tf32x3
    fn.argtypes = [_P] * 15 + [ctypes.c_int] * 6 + [_P]
    fn.restype = ctypes.c_int
    rc = fn(*(t.data_ptr() for t in (*inp, tf32, stacks.vecs, stacks.b3, out, nodes, d_e, scratch)),
            c, n, sl, L, n_chunks, plan.chunks, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "div_kernel_tf32x3 launch")


def div_kernel(inp: DivInputs, stacks: MLPStacks, lanes_per_chunk: int, variant: str = "tc",
               tf32: Optional[torch.Tensor] = None,
               chunks_per_cta: Optional[int] = None) -> torch.Tensor:
    """The final-layer node tangents of every lane, (C, n_chunks, L, 4, N, F).
    Launches kernel B7 on a CUDA tensor, the plain version on a CPU tensor
    (under either variant). ``variant="tc"`` takes the 3xTF32 tensor-core
    kernel (csrc/div_kernel_tf32x3.cu) over ``tf32``, the packing
    ``pack_tf32_stacks(stacks)`` (made here when not given), with
    ``chunks_per_cta`` chunks of a chain a CTA (``div_tc_plan``'s choice by
    default); it takes the lanes from 3N on as the zero padding
    ``pack_inputs`` adds. ``variant="fma"`` takes the f32-FMA kernel
    (csrc/div_kernel.cu), kept for timing."""
    lib = _div_route(variant)
    if inp.s.device.type == "cpu":
        return div_kernel_plain(inp, stacks, lanes_per_chunk)
    if inp.s.device.type != "cuda":
        raise ValueError(f"div_kernel runs on cuda or cpu, not {inp.s.device}")
    c, n, sl, n_chunks = _check_div_inputs(inp, stacks, lanes_per_chunk)
    L, f, dev = lanes_per_chunk, KERNEL_F, inp.s.device
    out = torch.empty((c, n_chunks, L, 4, n, f), device=dev, dtype=torch.float32)
    nodes = torch.empty_like(out)  # the other half of the node-tangent ping-pong
    d_e = torch.empty((c, n_chunks, L, n * n, f), device=dev, dtype=torch.float32)
    if variant == "tc":
        _launch_tc(inp, stacks, L, c, n, sl, n_chunks, out, nodes, d_e, tf32, chunks_per_cta)
    else:
        _launch_fma(inp, stacks, L, c, n, sl, n_chunks, out, nodes, d_e)
    _build.count_launch("div_kernel", lib)
    return out


# ---------------------------------------------------------------------------
# readout and entry point
# ---------------------------------------------------------------------------

def readout_diag(p, s_fin, v_fin, out) -> torch.Tensor:
    """(C,) divergences: the readout tangent of each lane's final node
    tangents, contracted on the lane's own (atom, coordinate)."""
    c, n, _ = s_fin.shape
    d = 3 * n
    lanes = out.reshape(c, -1, 4, n, s_fin.shape[-1])[:, :d]
    d_v, d_s = lanes[:, :, :3], lanes[:, :, 3]
    w_ro = mlp_weights(p, "readout.mlp")
    hr = _mlp_block(s_fin, w_ro)  # (C, N, 2)
    v_kern = p["readout.V.weight"][0]  # (F,)
    v_out = torch.einsum("bnfc,f->bnc", v_fin, v_kern)  # (C, N, 3)
    d_hr = _mlp_block_jvp(s_fin, d_s.transpose(0, 1), w_ro)[1].transpose(0, 1)  # (C, D, N, 2)
    d_v_out = torch.einsum("bdcnf,f->bdnc", d_v, v_kern)  # (C, D, N, 3)
    d_vel = d_hr[..., 1:2] * v_out[:, None] + hr[:, None, :, 1:2] * d_v_out
    idx = torch.arange(d, device=s_fin.device)
    return d_vel[:, idx, idx // 3, idx % 3].sum(-1)


def divergence_kernel_batch(model, params, xs, t, temps, template, lanes_per_chunk: int = 4,
                            device=None) -> torch.Tensor:
    """Exact divergence of the velocity field for a batch of chains,
    xs (C, N, 3) at time t with temps (C, K), through kernel B7: (C,).

    ``lanes_per_chunk`` is L, the lanes one CTA carries through the whole
    network. 4 by default, as in the JAX package: each chunk recomputes the
    primal message MLPs, so the extra work falls as 1/L, while the pair
    tangent scratch of all C·ceil(3N/L)·L lanes stays about the same.
    ``params`` None takes the module's own weights. Runs on ``cuda``
    unless ``device`` says otherwise (``cpu`` runs the plain version)."""
    from ti_torch import resolve_device

    if getattr(model, "cutoff", None) is not None:
        raise NotImplementedError(
            "divergence_kernel_batch computes the complete graph only (cutoff=None)")
    dev = resolve_device(device)
    with torch.no_grad():
        p = {k: w.detach().to(dev) for k, w in state_of(model, params).items()}
        xs = torch.as_tensor(xs, dtype=torch.float32, device=dev)
        temps = torch.as_tensor(temps, dtype=torch.float32, device=dev)
        etype = torch.as_tensor(dense_edge_type_matrix(template.edges), device=dev).long()
        atom_ids = torch.as_tensor(template.atom_ids, device=dev)
        st = _primal_layer_states(model, p, xs, t, temps, atom_ids, etype)
        stacks = _pack_mlp_stacks(p, model.score_layers)
        tf32 = None if dev.type == "cpu" else pack_tf32_stacks(stacks)
        out = div_kernel(pack_inputs(st, lanes_per_chunk), stacks, lanes_per_chunk, tf32=tf32)
        return readout_diag(p, st["s_fin"], st["v_fin"], out)
