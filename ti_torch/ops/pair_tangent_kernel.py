"""The message layer with K forward-mode probe lanes — kernel B3,
hand-written CUDA, with its plain PyTorch version beside it. Both types run
on the tensor cores, over the layer's matrices packed once by ``prepare``:
bf16_agg in csrc/pair_tangent_mma.cu (``mma.sync`` bf16, the fragment order
of ``pair_layer_kernel.pack_mma_weights``), f32 in
csrc/pair_tangent_tf32x3.cu (``mma.sync`` in 3xTF32, the split of
``pair_layer_kernel.pack_tf32_weights``, lanes stacked into 64-row tiles).
csrc/pair_tangent.cu keeps the f32-FMA kernel, reachable as
``variant="fma"`` to be timed beside the f32 one.

Port of ti_tpu/ops/pair_tangent_kernel.py (the Pallas
``_pair_tangent_kernel``). Per chain the layer computes kernel B1's primal
(ops/pair_layer_kernel.py) and, for each of K tangent lanes, its JVP under
the lane's tangents of (x, s, v, e): dr → ddist → ddir and dPE, the MLP
tangent chains replayed from the primal's residuals, the product rule,
the aggregations and the chirality term. The divergence node contracts
Σ_k w_k z_kᵀ(J z_k) (``pair_tangent_div_fn``); the orthogonal frame at
K = 3N is the exact trace.

Tangent layouts (kernel and plain version): dx (B, K, N, 3) f32;
ds (B, K, N, F); dv (B, K, 3, N, F); de (B, K, N·N, F); outputs per lane
dv (B, K, 3, N, F) f32, ds (B, K, N, F) f32, de (B, K, N·N, F). The primal
outputs are B1's. The node update and readout stay plain lane-batched
PyTorch, as in the JAX package.

``pair_tangent`` launches the kernel on a CUDA tensor and takes the plain
version only on a CPU tensor; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ti_torch.ops import _build
from ti_torch.ops.divergence import _probe_block, hutchinson_var_estimate
from ti_torch.ops.mlp_block import BF16, _mlp_block_jvp, dot_bf16_agg, mlp_weights
from ti_torch.ops.pair_layer_kernel import (
    _NGEO,
    _NW,
    _R,
    KERNEL_F,
    SMEM_LIMIT,
    TC_ROWS,
    PairLayerWeights,
    _check_pair_inputs,
    _packed,
    agg,
    embed,
    pe_scale,
    prepare,
    primal_plain,
    tile_src,
)


VARIANTS = ("mma", "fma")  # the tensor-core kernel of the weights' type, or the f32-FMA one
_TC_GEO = 14  # geometry rows of csrc/pair_tangent_tf32x3.cu: 10 of the atoms, 4 of a tile


def smem_bytes(bf16: bool, lane_block: int) -> int:
    """Dynamic shared memory of one CTA of the lane-block kernels:
    csrc/pair_tangent_mma.cu for bf16_agg, csrc/pair_tangent.cu (f32,
    ``variant="fma"``) for f32."""
    f, L = KERNEL_F, lane_block
    if bf16:
        # 7 residual tiles and the primal gates, the stacked work buffer, 2L a2-tangent
        # tiles; per-lane sums, geometry, lane geometry (4 lanes), primal sums, LayerNorm
        # statistics and vectors
        return (2 * (8 + max(2 * L, L + 4) + 2 * L) * _R * f
                + 4 * (4 * 7 * f + _NGEO * _R + 4 * 4 * _R + 7 * f + 8 * _R + 8 * f))
    return (4 * (9 + 3 * L) * _R * f
            + 4 * (_NW * 3 * f + _NGEO * _R + 4 * L * _R + 7 * f + 7 * f * L))


def tf32_smem_bytes() -> int:
    """Dynamic shared memory of one CTA of csrc/pair_tangent_tf32x3.cu, for
    any N: the stacked input (TC_ROWS x 2F f32), the a2 tangents of both
    MLPs (2 x TC_ROWS x F), five residual tiles of 32 rows (h1, h2 of both
    MLPs, dPE/ddist), the geometry, the LayerNorm statistics, the primal's
    chirality sums and the row map."""
    f = KERNEL_F
    return 4 * (4 * TC_ROWS * f + 5 * _R * f + _TC_GEO * TC_ROWS + 8 * _R + 3 * f + TC_ROWS)


class LaneTilePlan(NamedTuple):
    """How csrc/pair_tangent_tf32x3.cu stacks the K lanes of one (chain,
    dst atom): ``lanes`` whole lanes a TC_ROWS-row tile (stacked row l·N + j
    is source atom j of the tile's lane l), ``tiles`` tiles, the last with
    ``last`` lanes."""

    lanes: int
    tiles: int
    last: int


def lane_tile_plan(n: int, k_lanes: int) -> LaneTilePlan:
    lanes = TC_ROWS // n
    tiles = -(-k_lanes // lanes)
    return LaneTilePlan(lanes, tiles, k_lanes - (tiles - 1) * lanes)


def _pick_lane_block(k_lanes: int, bf16: bool) -> int:
    """Lanes replayed together per primal recompute: 4 (or 2) in bf16,
    where their buffers fit one CTA's shared memory, 1 in f32."""
    if not bf16:
        return 1
    for cand in (4, 2):
        if k_lanes % cand == 0:
            return cand
    return 1


def _ln_silu_tan(hp, dh, scale, bias):
    """Tangent of LN -> SiLU at the stored pre-LN primal hp, f32 statistics,
    output in hp's dtype."""
    h32 = hp.float()
    dh32 = dh.float()
    mu = h32.mean(-1, keepdim=True)
    cen = h32 - mu
    var = (cen ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + 1e-5)
    dmu = dh32.mean(-1, keepdim=True)
    dvar = 2.0 * (cen * dh32).mean(-1, keepdim=True)
    drstd = -0.5 * rstd * rstd * rstd * dvar
    dl = ((dh32 - dmu) * rstd + cen * drstd) * scale
    l = cen * rstd * scale + bias
    sig = torch.sigmoid(l)
    return (sig * (1.0 + l * (1.0 - sig)) * dl).to(hp.dtype)


def _mlp_tan(dx, w, h1, h2, bf16: bool):
    """Lane-batched MLP tangent replayed at the primal's pre-LN h1, h2."""
    dot = dot_bf16_agg if bf16 else torch.matmul
    da1 = _ln_silu_tan(h1, dot(dx, w.w1), w.ln1_scale, w.ln1_bias)
    da2 = _ln_silu_tan(h2, dot(da1, w.w2), w.ln2_scale, w.ln2_bias)
    return dot(da2, w.w3)


def pair_tangent_plain(x, s, v, e, dx, ds, dv, de, wts: PairLayerWeights,
                       length_scale: float, lane_block: Optional[int] = None):
    """The plain PyTorch version of kernel B3 (same layouts and precision):
    (dv, ds, e_out, dv lanes, ds lanes, de lanes). Lanes are processed
    ``lane_block`` at a time to bound memory."""
    b, n, _ = x.shape
    f = s.shape[-1]
    k_lanes = dx.shape[1]
    L = lane_block or k_lanes
    bf16 = wts.bf16
    wd = s.dtype
    primal, res = primal_plain(x, s, v, e, wts, length_scale)
    r, inv, sid, maskw = res["r"][:, None], res["inv"][:, None], res["sid"][:, None], res["mask"]
    outp, outw = res["outp"][:, None], res["outw"][:, None]
    gates, scale_dir, cg = (res[k][:, None] for k in ("gates", "scale_dir", "cg"))
    t0, t1, t2 = (t[:, None] for t in res["t_cg"])
    vx, vy, vz = (v[:, None, c] for c in range(3))
    h1p, h2p, h1w, h2w = (res[k][:, None] for k in ("h1p", "h2p", "h1w", "h2w"))
    dvt, dst, et = [], [], []
    for k0 in range(0, k_lanes, L):
        lanes = slice(k0, k0 + L)
        dxl = dx[:, lanes]
        dr = (dxl[:, :, None, :, :] - dxl[:, :, :, None, :]).reshape(b, -1, n * n, 3)
        ddist = (r[..., 0:1] * dr[..., 0:1] + r[..., 1:2] * dr[..., 1:2]
                 + r[..., 2:3] * dr[..., 2:3]) * sid
        dinv = -(inv * inv) * ddist
        del_ = de[:, lanes]
        din = torch.cat([tile_src(ds[:, lanes], n), del_], dim=-1)
        dpe = res["pefac"][:, None] * ddist.to(wd)
        dp = _mlp_tan(din, wts.phi, h1p, h2p, bf16)
        dq = _mlp_tan(dpe, wts.w, h1w, h2w, bf16)
        dh = (dp * outw + outp * dq) * maskw
        dgates, dscale_dir, dds, dde, dcg = torch.split(dh, f, dim=-1)
        dout, dt_cg = [], []
        for c in range(3):
            dir_c = res["dirs"][c][:, None]
            ddir_c = (dr[..., c:c + 1] * inv + r[..., c:c + 1] * dinv).to(wd)
            vc_src = tile_src(v[:, None, c], n)
            dvc_src = tile_src(dv[:, lanes, c], n)
            dout.append(agg(dgates * vc_src + gates * dvc_src
                            + dscale_dir * dir_c + scale_dir * ddir_c, n))
            dt_cg.append(agg(dcg * dir_c + cg * ddir_c, n))
        dvx, dvy, dvz = (dv[:, lanes, c] for c in range(3))
        dcx = dt_cg[1] * vz + t1 * dvz - dt_cg[2] * vy - t2 * dvy
        dcy = dt_cg[2] * vx + t2 * dvx - dt_cg[0] * vz - t0 * dvz
        dcz = dt_cg[0] * vy + t0 * dvy - dt_cg[1] * vx - t1 * dvx
        dvt.append(torch.stack([dout[0] + dcx, dout[1] + dcy, dout[2] + dcz], dim=2))
        dst.append(agg(dds, n))
        et.append(del_ + dde)
    return (*primal, torch.cat(dvt, 1), torch.cat(dst, 1), torch.cat(et, 1))


_P = ctypes.c_void_p


def _route(bf16: bool, variant: str) -> str:
    """The library a launch takes: the tensor-core kernel of the weights'
    type ("pair_tangent_mma" for bf16_agg, "pair_tangent_tf32x3" for f32),
    or for ``variant="fma"`` the f32-FMA kernel ("pair_tangent", f32 only)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if variant == "fma":
        if bf16:
            raise ValueError("variant='fma' is the f32-FMA kernel and takes f32 weights; "
                             "bf16_agg runs on the tensor cores (variant='mma')")
        return "pair_tangent"
    return "pair_tangent_mma" if bf16 else "pair_tangent_tf32x3"


def _kernel_weights(lib: str, wts: PairLayerWeights, x) -> torch.Tensor:
    """The matrices library ``lib`` reads: the packing ``prepare`` attached
    (3xTF32 hi/lo pairs for pair_tangent_tf32x3, the bf16 fragment order for
    pair_tangent_mma), checked; the row-major ones for pair_tangent."""
    if lib == "pair_tangent_tf32x3":
        return _packed(wts, x, 2 * wts.mats.numel(), torch.float32, "3xTF32", "with_tf32_weights")
    if lib == "pair_tangent_mma":
        return _packed(wts, x, wts.mats.numel(), BF16, "fragment-order", "with_mma_weights")
    return wts.mats


def _check_lane_block(bf16: bool, k_lanes: int, L: int) -> None:
    """Raise on a lane block a lane-block kernel cannot launch with."""
    if k_lanes < 1 or L < 1 or k_lanes % L:
        raise ValueError(f"lane_block {L} must divide the lane count {k_lanes}")
    if bf16 and L not in (1, 2, 4):
        raise ValueError(f"the tensor-core kernel takes lane_block 1, 2 or 4, got {L}")
    need = smem_bytes(bf16, L)
    if need > SMEM_LIMIT:
        raise ValueError(f"lane_block {L} needs {need} bytes of shared memory per CTA; "
                         f"the card has {SMEM_LIMIT}")


def pair_tangent(x, s, v, e, dx, ds, dv, de, wts: PairLayerWeights,
                 length_scale: float, lane_block: Optional[int] = None, variant: str = "mma"):
    """Primal and K-lane JVP of one message layer. Launches kernel B3 on a
    CUDA tensor, the plain version on a CPU tensor. ``variant="mma"`` takes
    the tensor-core kernel of the weights' type: bf16_agg in
    csrc/pair_tangent_mma.cu (which needs ``with_mma_weights``), f32 in
    csrc/pair_tangent_tf32x3.cu (which needs ``with_tf32_weights``, and
    stacks the lanes it is given into 64-row tiles of 64 // N whole lanes:
    it ignores ``lane_block``). ``variant="fma"`` takes the f32-FMA kernel
    (f32 weights only; bf16 raises), kept for timing. ``lane_block`` is the
    lanes a block of the plain version and of the lane-block kernels."""
    lib = _route(wts.bf16, variant)
    if x.device.type == "cpu":
        return pair_tangent_plain(x, s, v, e, dx, ds, dv, de, wts, length_scale, lane_block)
    if x.device.type != "cuda":
        raise ValueError(f"pair_tangent runs on cuda or cpu, not {x.device}")
    b, n, f, wd = _check_pair_inputs(x, s, v, e, wts, lib)
    k_lanes = dx.shape[1] if dx.dim() == 4 else -1
    want = {"dx": (dx, (b, k_lanes, n, 3), torch.float32),
            "ds": (ds, (b, k_lanes, n, f), wd),
            "dv": (dv, (b, k_lanes, 3, n, f), wd),
            "de": (de, (b, k_lanes, n * n, f), wd)}
    for name, (t, shape, dt) in want.items():
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name} must be {shape} {dt}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if k_lanes < 1:
        raise ValueError(f"pair_tangent needs at least one lane, got {k_lanes}")
    args = ()
    if lib != "pair_tangent_tf32x3":
        L = lane_block or _pick_lane_block(k_lanes, wts.bf16)
        _check_lane_block(wts.bf16, k_lanes, L)
        args = (L,)
    mats = _kernel_weights(lib, wts, x)
    handle = _build.load(lib)
    fn = getattr(handle, "pair_tangent_f32" if lib == "pair_tangent" else
                 "pair_tangent_bf16" if lib == "pair_tangent_mma" else lib)
    scratch = lib != "pair_tangent"
    fn.argtypes = ([_P] * (17 if scratch else 16) + [ctypes.c_int] * (3 + len(args))
                   + [ctypes.c_float, _P])
    fn.restype = ctypes.c_int
    dev = x.device
    dvp = torch.empty((b, 3, n, f), device=dev, dtype=torch.float32)
    dsp = torch.empty((b, n, f), device=dev, dtype=torch.float32)
    ep = torch.empty_like(e)
    dvt = torch.empty((b, k_lanes, 3, n, f), device=dev, dtype=torch.float32)
    dst = torch.empty((b, k_lanes, n, f), device=dev, dtype=torch.float32)
    et = torch.empty_like(de)
    bufs = [x, s, v, e, dx, ds, dv, de, mats, wts.vecs, dvp, dsp, ep, dvt, dst, et]
    if lib == "pair_tangent_mma":  # each CTA's primal 5F products, kept in L2 between its lane blocks
        bufs.append(torch.empty((b * n, 5 * 2 * _R * f), device=dev, dtype=BF16))
    elif scratch:  # each CTA's primal p, q of its N source atoms, read back by every lane tile
        bufs.append(torch.empty((b * n, 5 * 2 * n * f), device=dev, dtype=torch.float32))
    rc = fn(*(t.data_ptr() for t in bufs), b, n, k_lanes, *args, pe_scale(length_scale),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(handle, rc, f"{lib} launch")
    _build.count_launch("pair_tangent", lib)
    return dvp, dsp, ep, dvt, dst, et


def apply_dense_pair_tangent(pm, x, t, temps, z, *, lane_block: Optional[int] = None,
                             kernel: bool = True):
    """(velocity (B,N,3), K-lane JVP (B,K,N,3)) under tangent probes
    z (B,K,N,3): the message layers in kernel B3 (``kernel=False``: its
    plain version), the node update and readout as a plain lane-batched
    hand JVP in f32. ``pm`` from ``pair_layer_kernel.prepare``; in bf16_agg
    on the card its layers carry ``with_mma_weights``."""
    model, p = pm.model, pm.p
    b, n, _ = x.shape
    f = model.n_features
    k_lanes = z.shape[1]
    wd = BF16 if pm.bf16 else torch.float32
    L = lane_block or _pick_lane_block(k_lanes, pm.bf16)
    layer_fn = pair_tangent if kernel else pair_tangent_plain
    dev = x.device

    x = x.contiguous()
    s, e = embed(pm, t, temps, n)
    v = torch.zeros((b, 3, n, f), dtype=wd, device=dev)
    dx = z.to(torch.float32).contiguous()
    ds_t = torch.zeros((b, k_lanes, n, f), dtype=wd, device=dev)
    dv_t = torch.zeros((b, k_lanes, 3, n, f), dtype=wd, device=dev)
    de_t = torch.zeros((b, k_lanes, n * n, f), dtype=wd, device=dev)

    for layer in range(model.score_layers):
        dv_p, ds_p, e, dv_all, ds_all, de_t = layer_fn(
            x, s, v, e, dx, ds_t, dv_t, de_t, pm.layers[layer], model.length_scale, L)
        s = (s + ds_p.to(wd)).to(wd)
        v = (v + dv_p.to(wd)).to(wd)
        ds_t = ds_t + ds_all.to(wd)
        dv_t = dv_t + dv_all.to(wd)

        # node update: lane-broadcast hand JVP, O(N·F) rows, f32
        up = f"update_{layer}"
        v3 = v.permute(0, 2, 3, 1).float()          # (B, N, F, 3)
        dv3 = dv_t.permute(0, 1, 3, 4, 2).float()   # (B, K, N, F, 3)
        u_k = p[f"{up}.u.weight"].t()
        v_k = p[f"{up}.v.weight"].t()
        uv = torch.einsum("bnfc,fg->bngc", v3, u_k)
        vv = torch.einsum("bnfc,fg->bngc", v3, v_k)
        duv = torch.einsum("bknfc,fg->bkngc", dv3, u_k)
        dvv = torch.einsum("bknfc,fg->bkngc", dv3, v_k)
        vv_norm = torch.linalg.norm(vv, dim=-1)
        safe = torch.where(vv_norm > 0, 1.0 / torch.clamp(vv_norm, min=1e-30),
                           torch.zeros_like(vv_norm))
        dnorm = (vv[:, None] * dvv).sum(-1) * safe[:, None]
        s32, ds32 = s.float(), ds_t.float()
        hu, dhu = _mlp_block_jvp(torch.cat([vv_norm, s32], -1)[:, None],
                                 torch.cat([dnorm, ds32], -1), mlp_weights(p, f"{up}.mlp"))
        g_u, scale_sq, add_inv = torch.split(hu[:, 0], f, dim=-1)
        dg_u, dscale_sq, dadd_inv = torch.split(dhu, f, dim=-1)
        v3n = v3 + g_u[..., None] * uv
        dv3 = dv3 + dg_u[..., None] * uv[:, None] + g_u[:, None, ..., None] * duv
        s_new = s32 + vv_norm ** 2 * scale_sq + add_inv
        ds_new = (ds32 + 2.0 * vv_norm[:, None] * dnorm * scale_sq[:, None]
                  + (vv_norm ** 2)[:, None] * dscale_sq + dadd_inv)
        s = s_new.to(wd)
        ds_t = ds_new.to(wd)
        v = v3n.permute(0, 3, 1, 2).to(wd).contiguous()
        dv_t = dv3.permute(0, 1, 4, 2, 3).to(wd).contiguous()

    # readout: lane-broadcast hand JVP
    v3 = v.permute(0, 2, 3, 1).float()
    dv3 = dv_t.permute(0, 1, 3, 4, 2).float()
    hr, dhr = _mlp_block_jvp(s.float()[:, None], ds_t.float(), mlp_weights(p, "readout.mlp"))
    hr = hr[:, 0]
    v_kern = p["readout.V.weight"].t()
    v_out = torch.einsum("bnfc,fg->bngc", v3, v_kern)[:, :, 0, :]
    dv_out = torch.einsum("bknfc,fg->bkngc", dv3, v_kern)[:, :, :, 0, :]
    vel = hr[..., 1:2] * v_out
    dvel = dhr[..., 1:2] * v_out[:, None] + hr[:, None, :, 1:2] * dv_out
    return vel.to(x.dtype), dvel.to(x.dtype)


def pair_tangent_div_fn(model, params, template, *, num_probes: int = 16,
                        probe_mode: str = "orthogonal", compute_dtype=None,
                        lane_block: Optional[int] = None, return_var: bool = False,
                        device=None, kernel: bool = True):
    """Batched divergence-node estimator for ``make_ode_sampler(div_drift=)``.

    Returns ``div_fn(xs (B,N,3), t, temps (B,·), generator) -> (B,)`` — or
    ``(div, plug-in variance)`` with ``return_var`` — drawing each chain's
    probe block from ``generator`` (rademacher 1/K weights or the Haar
    orthogonal frame at d/K, exact at K = 3N) and contracting the K-lane
    JVP of kernel B3. Packs the weights once, here. Runs on ``cuda`` unless
    ``device`` says otherwise; ``kernel=False`` builds it from the plain
    version."""
    from ti_torch import resolve_device

    dev = resolve_device(device)
    pm = prepare(model, params, template, compute_dtype, dev)  # packs bf16_agg layers for B3 too
    n = template.n_atoms
    d = 3 * n

    def div_fn(xs, t, temps, generator):
        b = xs.shape[0]
        z, w = _probe_block(generator, num_probes, d, probe_mode, shape=(b,))
        zt = z.reshape(b, num_probes, n, 3)
        tb = torch.as_tensor(t, dtype=xs.dtype, device=xs.device).expand(b)
        _, dvel = apply_dense_pair_tangent(pm, xs, tb, temps, zt, lane_block=lane_block,
                                           kernel=kernel)
        est = (zt * dvel).sum((2, 3))  # (B, K)
        div = (w * est).sum(1)
        if return_var:
            return div, hutchinson_var_estimate(est, w, d, probe_mode)
        return div

    return div_fn
