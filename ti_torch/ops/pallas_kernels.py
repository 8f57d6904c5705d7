"""The fused MLP kernels — B4 (``fused_edge_mlp``), B5
(``fused_edge_mlp_jvp``) and B6 (``fused_mlp``), hand-written CUDA
(csrc/fused_edge_mlp_tf32x3.cu, csrc/fused_edge_mlp_jvp_tf32x3.cu and
csrc/fused_mlp_tf32x3.cu, B4, B5 and B6 on the tensor cores in 3xTF32, with
csrc/fused_edge_mlp.cu, csrc/fused_edge_mlp_jvp.cu and csrc/fused_mlp.cu,
their f32-FMA kernels, as ``variant="fma"``) — with their plain PyTorch
versions beside them. The three tensor-core sources are built at F = 128
and, as ``fused_edge_mlp_tf32x3_f256``, ``fused_edge_mlp_jvp_tf32x3_f256``
and ``fused_mlp_tf32x3_f256``, at F = 256 (the 10506 model's width): each
wrapper reads F from its inputs and takes the library of that width
(``pair_layer_kernel.width_library``); F = 256 cuts B4's and B5's row
tiles to 32 rows. Every other width, and ``variant="fma"`` at any width
but 128, raises ``WidthRefusal`` on the card.

Port of ti_tpu/ops/pallas_kernels.py (named after it). B4 computes
phi(in) · w(pe) per row, both MLPs Dense-LN-SiLU ×2 → Dense 5F, keeping
every intermediate on chip; B5 its tangent under K lanes of input
tangents, recomputing the primal; B6 one such MLP over row tiles. They
serve ``apply_dense(fused=True)`` (B4 and B5, through
``fused_edge_mlp_diff``) and ``cpainn_fused.apply_fused`` (B4 and B6).
All three are f32, as the JAX fused path is.

``fused_edge_mlp_diff`` is the counterpart of the JAX ``custom_jvp``: an
``autograd.Function`` whose forward is B4 and whose ``jvp`` is B5. The
``jvp`` reaches B5 through a ``torch.library`` custom op whose vmap rule
folds the vmapped lane dimension into B5's K, so the exact divergence's
``vmap(jvp)`` launches B5 once per layer, not once per lane (a ``ctypes``
launch cannot take a vmapped tensor). Tangents on the weights go through
the plain version's own JVP; reverse mode raises.

Every wrapper launches its kernel on a CUDA tensor and takes the plain
version only on a CPU tensor; there is no fallback between the two.
``PLAIN_CALLS`` counts the plain versions' calls on that route. B4 and B5
on the tensor cores read the layer's matrices as ``pack_tf32_weights``
splits them (``with_tf32_weights``, done once per layer by
``cpainn_dense.pack_message_layers`` and ``cpainn_fused.pack_fused``);
that packing rides along as one more tensor through
``fused_edge_mlp_diff`` and its custom op. B6 on the tensor cores reads
``MLPPack.tc``, the same split of one MLP's matrices that ``pack_mlp``
attaches once.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as tnf

from ti_torch.ops import _build
from ti_torch.ops.mlp_block import MLPWeights, _mlp_block, _mlp_block_jvp
from ti_torch.ops.pair_layer_kernel import (
    _R,
    KERNEL_F,
    LIB_WIDTHS,
    SMEM_LIMIT,
    TC_ROWS,
    TC_WIDTHS_ROUTE,
    PairLayerWeights,
    WidthRefusal,
    _pack_tf32_matrix,
    _packed,
    check_width,
    unpack_pair_mlps,
    width_library,
)

PLAIN_CALLS = {"fused_edge_mlp": 0, "fused_edge_mlp_jvp": 0, "fused_mlp": 0}
_P = ctypes.c_void_p
# B4's and B5's variants: the 3xTF32 tensor-core kernel, or the f32-FMA one
EDGE_LIBS = {"tc": "fused_edge_mlp_tf32x3", "fma": "fused_edge_mlp"}
JVP_LIBS = {"tc": "fused_edge_mlp_jvp_tf32x3", "fma": "fused_edge_mlp_jvp"}
EDGE_CTAS_PER_SM = 2  # CTAs of csrc/fused_edge_mlp_tf32x3.cu an SM holds at once
# B6's variants: the 3xTF32 tensor-core kernel, or the f32-FMA one
MLP_LIBS = {"tc": "fused_mlp_tf32x3", "fma": "fused_mlp"}
MLP_ROWS = 16        # rows of a CTA of csrc/fused_mlp_tf32x3.cu (TM)
# input columns it stages a chunk (two chunks in flight): F, so that a chunk
# buffer holds a hidden activation; F = 128's here
MLP_CHUNK = KERNEL_F
MLP_CTAS_PER_SM = 2  # its CTAs an SM holds at once at F = 128 (mlp_ctas_per_sm)
MLP_K_STEP = 16      # W1's rows are padded to a multiple of this (two 8-row k-steps)
MLP_N_TILE = 8       # W3's columns are padded to a multiple of this (one n-tile)


class MLPPack(NamedTuple):
    """One MLP packed once for kernel B6. ``mats`` is flat f32: w1
    (f_in, F), w2 (F, F), w3 (F, f_pad) with w3's columns padded with zeros
    to a multiple of F; ``vecs`` is flat f32: b1, ln1 scale, ln1 bias, b2,
    ln2 scale, ln2 bias (F each), b3 (f_pad). ``w`` views both, unpadded,
    for the plain version. ``tc`` is the three matrices split into TF32 hi
    and lo parts in fragment order for B6 on the tensor cores
    (``pack_tf32_mlp``), or None."""

    mats: torch.Tensor
    vecs: torch.Tensor
    f_in: int
    f_out: int
    w: MLPWeights
    tc: Optional[torch.Tensor] = None


def mlp_ctas_per_sm(f: int = KERNEL_F) -> int:
    """CTAs of csrc/fused_mlp_tf32x3.cu an SM holds at once at hidden width
    ``f``: two at F = 128 (128 registers a thread), one at F = 256 (its
    four n-tiles a pass need more)."""
    return 1 if f == 256 else MLP_CTAS_PER_SM


def mlp_k_pad(f_in: int) -> int:
    """W1's rows in the 3xTF32 packing: f_in padded to two k-steps."""
    return -(-f_in // MLP_K_STEP) * MLP_K_STEP


def mlp_n_pad(f_out: int) -> int:
    """W3's columns in the 3xTF32 packing: f_out padded to an n-tile."""
    return -(-f_out // MLP_N_TILE) * MLP_N_TILE


def pack_tf32_mlp(w: MLPWeights) -> torch.Tensor:
    """The MLP's matrices as csrc/fused_mlp_tf32x3.cu reads them: w1 with
    its rows padded with zeros to ``mlp_k_pad(f_in)``, w2, and w3 with its
    columns padded with zeros to ``mlp_n_pad(f_out)`` (the readout's 2 to
    one n-tile of 8), each split into TF32 hi and lo parts and permuted by
    ``_pack_tf32_matrix``; 2 (k_pad F + F² + F n_pad) f32 values."""
    f_in, f_out = w.w1.shape[0], w.w3.shape[1]
    w1 = tnf.pad(w.w1.detach().float(), (0, 0, 0, mlp_k_pad(f_in) - f_in))
    w3 = tnf.pad(w.w3.detach().float(), (0, mlp_n_pad(f_out) - f_out))
    return torch.cat([_pack_tf32_matrix(m) for m in (w1, w.w2.detach().float(), w3)]).contiguous()


def pack_mlp(w: MLPWeights, device) -> MLPPack:
    """``w`` packed once for B6, with its 3xTF32 packing (``tc``)."""
    f, f_in, f_out = w.w2.shape[0], w.w1.shape[0], w.w3.shape[1]
    f_pad = -(-f_out // f) * f
    w3 = tnf.pad(w.w3, (0, f_pad - f_out))
    b3 = tnf.pad(w.b3, (0, f_pad - f_out))
    mats = torch.cat([m.detach().reshape(-1) for m in (w.w1, w.w2, w3)])
    vecs = torch.cat([v.detach() for v in (w.b1, w.ln1_scale, w.ln1_bias, w.b2, w.ln2_scale,
                                           w.ln2_bias, b3)])
    mats = mats.to(device=device, dtype=torch.float32).contiguous()
    vecs = vecs.to(device=device, dtype=torch.float32).contiguous()
    m2, m3 = f_in * f, (f_in + f) * f
    views = MLPWeights(
        w1=mats[:m2].view(f_in, f), b1=vecs[:f], ln1_scale=vecs[f:2 * f],
        ln1_bias=vecs[2 * f:3 * f], w2=mats[m2:m3].view(f, f), b2=vecs[3 * f:4 * f],
        ln2_scale=vecs[4 * f:5 * f], ln2_bias=vecs[5 * f:6 * f],
        w3=mats[m3:].view(f, f_pad)[:, :f_out], b3=vecs[6 * f:6 * f + f_out],
    )
    return MLPPack(mats, vecs, f_in, f_out, views, pack_tf32_mlp(views))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fused_edge_mlp_reference(in_feat, pe, phi: MLPWeights, w: MLPWeights):
    """phi(in_feat) · w(pe) — the plain version of B4."""
    return _mlp_block(in_feat, phi) * _mlp_block(pe, w)


def edge_mlp_jvp_reference(in_feat, pe, din, dpe, phi: MLPWeights, w: MLPWeights):
    """Tangent of ``fused_edge_mlp_reference`` under (din, dpe) — the plain
    version of B5; lanes (K, R, ·) broadcast against the primal (R, ·)."""
    p, dp = _mlp_block_jvp(in_feat, din, phi)
    q, dq = _mlp_block_jvp(pe, dpe, w)
    return dp * q + p * dq


def _reference_packed(in_feat, pe, mats, vecs):
    wts = unpack_pair_mlps(mats, vecs)
    return fused_edge_mlp_reference(in_feat, pe, wts.phi, wts.w)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _on_card(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); raises on any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    return True


def _check(name: str, t: torch.Tensor, shape, dev) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be {tuple(shape)} float32, got {tuple(t.shape)} {t.dtype}")
    if t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {dev}")


def _check_pair_mlps(wts: PairLayerWeights, dev, f: int) -> None:
    if wts.mats.dtype != torch.float32 or wts.mats.numel() != 15 * f * f \
            or wts.vecs.numel() != 22 * f:
        raise ValueError(f"the fused edge-MLP kernels take f32 weights packed at F={f} "
                         "(pack_pair_mlps)")
    for t in (wts.mats, wts.vecs):
        if t.device != dev:
            raise ValueError(f"weights must be on {dev}, found them on {t.device}")


def _rows(t: torch.Tensor) -> int:
    if t.dim() != 2 or t.shape[0] < 1:
        raise ValueError(f"expected (rows >= 1, width) rows, got {tuple(t.shape)}")
    return t.shape[0]


def _route(libs: dict, variant: str, f: int) -> str:
    """The library of ``variant`` at width ``f``: the ``"tc"`` library's
    build for ``f`` where there is one (``width_library``), else its F =
    128 library, whose launch check then refuses ``f``."""
    if variant not in libs:
        raise ValueError(f"variant must be one of {tuple(libs)}, got {variant!r}")
    return width_library(libs[variant], f)


def _edge_route(variant: str, f: int = KERNEL_F) -> str:
    """The library a B4 launch takes at width ``f``: ``"tc"`` the 3xTF32
    tensor-core kernel (``fused_edge_mlp_tf32x3``, or its ``_f256``
    build), ``"fma"`` the f32-FMA kernel."""
    return _route(EDGE_LIBS, variant, f)


def edge_tile_rows(f: int = KERNEL_F) -> int:
    """Rows of a row tile of csrc/fused_edge_mlp_tf32x3.cu and
    csrc/fused_edge_mlp_jvp_tf32x3.cu at width ``f``: TC_ROWS (64) at F =
    128, 32 at F = 256 (a 64-row tile would leave B4 one CTA an SM, and
    would not fit B5's buffers in a CTA's shared memory)."""
    return 32 if f == 256 else TC_ROWS


def _tc_weights(wts: PairLayerWeights, x) -> torch.Tensor:
    """The 3xTF32 packing B4 and B5 on the tensor cores read
    (``with_tf32_weights``), checked; raises where the layer carries none."""
    return _packed(wts, x, 2 * wts.mats.numel(), torch.float32, "3xTF32", "with_tf32_weights")


def tc_edge_smem_bytes(f: int = KERNEL_F) -> int:
    """Dynamic shared memory of one CTA of csrc/fused_edge_mlp_tf32x3.cu at
    width ``f``: the [in] tile (edge_tile_rows x 2F) and the [pe] tile
    (edge_tile_rows x F), f32; 98,304 bytes at F = 128 and 256."""
    return 4 * edge_tile_rows(f) * 3 * f


class EdgePlan(NamedTuple):
    """How csrc/fused_edge_mlp_tf32x3.cu splits a launch: CTA c takes rows
    [T·c, min(T·(c + 1), R)) (T = ``edge_tile_rows``), ``ctas`` of them; ``resident``
    fit the card at once (EDGE_CTAS_PER_SM an SM), so they run in
    ``waves`` rounds."""

    ctas: int
    resident: int
    waves: int


def edge_plan(rows: int, sms: int, f: int = KERNEL_F) -> EdgePlan:
    ctas, resident = -(-rows // edge_tile_rows(f)), sms * EDGE_CTAS_PER_SM
    return EdgePlan(ctas, resident, -(-ctas // resident))


def fused_edge_mlp(in_feat, pe, wts: PairLayerWeights, variant: str = "tc"):
    """phi(in_feat) · w(pe): in_feat (R, 2F), pe (R, F) -> (R, 5F), f32.
    Launches kernel B4 on a CUDA tensor, the plain version on a CPU one
    (under either variant). ``variant="tc"`` takes the 3xTF32 tensor-core
    kernel (csrc/fused_edge_mlp_tf32x3.cu, at F = 128 or 256, which needs
    ``with_tf32_weights``); ``variant="fma"`` the f32-FMA kernel
    (csrc/fused_edge_mlp.cu, F = 128), kept for timing."""
    f = pe.shape[-1]
    lib = _edge_route(variant, f)
    if not _on_card(in_feat, "fused_edge_mlp"):
        PLAIN_CALLS["fused_edge_mlp"] += 1
        return fused_edge_mlp_reference(in_feat, pe, wts.phi, wts.w)
    dev, r = in_feat.device, _rows(in_feat)
    check_width(f, lib, LIB_WIDTHS.get(lib, KERNEL_F))
    _check("in_feat", in_feat, (r, 2 * f), dev)
    _check("pe", pe, (r, f), dev)
    _check_pair_mlps(wts, dev, f)
    mats = _tc_weights(wts, in_feat) if variant == "tc" else wts.mats
    handle = _build.load(lib)
    fn = getattr(handle, "fused_edge_mlp_tf32x3" if variant == "tc" else "fused_edge_mlp_f32")
    fn.argtypes = [_P] * 5 + [ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    out = torch.empty((r, 5 * f), device=dev, dtype=torch.float32)
    rc = fn(in_feat.data_ptr(), pe.data_ptr(), mats.data_ptr(), wts.vecs.data_ptr(),
            out.data_ptr(), r, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(handle, rc, f"{lib} launch")
    _build.count_launch("fused_edge_mlp", lib)
    return out


def jvp_smem_bytes(lane_block: int) -> int:
    """Dynamic shared memory of one CTA of B5's f32-FMA kernel
    (csrc/fused_edge_mlp_jvp.cu)."""
    return 4 * (8 + 2 * lane_block) * _R * KERNEL_F


def tc_jvp_smem_bytes(f: int = KERNEL_F) -> int:
    """Dynamic shared memory of one CTA of csrc/fused_edge_mlp_jvp_tf32x3.cu
    at width ``f``: four residual tiles (T x F, T = ``edge_tile_rows``), the
    mean and 1/std of four LayerNorms per row, the [in | din] tile (T x 2F)
    and the [pe | dpe] tile (T x F), all f32: 231,424 bytes at F = 128,
    230,400 at 256."""
    return 4 * edge_tile_rows(f) * (4 * f + 8 + 2 * f + f)


def tc_jvp_scratch(f: int = KERNEL_F) -> int:
    """Floats of one CTA's p, q (5F each, a row tile) in the scratch of
    csrc/fused_edge_mlp_jvp_tf32x3.cu: 81,920 at F = 128 and 256."""
    return 10 * edge_tile_rows(f) * f


TC_JVP_SCRATCH = tc_jvp_scratch()


class JvpPlan(NamedTuple):
    """How csrc/fused_edge_mlp_jvp_tf32x3.cu splits a launch: ``units`` =
    ``tiles`` row tiles of ``edge_tile_rows`` rows times K lanes, tile-major (unit u
    is lane u % K of tile u // K), over ``ctas`` persistent CTAs; CTA c
    takes units [units·c // ctas, units·(c + 1) // ctas)."""

    tiles: int
    units: int
    ctas: int


def jvp_plan(rows: int, k_lanes: int, sms: int, f: int = KERNEL_F) -> JvpPlan:
    tiles = -(-rows // edge_tile_rows(f))
    units = tiles * k_lanes
    return JvpPlan(tiles, units, min(sms, units))


def _jvp_route(variant: str, f: int = KERNEL_F) -> str:
    """The library a B5 launch takes at width ``f``: ``"tc"`` the 3xTF32
    tensor-core kernel (``fused_edge_mlp_jvp_tf32x3``, or its ``_f256``
    build), ``"fma"`` the f32-FMA kernel."""
    return _route(JVP_LIBS, variant, f)


def _pick_lane_block(k_lanes: int) -> int:
    """Lanes whose tangent chains the f32-FMA kernel keeps together per
    primal recompute: the most of 3, 2, 1 that divides K and fits shared
    memory."""
    for cand in (3, 2):
        if k_lanes % cand == 0 and jvp_smem_bytes(cand) <= SMEM_LIMIT:
            return cand
    return 1


def _launch_jvp_fma(in_feat, pe, din, dpe, wts, lane_block, out, r, k_lanes):
    L = lane_block or _pick_lane_block(k_lanes)
    if k_lanes % L:
        raise ValueError(f"lane_block {L} must divide the lane count {k_lanes}")
    if jvp_smem_bytes(L) > SMEM_LIMIT:
        raise ValueError(f"lane_block {L} needs {jvp_smem_bytes(L)} bytes of shared memory "
                         f"per CTA; the card has {SMEM_LIMIT}")
    lib = _build.load("fused_edge_mlp_jvp")
    fn = lib.fused_edge_mlp_jvp_f32
    fn.argtypes = [_P] * 7 + [ctypes.c_int] * 3 + [_P]
    fn.restype = ctypes.c_int
    rc = fn(*(t.data_ptr() for t in (in_feat, pe, din, dpe, wts.mats, wts.vecs, out)),
            r, k_lanes, L, torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(lib, rc, "fused_edge_mlp_jvp launch")


def _launch_jvp_tc(in_feat, pe, din, dpe, wts, out, r, k_lanes, lib: str, f: int):
    dev = out.device
    mats = _tc_weights(wts, in_feat)
    plan = jvp_plan(r, k_lanes, torch.cuda.get_device_properties(dev).multi_processor_count, f)
    scratch = torch.empty(plan.ctas * tc_jvp_scratch(f), device=dev, dtype=torch.float32)
    handle = _build.load(lib)
    fn = handle.fused_edge_mlp_jvp_tf32x3
    fn.argtypes = [_P] * 8 + [ctypes.c_int] * 3 + [_P]
    fn.restype = ctypes.c_int
    rc = fn(*(t.data_ptr() for t in (in_feat, pe, din, dpe, mats, wts.vecs, out, scratch)),
            r, k_lanes, plan.ctas, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(handle, rc, f"{lib} launch")


def fused_edge_mlp_jvp(in_feat, pe, din, dpe, wts: PairLayerWeights,
                       lane_block: Optional[int] = None, variant: str = "tc"):
    """Tangent of ``fused_edge_mlp`` under K lanes: primal in_feat (R, 2F),
    pe (R, F); tangents din (K, R, 2F), dpe (K, R, F) -> (K, R, 5F), f32.
    Launches kernel B5 on a CUDA tensor, the plain version on a CPU one
    (under either variant). ``variant="tc"`` takes the 3xTF32 tensor-core
    kernel (csrc/fused_edge_mlp_jvp_tf32x3.cu, at F = 128 or 256, which
    needs ``with_tf32_weights`` and ignores ``lane_block``);
    ``variant="fma"`` the f32-FMA kernel (csrc/fused_edge_mlp_jvp.cu, F =
    128, ``lane_block`` lanes a primal recompute), kept for timing."""
    f = pe.shape[-1]
    lib = _jvp_route(variant, f)
    if not _on_card(in_feat, "fused_edge_mlp_jvp"):
        PLAIN_CALLS["fused_edge_mlp_jvp"] += 1
        return edge_mlp_jvp_reference(in_feat, pe, din, dpe, wts.phi, wts.w)
    dev, r = in_feat.device, _rows(in_feat)
    check_width(f, lib, LIB_WIDTHS.get(lib, KERNEL_F))
    k_lanes = din.shape[0] if din.dim() == 3 else -1
    _check("in_feat", in_feat, (r, 2 * f), dev)
    _check("pe", pe, (r, f), dev)
    _check("din", din, (k_lanes, r, 2 * f), dev)
    _check("dpe", dpe, (k_lanes, r, f), dev)
    _check_pair_mlps(wts, dev, f)
    if k_lanes < 1:
        raise ValueError(f"din and dpe need at least one lane, got {tuple(din.shape)}")
    out = torch.empty((k_lanes, r, 5 * f), device=dev, dtype=torch.float32)
    if variant == "tc":
        _launch_jvp_tc(in_feat, pe, din, dpe, wts, out, r, k_lanes, lib, f)
    else:
        _launch_jvp_fma(in_feat, pe, din, dpe, wts, lane_block, out, r, k_lanes)
    _build.count_launch("fused_edge_mlp_jvp", lib)
    return out


def tc_mlp_smem_bytes(f: int = KERNEL_F) -> int:
    """Dynamic shared memory of one CTA of csrc/fused_mlp_tf32x3.cu at hidden
    width ``f``: two input chunks of MLP_ROWS x F f32, which then hold the
    two hidden activations: 16,384 bytes at F = 128, 32,768 at 256."""
    return 4 * 2 * MLP_ROWS * f


class MlpPlan(NamedTuple):
    """How csrc/fused_mlp_tf32x3.cu splits a launch: CTA c takes rows
    [MLP_ROWS·c, min(MLP_ROWS·(c + 1), R)), ``ctas`` of them; the input
    arrives in ``chunks`` chunks of F columns, and the last Dense
    has ``out_tiles`` n-tiles of 8 columns."""

    ctas: int
    out_tiles: int
    chunks: int


def mlp_plan(rows: int, f_in: int, f_out: int, f: int = KERNEL_F) -> MlpPlan:
    return MlpPlan(-(-rows // MLP_ROWS), mlp_n_pad(f_out) // MLP_N_TILE,
                   -(-mlp_k_pad(f_in) // f))


def _mlp_route(variant: str, f: int = KERNEL_F) -> str:
    """The library a B6 launch takes at hidden width ``f``: ``"tc"`` the
    3xTF32 tensor-core kernel (``fused_mlp_tf32x3``, or its ``_f256``
    build), ``"fma"`` the f32-FMA kernel."""
    return _route(MLP_LIBS, variant, f)


def _tc_mlp_weights(pack: MLPPack, x, f: int) -> torch.Tensor:
    """``pack.tc``, checked against what csrc/fused_mlp_tf32x3.cu reads at
    hidden width ``f``; raises where the pack carries none."""
    numel = 2 * f * (mlp_k_pad(pack.f_in) + f + mlp_n_pad(pack.f_out))
    tc = pack.tc
    if tc is None:
        raise ValueError("the MLP carries no 3xTF32 packing (pack_mlp attaches it)")
    if (tc.numel() != numel or tc.dtype != torch.float32 or tc.device != x.device
            or not tc.is_contiguous()):
        raise ValueError(f"the 3xTF32 MLP weights must be {numel} contiguous float32 values on "
                         f"{x.device}, got {tc.numel()} {tc.dtype} on {tc.device}")
    return tc


def fused_mlp(x, pack: MLPPack, variant: str = "tc"):
    """One MLP over rows: x (R, f_in) -> (R, f_out), f32. Launches kernel
    B6 on a CUDA tensor, the plain version on a CPU one (under either
    variant). ``variant="tc"`` takes the 3xTF32 tensor-core kernel
    (csrc/fused_mlp_tf32x3.cu, at hidden width F = 128 or 256, which needs
    ``pack.tc`` and x's rows in 16-byte steps); ``variant="fma"`` the f32-FMA
    kernel (csrc/fused_mlp.cu, F = 128), kept for timing. Either takes f_in
    a multiple of 4 (the packing pads W1's rows to the k-step)."""
    f = pack.w.w2.shape[0]
    lib = _mlp_route(variant, f)
    if not _on_card(x, "fused_mlp"):
        PLAIN_CALLS["fused_mlp"] += 1
        return _mlp_block(x, pack.w)
    dev, r = x.device, _rows(x)
    _check("x", x, (r, pack.f_in), dev)
    width = LIB_WIDTHS.get(lib, KERNEL_F)
    if f != width:
        raise WidthRefusal(f"{lib} takes hidden width F={width}, got F={f}; {TC_WIDTHS_ROUTE}")
    for t in (pack.mats, pack.vecs):
        if t.device != dev:
            raise ValueError(f"weights must be on {dev}, found them on {t.device}")
    if variant == "tc":
        if pack.f_in % 4 or x.data_ptr() % 16:
            raise ValueError(f"fused_mlp variant='tc' takes f_in a multiple of 4 and x 16-byte "
                             f"aligned; got f_in={pack.f_in} at {x.data_ptr() % 16} bytes past")
        mats = _tc_mlp_weights(pack, x, f)
    else:
        smem = 4 * _R * max(pack.f_in, f)
        if pack.f_in % 4 or smem > SMEM_LIMIT:
            raise ValueError(f"fused_mlp variant='fma' takes f_in a multiple of 4 whose input "
                             f"tile ({smem} bytes) fits {SMEM_LIMIT} bytes of shared memory; "
                             f"got f_in={pack.f_in}")
        mats = pack.mats
    handle = _build.load(lib)
    fn = getattr(handle, "fused_mlp_tf32x3" if variant == "tc" else "fused_mlp_f32")
    fn.argtypes = [_P] * 4 + [ctypes.c_int] * 3 + [_P]
    fn.restype = ctypes.c_int
    out = torch.empty((r, pack.f_out), device=dev, dtype=torch.float32)
    rc = fn(x.data_ptr(), mats.data_ptr(), pack.vecs.data_ptr(), out.data_ptr(),
            r, pack.f_in, pack.f_out, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(handle, rc, f"{lib} launch")
    _build.count_launch("fused_mlp", lib)
    return out


# ---------------------------------------------------------------------------
# the differentiable edge MLP: B4 forward, B5 tangent, under torch.func
# ---------------------------------------------------------------------------

@torch.library.custom_op("ti_torch::fused_edge_mlp_jvp", mutates_args=())
def _edge_mlp_jvp_op(in_feat: torch.Tensor, pe: torch.Tensor, din: torch.Tensor,
                     dpe: torch.Tensor, mats: torch.Tensor, vecs: torch.Tensor,
                     tf32: Optional[torch.Tensor]) -> torch.Tensor:
    return fused_edge_mlp_jvp(in_feat, pe, din, dpe, unpack_pair_mlps(mats, vecs)._replace(mma=tf32))


@_edge_mlp_jvp_op.register_fake
def _(in_feat, pe, din, dpe, mats, vecs, tf32):
    return din.new_empty(din.shape[0], din.shape[1], 5 * (vecs.shape[0] // 22))


def _edge_mlp_jvp_vmap(info, in_dims, in_feat, pe, din, dpe, mats, vecs, tf32):
    """Vmapped lanes (the divergence's vmap over its JVP lanes) fold into
    B5's K: one launch for all of them. The primal, the weights and their
    3xTF32 packing pass as they are, never batched or expanded."""
    if any(d is not None for d in (in_dims[0], in_dims[1], in_dims[4], in_dims[5], in_dims[6])):
        raise NotImplementedError(
            "the fused edge MLP's tangent rule vmaps over tangent lanes only, not over its "
            "primal rows, its weights or their packing")
    bs = info.batch_size

    def lanes(t, dim):  # (bs, K, R, W) -> (bs·K, R, W)
        t = t.movedim(dim, 0) if dim is not None else t.expand(bs, *t.shape)
        return t.reshape(bs * t.shape[1], *t.shape[2:]).contiguous()

    out = _edge_mlp_jvp_op(in_feat, pe, lanes(din, in_dims[2]), lanes(dpe, in_dims[3]), mats, vecs,
                           tf32)
    return out.reshape(bs, -1, *out.shape[1:]), 0


torch.library.register_vmap(_edge_mlp_jvp_op, _edge_mlp_jvp_vmap)


class _FusedEdgeMLP(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(in_feat, pe, mats, vecs, tf32=None):
        """B4; ``tf32`` is the 3xTF32 packing of ``mats`` (or None) that B4
        and the tangent rule's B5 read on the tensor cores."""
        return fused_edge_mlp(in_feat, pe, unpack_pair_mlps(mats, vecs)._replace(mma=tf32))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.set_materialize_grads(False)  # an input without a tangent arrives as None
        ctx.save_for_forward(*inputs[:4], inputs[4] if len(inputs) > 4 else None)

    @staticmethod
    def jvp(ctx, din, dpe, dmats, dvecs, *_):
        in_feat, pe, mats, vecs, tf32 = ctx.saved_tensors
        if dmats is not None or dvecs is not None:
            # tangents on the weights: the plain version's own JVP (never on
            # the sampling paths), as the JAX fallback
            primals = (in_feat, pe, mats, vecs)
            tangents = tuple(torch.zeros_like(p) if d is None else d
                             for p, d in zip(primals, (din, dpe, dmats, dvecs)))
            return torch.func.jvp(_reference_packed, primals, tangents)[1]
        din = torch.zeros_like(in_feat) if din is None else din
        dpe = torch.zeros_like(pe) if dpe is None else dpe
        return _edge_mlp_jvp_op(in_feat, pe, din.unsqueeze(0).contiguous(),
                                dpe.unsqueeze(0).contiguous(), mats, vecs, tf32).squeeze(0)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "fused_edge_mlp_diff is forward-mode only (sampling and dlogp); reverse mode "
            "(training) must use the plain composition, apply_dense(fused=False)")


def fused_edge_mlp_diff(in_feat, pe, wts: PairLayerWeights):
    """Differentiable fused edge MLP ``(R, 2F), (R, F) -> (R, 5F)``:
    forward = B4, JVP in (in_feat, pe) = B5, both on the tensor cores,
    reading ``wts.mma`` (``with_tf32_weights``; on a CPU tensor, the plain
    versions through the same rule, with or without it); JVP in the weights
    = the plain version's; no reverse mode."""
    return _FusedEdgeMLP.apply(in_feat, pe, wts.mats, wts.vecs, wts.mma)
