"""One cPaiNN message layer on the dense pair grid — kernels B1 and B2,
hand-written CUDA, with their plain PyTorch version beside them. On the
tensor cores: B1 in f32 in split-precision TF32 ("3xTF32",
csrc/pair_layer_tf32x3.cu, the layer's matrices split and packed once in
fragment order by ``pack_tf32_weights``), and B1 and B2 in bf16_agg
(csrc/pair_layer_mma.cu, ``mma.sync`` bf16, the matrices packed once by
``pack_mma_weights``). B2 in f32 is B1's 3xTF32 kernel. csrc/pair_layer.cu
(f32 FMA) keeps both types of B1 and B2 as ``variant="fma"``. Every kernel
is built for F = 128; csrc/pair_layer_mma.cu and csrc/pair_layer_tf32x3.cu
are built at F = 256 and F = 64 as well (libraries ``pair_layer_mma_f256``,
``pair_layer_tf32x3_f256``, ``pair_layer_mma_f64`` and
``pair_layer_tf32x3_f64``), so B1 and B2 on the tensor cores take the
10506 profile's width and the validation CLIs' default width in both
types: ``fast_profile`` sends the 10506 bf16_agg trajectory through
``pair_layer_mma_f256``, ``traj_forward_impl="pair_kernel"`` its f32
trajectory through ``pair_layer_tf32x3_f256``. B3
(ops/pair_tangent_kernel.py) has the same ``_f64`` and ``_f256`` builds of
its tensor-core sources.

Port of ti_tpu/ops/pair_layer_kernel.py (the Pallas ``_pair_layer_kernel``,
and ``_pair_layer_kernel_cb`` for ``chain_block`` > 1). The chain-blocked
Pallas grid amortises a TPU grid step's overhead over C chains; a CUDA grid
has no such overhead. On this card the tensor-core kernels cut the
(B·N·N, F) pair rows into 64-row tiles of whole (chain, dst atom) groups;
``chain_block`` C only sets how many such tiles a CTA of
csrc/pair_layer_mma.cu takes, min(C, 3) (min(C, 4) at F = 64, one at F =
256), sharing each weight fragment it loads, and changes nothing in csrc/pair_layer_tf32x3.cu (in
csrc/pair_layer.cu it is C chains a CTA). Every C gives B1's result to the
bit on the tensor cores.
Per chain and pair row p = i·N + j (dst i, src j) the layer computes the
geometry r = x_j − x_i, dist and dir = r/(1+|r|); the positional encoding
of dist; h = phi([s_j | e_ij]) · w(PE(dist)) with both MLPs
Dense-LN-SiLU ×2 → Dense 5F; the diagonal mask; the Σ_j aggregations of
ds, gates·v_j and scale·dir; the chirality term (Σ_j cg·dir) × v_i; and
e + de.

Layouts (the kernel's and the plain version's): x (B, N, 3) f32; s (B, N, F);
v (B, 3, N, F) component-major; e (B, N·N, F). Outputs dv (B, 3, N, F) f32,
ds (B, N, F) f32, e_out (B, N·N, F). s, v, e and the MLP matrices are f32,
or bf16 in the ``bf16_agg`` profile (bf16 operands and pair storage, f32
accumulation rounded once, f32 LayerNorm statistics, f32 geometry and
aggregated outputs).

``pair_layer`` launches the kernel on a CUDA tensor and takes the plain
version only on a CPU tensor; there is no fallback between the two. The
plain version has no chain blocks: on a CPU tensor ``chain_block`` and
``variant`` change nothing.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from ti_torch.models.cpainn import state_of
from ti_torch.models.cpainn_dense import dense_edge_type_matrix, node_features
from ti_torch.ops import _build
from ti_torch.ops.mlp_block import (
    BF16,
    MLPWeights,
    _ln_silu_block,
    _ln_silu_block_agg,
    _mlp_block,
    dot_bf16_agg,
    mlp_weights,
)

KERNEL_F = 128       # the feature width the CUDA kernels are built for
# the tensor-core libraries of B1, B2 and B3 built for another width, by
# width: each is its F = 128 library's name with this suffix
WIDTH_SUFFIX = {64: "_f64", 256: "_f256"}
LIB_WIDTHS = {
    **{f"{lib}{sfx}": f for f, sfx in WIDTH_SUFFIX.items()
       for lib in ("pair_layer_mma", "pair_layer_tf32x3", "pair_tangent_mma",
                   "pair_tangent_tf32x3")},
    # B4, B5 and B6 on the tensor cores (ops/pallas_kernels.py): F = 256 only
    **{f"{lib}_f256": 256 for lib in ("fused_edge_mlp_tf32x3", "fused_edge_mlp_jvp_tf32x3",
                                      "fused_mlp_tf32x3")},
}
TC_WIDTHS_ROUTE = (
    "F = 64, 128 and 256 run in B1, B2 and B3 on the tensor cores, and F = 64 and 256 only "
    "there (pair_layer, variant None or 'tc': libraries pair_layer_mma_f64, pair_layer_mma "
    "and pair_layer_mma_f256 for bf16_agg weights, pair_layer_tf32x3_f64, pair_layer_tf32x3 "
    "and pair_layer_tf32x3_f256 for f32 weights; pair_tangent, variant 'mma': "
    "pair_tangent_mma_f64, pair_tangent_mma and pair_tangent_mma_f256 for bf16_agg, "
    "pair_tangent_tf32x3_f64, pair_tangent_tf32x3 and pair_tangent_tf32x3_f256 for f32); "
    "F = 128 and 256 run in B4, B5 and B6 on the tensor cores (variant 'tc': "
    "fused_edge_mlp_tf32x3 and fused_edge_mlp_tf32x3_f256, fused_edge_mlp_jvp_tf32x3 and "
    "fused_edge_mlp_jvp_tf32x3_f256, fused_mlp_tf32x3 and fused_mlp_tf32x3_f256); "
    "B7 and variant='fma' take F = 128 only")
KERNEL_MAX_N = 32    # pair rows per thread group: one dst atom's N src atoms
SMEM_LIMIT = 232_448  # bytes of shared memory one CTA may use on Hopper
MAX_CHAIN_BLOCK = 4   # of csrc/pair_layer.cu: 256 threads a chain, 1024 threads a CTA
_R, _NW, _NGEO = 32, 8, 10  # tile rows, warps of a group, geometry rows (pair_common.cuh)
TC_ROWS = 64         # pair rows of a row tile of the tensor-core kernels
_TC_GEO = 5          # geometry rows of csrc/pair_layer_tf32x3.cu: dist, mask, dir (3)


def mma_tile_bytes(f: int = KERNEL_F) -> int:
    """One row tile of csrc/pair_layer_mma.cu at width ``f``: X = [s_j |
    e_ij], Y = PE, H (bf16, 4F columns in all) and the rows' dist, mask and
    dir (5 x 4 bytes)."""
    return TC_ROWS * (2 * 4 * f + 4 * 5)


def mma_max_tiles(f: int = KERNEL_F) -> int:
    """Row tiles a CTA takes at most: as many as fit its shared memory at F
    = 128 (three) and F = 256 (one); four at F = 64, where six fit (C = 4
    is the largest chain block a path runs, and each tile count is a kernel
    of its own)."""
    fit = SMEM_LIMIT // mma_tile_bytes(f)
    return min(fit, 4) if f == 64 else fit


MMA_TILE_BYTES = mma_tile_bytes()
MMA_MAX_TILES = mma_max_tiles()
VARIANTS = ("tc", "fma")  # the tensor-core kernel of the weights' type, or the f32-FMA one


class PairLayerWeights(NamedTuple):
    """One message layer's weights, packed once for the kernel.

    ``mats`` is flat, in the working dtype: phi.w1 (2F,F), phi.w2 (F,F),
    phi.w3 (F,5F), w.w1 (F,F), w.w2 (F,F), w.w3 (F,5F), each (in, out)
    row-major — 15F² values. ``vecs`` is flat f32: per MLP (phi, then w)
    b1, ln1 scale, ln1 bias, b2, ln2 scale, ln2 bias (F each), b3 (5F) —
    22F values. ``phi`` and ``w`` are views into both, for the plain
    version. ``mma`` is ``mats`` once more in the fragment order of a
    tensor-core kernel, or None: bf16 for B1, B2 and B3 (``with_mma_weights``),
    f32 hi/lo TF32 pairs for B1 (``with_tf32_weights``)."""

    mats: torch.Tensor
    vecs: torch.Tensor
    phi: MLPWeights
    w: MLPWeights
    mma: Optional[torch.Tensor] = None

    @property
    def bf16(self) -> bool:
        return self.mats.dtype == BF16


def _mlp_views(mats, vecs, f: int, f_in: int, m0: int, v0: int):
    """MLPWeights viewing one MLP's slice of the packed buffers, and the
    offsets of the next MLP."""
    def mat(off, rows, cols):
        return mats[off: off + rows * cols].view(rows, cols)

    vec = [vecs[v0 + k * f: v0 + (k + 1) * f] for k in range(6)]
    w = MLPWeights(
        w1=mat(m0, f_in, f), b1=vec[0], ln1_scale=vec[1], ln1_bias=vec[2],
        w2=mat(m0 + f_in * f, f, f), b2=vec[3], ln2_scale=vec[4], ln2_bias=vec[5],
        w3=mat(m0 + (f_in + f) * f, f, 5 * f), b3=vecs[v0 + 6 * f: v0 + 11 * f],
    )
    return w, m0 + (f_in + 6 * f) * f, v0 + 11 * f


def pack_pair_mlps(phi: MLPWeights, w: MLPWeights, dtype, device) -> PairLayerWeights:
    """Pack the two message MLPs (phi: 2F -> 5F, w: F -> 5F) into the
    layout of the pair kernels and the fused edge-MLP kernels."""
    mats, vecs = [], []
    for m in (phi, w):
        mats += [m.w1, m.w2, m.w3]
        vecs += [m.b1, m.ln1_scale, m.ln1_bias, m.b2, m.ln2_scale, m.ln2_bias, m.b3]
    mats = torch.cat([m.detach().reshape(-1) for m in mats])
    vecs = torch.cat([v.detach().reshape(-1) for v in vecs])
    return unpack_pair_mlps(mats.to(device=device, dtype=dtype).contiguous(),
                            vecs.to(device=device, dtype=torch.float32).contiguous())


def unpack_pair_mlps(mats: torch.Tensor, vecs: torch.Tensor) -> PairLayerWeights:
    """PairLayerWeights over packed buffers, with the MLP views."""
    f = vecs.numel() // 22
    phi, m0, v0 = _mlp_views(mats, vecs, f, 2 * f, 0, 0)
    w, _, _ = _mlp_views(mats, vecs, f, f, m0, v0)
    return PairLayerWeights(mats, vecs, phi, w)


def pack_layer(params, layer: int, f: int, dtype, device) -> PairLayerWeights:
    """Pack message layer ``layer`` (width ``f``) of a CPaiNN state dict
    (once, when a drift or divergence function is built)."""
    phi = mlp_weights(params, f"message_{layer}.phi")
    if tuple(phi.w2.shape) != (f, f):
        raise ValueError(f"message_{layer} is {tuple(phi.w2.shape)} wide, not F={f}")
    return pack_pair_mlps(phi, mlp_weights(params, f"message_{layer}.w"), dtype, device)


def pe_scale(length_scale: float) -> float:
    """π/length_scale, the positional-encoding angle per rank and unit
    distance (rounded to f32 where used, as in the TPU kernel)."""
    return math.pi / float(length_scale)


def split_tf32(x: torch.Tensor):
    """(hi, lo) with x ≈ hi + lo, both TF32 values (f32 with the low 13
    mantissa bits zero): each rounds to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32`` does (integer ops on the int32 view). |x − hi − lo|
    is at most 2^-22 |x| for normal f32 values."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.to(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def _pack_tf32_matrix(w: torch.Tensor) -> torch.Tensor:
    """One (in, out) f32 matrix in the order the 3xTF32 kernel reads it: per
    8-row k-step ks and 8-column n-tile nt, per thread lane = 4g + t of a
    warp, the four values hi(w[8ks + 2t, 8nt + g]), hi(w[8ks + 2t + 1, 8nt + g])
    and the same two lo parts — the B fragment (b0, b1) of
    ``mma.m16n8k8.tf32`` twice, with the k-step's logical rows t and t + 4
    taken from the adjacent rows 2t and 2t + 1 (the A fragment is read the
    same way, so the sum is unchanged)."""
    k, n = w.shape
    if k % 8 or n % 8:
        raise ValueError(f"the fragment order needs multiples of 8, got a {k} x {n} matrix")
    parts = [p.reshape(k // 8, 4, 2, n // 8, 8).permute(0, 3, 4, 1, 2)  # ks, nt, g, t, e
             for p in split_tf32(w)]
    return torch.stack(parts, dim=-2).reshape(-1)                        # ..., hi|lo, e


def pack_tf32_weights(wts: PairLayerWeights) -> torch.Tensor:
    """``wts.mats`` split into TF32 hi and lo parts in fragment order: the
    six matrices at twice their offsets of the row-major buffer, each
    permuted by ``_pack_tf32_matrix`` (2 x 15F² f32 values). A pure function
    of the tensors; done once per layer, not per launch."""
    if wts.bf16:
        raise ValueError("the 3xTF32 kernel takes f32 weights (compute_dtype=None)")
    mats = (wts.phi.w1, wts.phi.w2, wts.phi.w3, wts.w.w1, wts.w.w2, wts.w.w3)
    return torch.cat([_pack_tf32_matrix(m) for m in mats]).contiguous()


def with_tf32_weights(wts: PairLayerWeights) -> PairLayerWeights:
    """``wts`` carrying its 3xTF32 packing (f32 weights only; bf16 weights
    come back as they are)."""
    if wts.bf16 or wts.mma is not None:
        return wts
    return wts._replace(mma=pack_tf32_weights(wts))


def _pack_mma_matrix(w: torch.Tensor) -> torch.Tensor:
    """One (in, out) matrix in the order the bf16 tensor-core kernels read it:
    per 16-row k-tile kt and pair np of 8-column n-tiles, per thread
    lane = 4g + t of a warp, the eight values
    w[16kt + 8h + 2t + e, 16np + 8q + g] for q, h, e in {0, 1} — the B
    fragments (b0, b1) of ``mma.m16n8k16`` for n-tiles 2np and 2np + 1."""
    k, n = w.shape
    if k % 16 or n % 16:
        raise ValueError(f"the fragment order needs multiples of 16, got a {k} x {n} matrix")
    v = w.reshape(k // 16, 2, 4, 2, n // 16, 2, 8)      # kt, h, t, e, np, q, g
    return v.permute(0, 4, 6, 2, 5, 1, 3).reshape(-1)   # kt, np, g, t, q, h, e


def pack_mma_weights(wts: PairLayerWeights) -> torch.Tensor:
    """``wts.mats`` in fragment order: the six matrices at their offsets of
    the row-major buffer, each permuted by ``_pack_mma_matrix``. A pure
    function of the tensors; done once per layer, not per launch."""
    if not wts.bf16:
        raise ValueError("the tensor-core kernel takes bf16 weights (compute_dtype='bf16_agg')")
    mats = (wts.phi.w1, wts.phi.w2, wts.phi.w3, wts.w.w1, wts.w.w2, wts.w.w3)
    return torch.cat([_pack_mma_matrix(m) for m in mats]).contiguous()


def with_mma_weights(wts: PairLayerWeights) -> PairLayerWeights:
    """``wts`` carrying its fragment-order packing (bf16 weights only; f32
    weights come back as they are)."""
    if not wts.bf16 or wts.mma is not None:
        return wts
    return wts._replace(mma=pack_mma_weights(wts))


class TilePlan(NamedTuple):
    """How csrc/pair_layer_tf32x3.cu cuts the (B·N·N, F) pair rows: each CTA
    takes ``groups`` whole (chain, dst atom) groups, ``rows`` = groups·N
    consecutive pair rows of its TC_ROWS-row tile (the rest is padding);
    ``ctas`` CTAs, ``smem`` bytes of dynamic shared memory each."""

    groups: int
    rows: int
    ctas: int
    smem: int


def tc_smem_bytes(f: int = KERNEL_F) -> int:
    """Shared memory of one CTA of csrc/pair_layer_tf32x3.cu at width ``f``:
    the f32 tiles X = [s_j | e_ij] (TC_ROWS x 2F) and Y = PE (TC_ROWS x F),
    and the geometry rows. 99,584 bytes at F = 128 (two CTAs an SM),
    197,888 at F = 256 (one), 50,432 at F = 64 (four)."""
    return 4 * TC_ROWS * (3 * f + _TC_GEO)


def tc_threads(f: int = KERNEL_F) -> int:
    """Threads of a CTA of csrc/pair_layer_tf32x3.cu: a warp for each 32 x 32
    block of the 64-row tile's F columns (4 warps at F = 64, 8 at F = 128,
    16 at 256)."""
    return 2 * f


def tile_plan(b: int, n: int, f: int = KERNEL_F) -> TilePlan:
    groups = TC_ROWS // n
    return TilePlan(groups, groups * n, -(-b * n // groups), tc_smem_bytes(f))


def tile_groups(plan: TilePlan, cta: int, b: int, n: int) -> range:
    """The flat groups q = b·N + i of one CTA (its pair rows are q·N + j)."""
    q0 = cta * plan.groups
    return range(q0, min(q0 + plan.groups, b * n))


class MmaPlan(NamedTuple):
    """How csrc/pair_layer_mma.cu cuts the (B·N·N, F) pair rows: row tiles
    of ``groups`` whole (chain, dst atom) groups (groups·N consecutive pair
    rows of TC_ROWS), ``tiles`` of them a CTA (``mma_tiles``), ``ctas``
    CTAs of ``smem`` bytes of dynamic shared memory."""

    groups: int
    tiles: int
    ctas: int
    smem: int


def mma_tiles(chain_block: int, f: int = KERNEL_F) -> int:
    """Row tiles a CTA of csrc/pair_layer_mma.cu takes for ``chain_block``
    at width ``f``: as many, up to ``mma_max_tiles`` (three at F = 128, one
    at F = 256, four at F = 64). Four walked in two rounds of two were
    slower than three at once at F = 128, so chain_block 4 takes three there
    (PERF.md, section 6)."""
    return min(chain_block, mma_max_tiles(f))


def mma_smem_bytes(chain_block: int, f: int = KERNEL_F) -> int:
    return mma_tiles(chain_block, f) * mma_tile_bytes(f)


def mma_tile_plan(b: int, n: int, chain_block: int, f: int = KERNEL_F) -> MmaPlan:
    groups, tiles = TC_ROWS // n, mma_tiles(chain_block, f)
    row_tiles = -(-b * n // groups)
    return MmaPlan(groups, tiles, -(-row_tiles // tiles), mma_smem_bytes(chain_block, f))


def mma_tile_groups(plan: MmaPlan, cta: int, slot: int, b: int, n: int) -> range:
    """The flat groups q = b·N + i of row tile ``slot`` of one CTA (empty
    past the last group)."""
    q0 = (cta * plan.tiles + slot) * plan.groups
    return range(min(q0, b * n), min(q0 + plan.groups, b * n))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _mlp_store(x, w: MLPWeights, bf16: bool):
    """(pre-LN h1, pre-LN h2, out) of one MLP in the kernel's precision:
    f32, or bf16 dot outputs rounded once + bf16 biases + f32 LN stats."""
    if bf16:
        dot, ln = dot_bf16_agg, _ln_silu_block_agg

        def bias(b):
            return b.to(BF16)
    else:
        dot, ln = torch.matmul, _ln_silu_block

        def bias(b):
            return b
    h1 = dot(x, w.w1) + bias(w.b1)
    h2 = dot(ln(h1, w.ln1_scale, w.ln1_bias), w.w2) + bias(w.b2)
    out = dot(ln(h2, w.ln2_scale, w.ln2_bias), w.w3) + bias(w.b3)
    return h1, h2, out


def pair_geometry(x: torch.Tensor):
    """Per pair row p = i·N + j: r (B,P,3), dist, inv = 1/(1+dist) and
    sid = 1/dist off the diagonal (B,P,1); the diagonal mask (P,1)."""
    b, n, _ = x.shape
    r = (x[:, None, :, :] - x[:, :, None, :]).reshape(b, n * n, 3)
    d2 = r[..., 0:1] ** 2 + r[..., 1:2] ** 2 + r[..., 2:3] ** 2
    dist = torch.sqrt(d2)
    inv = 1.0 / (1.0 + dist)
    sid = torch.where(dist > 0, 1.0 / torch.clamp(dist, min=1e-30), torch.zeros_like(dist))
    p = torch.arange(n * n, device=x.device)
    mask = (p // n != p % n).to(torch.float32)[:, None]
    return r, dist, inv, sid, mask


def pe_angle(dist: torch.Tensor, f: int, ps: float):
    """(angle (B,P,F), rank (F,), even-lane mask (F,)) of the interleaved
    cos/sin encoding: lane k has rank k//2+1, cos on even lanes."""
    lane = torch.arange(f, device=dist.device)
    rank = (lane // 2 + 1).to(torch.float32)
    return dist * rank * ps, rank, lane % 2 == 0


def tile_src(a: torch.Tensor, n: int) -> torch.Tensor:
    """(..., N, W) node rows -> (..., N·N, W) pair rows, row i·N+j <- node j."""
    return a.unsqueeze(-3).expand(*a.shape[:-2], n, n, a.shape[-1]).reshape(
        *a.shape[:-2], n * n, a.shape[-1])


def agg(rows: torch.Tensor, n: int) -> torch.Tensor:
    """(..., N·N, W) -> (..., N, W): f32 sum over the src atoms j of each
    dst block."""
    return rows.reshape(*rows.shape[:-2], n, n, rows.shape[-1]).float().sum(-2)


def chirality(t0, t1, t2, vx, vy, vz):
    """(Σ_j cg·dir) × v_dst by components."""
    return t1 * vz - t2 * vy, t2 * vx - t0 * vz, t0 * vy - t1 * vx


def primal_plain(x, s, v, e, wts: PairLayerWeights, length_scale: float):
    """The primal layer in the kernels' precision: ((dv, ds, e_out), the
    residuals the tangent lanes replay)."""
    b, n, _ = x.shape
    f = s.shape[-1]
    bf16 = wts.bf16
    wd = s.dtype
    ps = pe_scale(length_scale)
    r, dist, inv, sid, mask = pair_geometry(x)
    ang, rank, even = pe_angle(dist, f, ps)
    pe = torch.where(even, torch.cos(ang), torch.sin(ang))
    in_feats = torch.cat([tile_src(s, n), e], dim=-1)
    h1p, h2p, outp = _mlp_store(in_feats, wts.phi, bf16)
    h1w, h2w, outw = _mlp_store(pe, wts.w, bf16)
    h = outp * outw * mask.to(wd)
    gates, scale_dir, ds, de, cg = torch.split(h, f, dim=-1)
    dirs = [(r[..., c:c + 1] * inv).to(wd) for c in range(3)]
    out = [agg(gates * tile_src(v[:, c], n) + scale_dir * dirs[c], n) for c in range(3)]
    t_cg = [agg(cg * dirs[c], n) for c in range(3)]
    cross = chirality(*t_cg, v[:, 0], v[:, 1], v[:, 2])
    dv = torch.stack([out[c] + cross[c] for c in range(3)], dim=1)
    pefac = (torch.where(even, -torch.sin(ang), torch.cos(ang)) * rank * ps).to(wd)
    res = dict(r=r, inv=inv, sid=sid, mask=mask.to(wd), dirs=dirs, pefac=pefac,
               h1p=h1p, h2p=h2p, outp=outp, h1w=h1w, h2w=h2w, outw=outw,
               gates=gates, scale_dir=scale_dir, cg=cg, t_cg=t_cg)
    return (dv, agg(ds, n), e + de), res


def pair_layer_plain(x, s, v, e, wts: PairLayerWeights, length_scale: float):
    """The plain PyTorch version of kernel B1 (same layouts and precision)."""
    return primal_plain(x, s, v, e, wts, length_scale)[0]


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


class WidthRefusal(ValueError):
    """A kernel's library is not built for the width it was given: the
    port refuses that route (and names the widths that run, and where)
    rather than run the plain version in its place."""


def check_width(f: int, what: str, width: int = KERNEL_F) -> None:
    """Raise ``WidthRefusal`` unless ``what`` (a library or a kernel) is
    built for ``f``; the message names the widths that run and their routes."""
    if f != width:
        raise WidthRefusal(f"{what} is built for F={width}, got F={f}; {TC_WIDTHS_ROUTE}")


def width_library(lib: str, f: int) -> str:
    """The build of tensor-core library ``lib`` (an F = 128 name) for width
    ``f``: ``lib`` itself at F = 128 and at every width no library is built
    for (its launch check then refuses the width)."""
    built = lib + WIDTH_SUFFIX.get(f, "")
    return built if built in LIB_WIDTHS else lib


def _check_pair_inputs(x, s, v, e, wts: PairLayerWeights, lib: str):
    """Device, dtype, shape and contiguity checks shared by the pair
    kernels' libraries (B1, B2 and B3), the width against ``lib``'s;
    returns (B, N, F, working dtype)."""
    dev = x.device
    if x.dim() != 3 or x.shape[-1] != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be (B, N, 3) float32, got {tuple(x.shape)} {x.dtype}")
    b, n, _ = x.shape
    f = s.shape[-1]
    wd = BF16 if wts.bf16 else torch.float32
    check_width(f, lib, LIB_WIDTHS.get(lib, KERNEL_F))
    if not 2 <= n <= KERNEL_MAX_N:
        raise ValueError(f"the CUDA pair kernels take 2..{KERNEL_MAX_N} atoms, got {n}")
    want = {"s": (s, (b, n, f)), "v": (v, (b, 3, n, f)), "e": (e, (b, n * n, f))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != wd:
            raise ValueError(f"{name} must be {shape} {wd}, got {tuple(t.shape)} {t.dtype}")
    if wts.mats.numel() != 15 * f * f or wts.vecs.numel() != 22 * f or wts.vecs.dtype != torch.float32:
        raise ValueError("weights are not packed for this width (pack_layer)")
    for t in (x, s, v, e, wts.mats, wts.vecs):
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, found one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA pair kernels take contiguous tensors")
    return b, n, f, wd


def check_chain_block(chain_block) -> int:
    if isinstance(chain_block, bool) or not isinstance(chain_block, int) or chain_block < 1:
        raise ValueError(f"chain_block must be an integer >= 1, got {chain_block!r}")
    return chain_block


def group_smem_bytes(bf16: bool) -> int:
    """Dynamic shared memory of one chain's thread group in csrc/pair_layer.cu;
    a CTA of C chains takes C times this."""
    t = 2 if bf16 else 4
    red_in_x = t * _R * KERNEL_F >= 4 * _NW * 3 * KERNEL_F
    return t * 3 * _R * KERNEL_F + 4 * ((0 if red_in_x else _NW * 3 * KERNEL_F)
                                        + _NGEO * _R + 7 * KERNEL_F)


def _route(bf16: bool, chain_block: int, variant: Optional[str], f: int = KERNEL_F) -> str:
    """The library a launch takes: the tensor-core kernel of the weights'
    type for every ``chain_block`` ("pair_layer_tf32x3" for f32, and at F =
    64 and 256 "pair_layer_tf32x3_f64" and "_f256"; "pair_layer_mma" for
    bf16_agg, min(C, 3) tiles a CTA, and "pair_layer_mma_f64", min(C, 4), and
    "pair_layer_mma_f256", one tile a CTA), or, for ``variant="fma"``,
    "pair_layer" (csrc/pair_layer.cu, which refuses chain_block >
    MAX_CHAIN_BLOCK when it launches). Each library takes its own width
    only, and refuses any other when it launches."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"variant must be None or one of {VARIANTS}, got {variant!r}")
    if variant == "fma":
        return "pair_layer"
    return width_library("pair_layer_mma" if bf16 else "pair_layer_tf32x3", f)


def _packed(wts: PairLayerWeights, x, numel: int, dtype, what: str, how: str) -> torch.Tensor:
    """The weights' fragment-order packing, checked against what the kernel reads."""
    mats = wts.mma
    if mats is None:
        raise ValueError(f"the weights carry no {what} packing ({how})")
    if (mats.numel() != numel or mats.dtype != dtype or mats.device != x.device
            or not mats.is_contiguous()):
        raise ValueError(f"the {what} weights must be {numel} contiguous {dtype} values on "
                         f"{x.device}, got {mats.numel()} {mats.dtype} on {mats.device}")
    return mats


def _launch(lib: str, x, s, v, e, wts: PairLayerWeights, length_scale: float, c: int):
    """One launch of library ``lib``: pair_layer_tf32x3 (B1/B2 f32 on the
    tensor cores, whatever C), pair_layer_tf32x3_f64 and _f256 (the same at
    F = 64, 4 warps a CTA, and at F = 256, 16 warps a CTA), pair_layer_mma
    (B1/B2 bf16_agg on the tensor cores, min(C, 3) row tiles a CTA),
    pair_layer_mma_f64 and _f256 (the same at F = 64, min(C, 4) row tiles a
    CTA, and at F = 256, one) or pair_layer (f32 FMA, C chains a CTA)."""
    b, n, f, _ = _check_pair_inputs(x, s, v, e, wts, lib)
    if lib.startswith("pair_layer_tf32x3"):
        mats = _packed(wts, x, 2 * wts.mats.numel(), torch.float32, "3xTF32", "with_tf32_weights")
        args = ()
    elif lib.startswith("pair_layer_mma"):
        mats = _packed(wts, x, wts.mats.numel(), BF16, "fragment-order", "with_mma_weights")
        args = (mma_tiles(c, f),)
    else:
        smem = c * group_smem_bytes(wts.bf16)
        if c > MAX_CHAIN_BLOCK or smem > SMEM_LIMIT:
            raise ValueError(
                f"chain_block {c} cannot launch: it needs {256 * c} threads and {smem} bytes of "
                f"shared memory per CTA ({group_smem_bytes(wts.bf16)} a chain); the card allows "
                f"1024 threads and {SMEM_LIMIT} bytes (chain_block <= {MAX_CHAIN_BLOCK})")
        mats, args = wts.mats, (c,)
    handle = _build.load(lib)
    fn = getattr(handle, _build.source_of(lib) if lib != "pair_layer" else
                 "pair_layer_bf16" if wts.bf16 else "pair_layer_f32")
    fn.argtypes = [_P] * 9 + [ctypes.c_int] * (2 + len(args)) + [ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    dv = torch.empty((b, 3, n, f), device=x.device, dtype=torch.float32)
    ds = torch.empty((b, n, f), device=x.device, dtype=torch.float32)
    e_out = torch.empty_like(e)
    rc = fn(x.data_ptr(), s.data_ptr(), v.data_ptr(), e.data_ptr(), mats.data_ptr(),
            wts.vecs.data_ptr(), dv.data_ptr(), ds.data_ptr(), e_out.data_ptr(), b, n, *args,
            pe_scale(length_scale), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(handle, rc, f"{lib} launch")
    return dv, ds, e_out


def pair_layer(x, s, v, e, wts: PairLayerWeights, length_scale: float, chain_block: int = 1,
               variant: Optional[str] = None):
    """One message layer: (dv, ds, e_out). Launches kernel B1 on a CUDA
    tensor (B2 with ``chain_block`` > 1), the plain version on a CPU tensor.
    By default (``variant`` None or "tc") the tensor-core kernel of the
    weights' type runs, for every ``chain_block``: 3xTF32 for f32
    (``with_tf32_weights``; C changes nothing in it), ``mma.sync`` bf16 for
    bf16_agg (``with_mma_weights``; ``mma_tiles``: min(C, 3) 64-row tiles a
    CTA; min(C, 4) at F = 64, library pair_layer_mma_f64; one at F = 256,
    library pair_layer_mma_f256); every C gives B1's bits. At F = 64 and
    256 f32 takes library pair_layer_tf32x3_f64 or _f256.
    ``variant="fma"`` takes the f32-FMA kernel (C chains a CTA, C <=
    MAX_CHAIN_BLOCK). Only the tensor-core kernels take F = 64 and 256; the
    f32-FMA one raises on a CUDA tensor of those widths, and every library
    at any other width but 128."""
    c = check_chain_block(chain_block)
    lib = _route(wts.bf16, c, variant, s.shape[-1])
    if x.device.type == "cpu":
        return pair_layer_plain(x, s, v, e, wts, length_scale)
    if x.device.type != "cuda":
        raise ValueError(f"pair_layer runs on cuda or cpu, not {x.device}")
    out = _launch(lib, x, s, v, e, wts, length_scale, c)
    _build.count_launch("pair_layer" if c == 1 else "pair_layer_cb", lib)
    return out


# ---------------------------------------------------------------------------
# the velocity field through the layer kernel
# ---------------------------------------------------------------------------

class PairModel(NamedTuple):
    """What the pair-kernel forwards need, resolved once when a drift or
    divergence function is built: the state dict on the device, the packed
    message layers (f32 ones with their 3xTF32 packing, bf16_agg ones with
    their fragment-order bf16 packing) and the flat edge types."""

    model: object
    p: dict
    layers: list
    etype: torch.Tensor
    atom_ids: torch.Tensor
    bf16: bool


def prepare(model, params, template, compute_dtype, device) -> PairModel:
    if getattr(model, "cutoff", None) is not None:
        raise NotImplementedError(
            "the pair kernels support the complete graph only (cutoff=None); "
            "use apply_dense for finite-cutoff models"
        )
    if compute_dtype not in (None, "bf16_agg"):
        raise ValueError(
            "the pair kernels' compute_dtype must be None (f32) or "
            f"'bf16_agg', got {compute_dtype!r}"
        )
    bf16 = compute_dtype == "bf16_agg"
    p = {k: t.detach().to(device) for k, t in state_of(model, params).items()}
    f = model.n_features
    wd = BF16 if bf16 else torch.float32
    layers = [with_mma_weights(with_tf32_weights(pack_layer(p, i, f, wd, device)))
              for i in range(model.score_layers)]
    n = template.n_atoms
    etype = torch.as_tensor(dense_edge_type_matrix(template.edges).reshape(n * n),
                            device=device).long()
    atom_ids = torch.as_tensor(template.atom_ids, device=device)
    return PairModel(model, p, layers, etype, atom_ids, bf16)


def embed(pm: PairModel, t, temps, n: int):
    """(s (B,N,F), e (B,N·N,F)) in the working dtype: the combine MLP of
    the node encodings and the edge-type embedding."""
    model, p = pm.model, pm.p
    f = model.n_features
    mlp_kw = dict(compute_dtype=BF16, bf16_out=True) if pm.bf16 else {}
    s = _mlp_block(node_features(model, p, t, temps, pm.atom_ids, n),
                   mlp_weights(p, "combine"), **mlp_kw)
    wd = BF16 if pm.bf16 else torch.float32
    e = p["edge_embed.weight"][pm.etype].to(wd).expand(t.shape[0], n * n, f)
    return s.to(wd), e.contiguous()


def apply_dense_pair_kernel(pm: PairModel, x, t, temps, *, kernel: bool = True,
                            chain_block: int = 1):
    """Batched velocity (B, N, 3) with the message layers in kernel B1, or
    B2 with ``chain_block`` > 1 (``kernel=False``: their plain version, on
    any device). Same math as ``apply_dense`` on the complete graph;
    inference only."""
    model, p = pm.model, pm.p
    b, n, _ = x.shape
    f = model.n_features
    bf16 = pm.bf16
    wd = BF16 if bf16 else torch.float32
    mlp_kw = dict(compute_dtype=BF16, bf16_out=True) if bf16 else {}

    def c(a):
        return a.to(wd)

    def ein(eq, a, w):
        if bf16:
            return torch.einsum(eq, a.float(), w.float()).to(BF16)
        return torch.einsum(eq, a, w)

    x = x.contiguous()
    s, e = embed(pm, t, temps, n)
    v = torch.zeros((b, 3, n, f), dtype=wd, device=x.device)
    for layer in range(model.score_layers):
        args = (x, s.contiguous(), v, e, pm.layers[layer], model.length_scale)
        dv, ds, e = pair_layer(*args, chain_block) if kernel else pair_layer_plain(*args)
        s = c(s + ds)
        v = c(v + dv)
        # node update (reference Update), plain: O(N·F) rows
        up = f"update_{layer}"
        v3 = v.permute(0, 2, 3, 1)  # (B, N, F, 3)
        uv = ein("bnfc,gf->bngc", v3, c(p[f"{up}.u.weight"]))
        vv = ein("bnfc,gf->bngc", v3, c(p[f"{up}.v.weight"]))
        vv_norm = torch.linalg.norm(vv.float(), dim=-1)
        hu = _mlp_block(torch.cat([c(vv_norm), s], dim=-1), mlp_weights(p, f"{up}.mlp"), **mlp_kw)
        g_u, scale_sq, add_inv = torch.split(hu, f, dim=-1)
        v3 = v3 + c(g_u)[..., None] * uv
        s = c(s + c(vv_norm ** 2 * scale_sq.float() + add_inv.float()))
        v = v3.permute(0, 3, 1, 2).contiguous()

    v3 = v.permute(0, 2, 3, 1)
    hr = _mlp_block(s, mlp_weights(p, "readout.mlp"), **mlp_kw)  # (B, N, 2)
    v_out = ein("bnfc,gf->bngc", v3, c(p["readout.V.weight"]))
    return (hr[..., 1:2].float() * v_out[:, :, 0, :].float()).to(x.dtype)


def pair_kernel_drift(model, params, template, *, compute_dtype=None,
                      device=None, kernel: bool = True, chain_block: int = 1):
    """Batched drift ``(xs (B,N,3), t, temps (B,K)) -> (B,N,3)`` through
    kernel B1, or B2 with ``chain_block`` > 1 (min(C, 3) 64-row tiles a
    CTA in bf16_agg, min(C, 4) at F = 64, B1's tiles in f32) — the
    velocity-only trajectory segments of the Gauss quadrature-dlogp path
    and the SDE drift. Packs the weights once, here. Runs on ``cuda``
    unless ``device`` says otherwise; ``kernel=False`` builds the same
    drift from the plain version (the comparison on the card)."""
    from ti_torch import resolve_device

    check_chain_block(chain_block)
    dev = resolve_device(device)
    pm = prepare(model, params, template, compute_dtype, dev)

    def drift(xs, t, temps):
        tb = torch.as_tensor(t, dtype=xs.dtype, device=xs.device).expand(xs.shape[0])
        return apply_dense_pair_kernel(pm, xs, tb, temps, kernel=kernel,
                                       chain_block=chain_block)

    return drift
