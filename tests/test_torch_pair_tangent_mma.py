"""The tensor-core route of kernel B3 (csrc/pair_tangent_mma.cu), as far as
the CPU reaches it: the fragment-order weight packing, a numpy walk of the
kernel's products tile by tile, its shared-memory count and the wrapper's
``variant`` keyword. The kernel itself runs only on the card
(tests/test_torch_gpu.py); the plain version it is held against there is
held against the JAX package in tests/test_torch_pair_tangent.py.
"""

import numpy as np
import pytest
import torch

from ti_torch.ops import _build
from ti_torch.ops.mlp_block import BF16, MLPWeights, dot_bf16
from ti_torch.ops.pair_layer_kernel import (
    SMEM_LIMIT,
    pack_mma_weights,
    pack_pair_mlps,
    with_mma_weights,
)
from ti_torch.ops.pair_tangent_kernel import (
    _check_lane_block,
    _pick_lane_block,
    pair_tangent,
    pair_tangent_plain,
    smem_bytes,
)


def _weights(f: int, dtype=BF16, seed: int = 0):
    rng = np.random.default_rng(seed)

    def mlp(f_in):
        def t(*shape):
            return torch.as_tensor(rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[0]))

        return MLPWeights(t(f_in, f), t(f), 1 + 0.1 * t(f), t(f), t(f, f), t(f), 1 + 0.1 * t(f), t(f),
                          t(f, 5 * f), t(5 * f))

    return pack_pair_mlps(mlp(2 * f), mlp(f), dtype, "cpu")


def _matrices(wts):
    return (wts.phi.w1, wts.phi.w2, wts.phi.w3, wts.w.w1, wts.w.w2, wts.w.w3)


def _b_fragment(packed: np.ndarray, n_out: int, kt: int, nt: int, lane: int):
    """The four values (k = 2t, 2t+1, 2t+8, 2t+9 at column g) thread ``lane``
    holds of the 16 x 8 B tile (kt, nt) of one packed matrix."""
    at = ((kt * (n_out // 16) + nt // 2) * 32 + lane) * 8 + 4 * (nt % 2)
    return packed[at: at + 4]


def _unpack(packed: np.ndarray, k: int, n: int) -> np.ndarray:
    """Rebuild a (k, n) matrix from its fragment order, tile by tile."""
    w = np.zeros((k, n), packed.dtype)
    for kt in range(k // 16):
        for nt in range(n // 8):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                frag = _b_fragment(packed, n, kt, nt, lane)
                for at, dk in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
                    w[16 * kt + dk, 8 * nt + g] = frag[at]
    return w


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("f", [128, 16])
def test_pack_mma_weights_round_trips(f):
    wts = _weights(f)
    packed = pack_mma_weights(wts)
    assert packed.dtype == BF16 and packed.numel() == wts.mats.numel() == 15 * f * f
    bits, off = _bits(packed), 0
    for m in _matrices(wts):
        k, n = m.shape
        assert np.array_equal(_unpack(bits[off: off + k * n], k, n), _bits(m))
        off += k * n  # each matrix keeps its offset of the row-major buffer
    assert off == packed.numel()


def test_pack_mma_weights_refuses_what_it_cannot_order():
    with pytest.raises(ValueError, match="multiples of 16"):
        pack_mma_weights(_weights(8))
    with pytest.raises(ValueError, match="bf16"):
        pack_mma_weights(_weights(16, torch.float32))


def test_with_mma_weights_packs_bf16_once():
    f32 = _weights(16, torch.float32)
    assert with_mma_weights(f32) is f32 and f32.mma is None
    wts = with_mma_weights(_weights(16))
    assert torch.equal(wts.mma, pack_mma_weights(wts))
    assert with_mma_weights(wts) is wts


def _swz(row: int, col: int, ld: int) -> int:
    """mma_common.cuh::swz: 16-byte chunk c of row r lives at chunk c ^ (r & 7)."""
    return row * ld + ((((col >> 3) ^ (row & 7)) << 3) | (col & 7))


@pytest.mark.parametrize("ld", [128, 256])
def test_swizzle_is_a_bijection_without_bank_conflicts(ld):
    rows = 32
    offs = {_swz(r, c, ld) for r in range(rows) for c in range(ld)}
    assert offs == set(range(rows * ld))
    for r0 in (0, 8, 16, 24):
        for chunk in range(ld // 8):
            # one ldmatrix phase: 8 rows of one 16-byte chunk, 4 banks each
            banks = {(_swz(r0 + r, 8 * chunk, ld) * 2 // 16) % 8 for r in range(8)}
            assert len(banks) == 8
    for nt in range(ld // 8):
        # one fragment access: 8 row groups x 4 threads, 4 bytes each
        banks = {(_swz(g, 8 * nt + 2 * t, ld) * 2 // 4) % 32 for g in range(8) for t in range(4)}
        assert len(banks) == 32


@pytest.mark.parametrize("which,lanes", [(0, 4), (1, 2), (2, 4)])
def test_fragment_walk_reproduces_the_dot(which, lanes):
    """The kernel's product, walked in numpy as the warps walk it: A fragments
    from the swizzled stacked tile (32 rows a lane), B fragments from the
    packed buffer, one 16 x 8 x 16 tile at a time with f32 sums. Against
    ``dot_bf16`` only the order of summation differs: rtol 1e-6, with an atol
    of 2e-6 max |dot| for sums that cancel."""
    f = 128
    wts = _weights(f, seed=1)
    m = _matrices(wts)[which]                    # phi.w1 (2F, F), phi.w2 (F, F), phi.w3 (F, 5F)
    k, n = m.shape
    off = sum(int(np.prod(q.shape)) for q in _matrices(wts)[:which])
    packed = pack_mma_weights(wts)[off: off + k * n].float().numpy()
    rng = np.random.default_rng(2)
    rows = 32 * lanes
    a = torch.as_tensor(rng.standard_normal((rows, k)).astype(np.float32)).to(BF16)
    tile = np.zeros(rows * k, np.float32)        # the swizzled shared-memory tile
    a32 = a.float().numpy()
    for r in range(rows):
        for c in range(k):
            tile[_swz(r, c, k)] = a32[r, c]
    n_cols = min(n, f)                           # one F-wide chunk of a 5F product
    nt0 = (n // 8 - n_cols // 8)                 # its last chunk
    out = np.zeros((rows, n_cols), np.float32)
    for warp in range(rows // 16):
        row0 = 16 * warp
        for nt in range(n_cols // 8):
            acc = np.zeros((16, 8), np.float32)
            for kt in range(k // 16):
                a_tile = np.array([[tile[_swz(row0 + r, 16 * kt + c, k)] for c in range(16)]
                                   for r in range(16)], np.float32)
                b_tile = np.zeros((16, 8), np.float32)
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    frag = _b_fragment(packed, n, kt, nt0 + nt, lane)
                    b_tile[[2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], g] = frag
                acc = acc + (a_tile @ b_tile).astype(np.float32)
            out[row0: row0 + 16, 8 * nt: 8 * nt + 8] = acc
    ref = dot_bf16(a, m)[:, 8 * nt0:].numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=2e-6 * np.abs(ref).max())


def test_every_lane_block_fits_shared_memory():
    blocks = {_pick_lane_block(k, bf16=True) for k in range(1, 65)}
    assert blocks == {1, 2, 4}
    for L in blocks:
        assert smem_bytes(True, L) <= SMEM_LIMIT
        _check_lane_block(True, 4 * L, L)
    assert smem_bytes(True, 4) == 222_976
    # the f32-FMA kernel (variant "fma") fits one lane a block, not two
    assert smem_bytes(False, 1) <= SMEM_LIMIT < smem_bytes(False, 2)
    _check_lane_block(False, 57, 1)
    with pytest.raises(ValueError, match="1, 2 or 4"):
        _check_lane_block(True, 16, 8)
    with pytest.raises(ValueError, match="shared memory"):
        _check_lane_block(False, 4, 2)
    with pytest.raises(ValueError, match="must divide"):
        _check_lane_block(True, 6, 4)


def _layer_inputs(f=16, n=5, b=2, k=4, seed=3):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dtype=BF16):
        return torch.as_tensor((scale * rng.standard_normal(shape)).astype(np.float32)).to(dtype)

    base = (t(b, n, 3, scale=0.3, dtype=torch.float32), t(b, n, f), t(b, 3, n, f, scale=0.3),
            t(b, n * n, f))
    lanes = (t(b, k, n, 3, dtype=torch.float32), t(b, k, n, f, scale=0.1),
             t(b, k, 3, n, f, scale=0.1), t(b, k, n * n, f, scale=0.1))
    return base, lanes


def test_unknown_variant_raises():
    """An unknown variant raises, and so does ``"fma"`` with bf16 weights: the
    f32-FMA kernel takes f32 only (its bf16 instantiation is gone)."""
    base, lanes = _layer_inputs()
    with pytest.raises(ValueError, match="variant"):
        pair_tangent(*base, *lanes, _weights(16), 10.0, variant="nonsense")
    with pytest.raises(ValueError, match="takes f32 weights"):
        pair_tangent(*base, *lanes, _weights(16), 10.0, 2, variant="fma")


@pytest.mark.parametrize("dtype,variant", [(BF16, "mma"), (torch.float32, "mma"),
                                           (torch.float32, "fma")])
def test_cpu_tensors_take_the_plain_version(dtype, variant):
    """On the CPU every route (bf16_agg on the tensor cores; f32 on the tensor
    cores or the f32-FMA kernel) is the plain version, bit for bit, and no
    kernel is launched or built (the weights need no packing there)."""
    base, lanes = _layer_inputs()
    base = (base[0],) + tuple(t.to(dtype) for t in base[1:])
    lanes = (lanes[0],) + tuple(t.to(dtype) for t in lanes[1:])
    wts = _weights(16, dtype)
    before = dict(_build.LAUNCHES)
    out = pair_tangent(*base, *lanes, wts, 10.0, 2, variant=variant)
    ref = pair_tangent_plain(*base, *lanes, wts, 10.0, 2)
    assert _build.LAUNCHES == before
    for a, r in zip(out, ref):
        assert a.dtype == r.dtype and torch.equal(a, r)
