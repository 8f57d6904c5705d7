"""The 3xTF32 tensor-core route of kernel B1 in f32
(csrc/pair_layer_tf32x3.cu), as far as the CPU reaches it: the TF32 split,
the fragment-order weight packing, a numpy walk of one 64-row tile's
products fragment by fragment, the tile plan and the wrapper's ``variant``
keyword. The kernel itself runs only on the card (tests/test_torch_gpu.py);
the plain version it is held against there is held against the JAX package
in tests/test_torch_pair_layer.py.
"""

import numpy as np
import pytest
import torch

from ti_torch.ops import _build
from ti_torch.ops.mlp_block import BF16, MLPWeights
from ti_torch.ops.pair_layer_kernel import (
    KERNEL_MAX_N,
    SMEM_LIMIT,
    TC_ROWS,
    VARIANTS,
    _pack_tf32_matrix,
    pack_mma_weights,
    pack_pair_mlps,
    pack_tf32_weights,
    pair_layer,
    pair_layer_plain,
    split_tf32,
    tc_smem_bytes,
    tile_groups,
    tile_plan,
    with_tf32_weights,
)


def _weights(f: int, dtype=torch.float32, seed: int = 0):
    rng = np.random.default_rng(seed)

    def mlp(f_in):
        def t(*shape):
            return torch.as_tensor(rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[0]))

        return MLPWeights(t(f_in, f), t(f), 1 + 0.1 * t(f), t(f), t(f, f), t(f), 1 + 0.1 * t(f), t(f),
                          t(f, 5 * f), t(5 * f))

    return pack_pair_mlps(mlp(2 * f), mlp(f), dtype, "cpu")


def _matrices(wts):
    return (wts.phi.w1, wts.phi.w2, wts.phi.w3, wts.w.w1, wts.w.w2, wts.w.w3)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _random_f32(n: int, seed: int) -> np.ndarray:
    """Normal f32 values of both signs over exponents -100 .. 100, and zeros."""
    rng = np.random.default_rng(seed)
    mant = rng.uniform(1.0, 2.0, n)
    x = (np.sign(rng.standard_normal(n)) * mant * 2.0 ** rng.integers(-100, 101, n)).astype(np.float32)
    x[:: 17] = 0.0
    x[1:: 17] = -0.0
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_split_tf32_is_two_tf32_values_within_2e_21(seed):
    x = _random_f32(20_000, seed)
    hi, lo = (t.numpy() for t in split_tf32(torch.as_tensor(x)))
    for part in (hi, lo):
        assert not (_bits(part) & 0x1FFF).any()  # the low 13 mantissa bits are zero
    resid = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    assert (resid <= 2.0 ** -21 * np.abs(x.astype(np.float64))).all()
    assert (np.sign(hi) == np.sign(x)).all()
    # round to nearest, ties away from zero: exactly half a TF32 ulp rounds up in magnitude
    tie = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11], np.float32)
    got = split_tf32(torch.as_tensor(tie))[0].numpy()
    np.testing.assert_array_equal(got, [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -9])


def _b_fragment(packed: np.ndarray, n_out: int, ks: int, nt: int, lane: int):
    """(b0, b1) hi and lo that thread ``lane`` holds of the 8 x 8 B tile
    (ks, nt) of one packed matrix: rows 8ks + 2t, 8ks + 2t + 1 at column 8nt + g."""
    at = ((ks * (n_out // 8) + nt) * 32 + lane) * 4
    return packed[at: at + 4]


def _unpack(packed: np.ndarray, k: int, n: int):
    """Rebuild the (hi, lo) matrices from the fragment order, tile by tile."""
    hi, lo = np.zeros((k, n), np.float32), np.zeros((k, n), np.float32)
    for ks in range(k // 8):
        for nt in range(n // 8):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                b0h, b1h, b0l, b1l = _b_fragment(packed, n, ks, nt, lane)
                rows, col = (8 * ks + 2 * t, 8 * ks + 2 * t + 1), 8 * nt + g
                hi[rows, col], lo[rows, col] = (b0h, b1h), (b0l, b1l)
    return hi, lo


@pytest.mark.parametrize("f", [16, 128])
def test_pack_tf32_weights_round_trips(f):
    wts = _weights(f)
    packed = pack_tf32_weights(wts).numpy()
    assert packed.dtype == np.float32 and packed.size == 2 * wts.mats.numel() == 30 * f * f
    off = 0
    for m in _matrices(wts):
        k, n = m.shape
        hi, lo = _unpack(packed[2 * off: 2 * (off + k * n)], k, n)
        want_hi, want_lo = (t.numpy() for t in split_tf32(m))
        np.testing.assert_array_equal(hi, want_hi)
        np.testing.assert_array_equal(lo, want_lo)
        np.testing.assert_allclose(hi.astype(np.float64) + lo, m.numpy(), rtol=2.0 ** -21, atol=0)
        off += k * n  # each matrix at twice its offset of the row-major buffer
    assert 2 * off == packed.size


def test_tf32_packing_is_for_f32_weights_only():
    with pytest.raises(ValueError, match="f32 weights"):
        pack_tf32_weights(_weights(16, BF16))
    with pytest.raises(ValueError, match="multiples of 8"):
        pack_tf32_weights(_weights(12))
    bf = _weights(16, BF16)
    assert with_tf32_weights(bf) is bf and bf.mma is None
    wts = with_tf32_weights(_weights(16))
    assert torch.equal(wts.mma, pack_tf32_weights(wts))
    assert with_tf32_weights(wts) is wts


def _swz(row: int, col: int, ld: int) -> int:
    """pair_layer_tf32x3.cu::swz: 16-byte chunk c of row r lives at chunk c ^ 2 (r & 3)."""
    return row * ld + ((((col >> 2) ^ ((row & 3) << 1)) << 2) | (col & 3))


def test_swizzle_is_a_bijection_without_bank_conflicts():
    for ld in (128, 256):
        assert {_swz(r, c, ld) for r in range(TC_ROWS) for c in range(ld)} == set(range(TC_ROWS * ld))
        for ks in range(ld // 8):
            for half in (0, 1):  # one 8-byte fragment access, a half-warp at a time
                banks = {(_swz(g, 8 * ks + 2 * t + e, ld)) % 32
                         for g in range(4 * half, 4 * half + 4) for t in range(4) for e in (0, 1)}
                assert len(banks) == 32
        for r in range(8):  # a row's 16-byte accesses, 8 lanes at a time
            for l0 in range(0, ld // 4, 8):
                banks = {_swz(r, 4 * l + e, ld) % 32 for l in range(l0, l0 + 8) for e in range(4)}
                assert len(banks) == 32


def _walk(a: np.ndarray, packed: np.ndarray, n_out: int, terms: str) -> np.ndarray:
    """One 64-row tile times a packed matrix as the kernel's 8 warps walk
    it: warp w owns rows 32 (w % 2) .., n-tiles 4 (w // 2) .. of each F-wide
    chunk; per k-step each thread's A fragment is read from the swizzled tile
    (rows g, g + 8 at columns 8ks + 2t, + 1), split into hi = rna(a) and
    lo = rna(a − hi), and
    each mma.m16n8k8 is rebuilt from the fragments in the PTX layout
    (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g),
    b1 (t + 4, g); f32 sums). ``terms`` "3x" issues lo·b_hi, hi·b_lo, hi·b_hi
    into a fresh accumulator per two k-steps, added to the running sum in f32;
    "1x" only hi·b_hi (plain TF32)."""
    rows, k = a.shape
    tile = np.zeros(rows * k, np.float32)
    for r in range(rows):
        for c in range(k):
            tile[_swz(r, c, k)] = a[r, c]
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    out = np.zeros((rows, n_out), np.float32)
    for warp in range(8):
        row0, cq = 32 * (warp % 2), warp // 2
        for chunk in range(n_out // 128):
            for rt in range(2):
                r = row0 + 16 * rt
                for p in range(4):
                    nt = 16 * chunk + 4 * cq + p
                    acc = np.zeros((16, 8), np.float32)
                    for ks in range(k // 8):
                        col = 8 * ks + 2 * t
                        frag = np.stack([tile[[_swz(r + gg, cc, k) for gg, cc in zip(g + dr, col + dc)]]
                                         for dr, dc in ((0, 0), (8, 0), (0, 1), (8, 1))], axis=1)
                        hi, lo = (q.numpy() for q in split_tf32(torch.as_tensor(frag)))
                        bfrag = np.stack([_b_fragment(packed, n_out, ks, nt, ln) for ln in lane])
                        a_log = {}
                        for name, part in (("hi", hi), ("lo", lo)):
                            m = np.zeros((16, 8), np.float32)
                            m[g, t], m[g + 8, t], m[g, t + 4], m[g + 8, t + 4] = part.T
                            a_log[name] = m
                        b_log = {}
                        for name, cols in (("hi", (0, 1)), ("lo", (2, 3))):
                            m = np.zeros((8, 8), np.float32)
                            m[t, g], m[t + 4, g] = bfrag[:, cols[0]], bfrag[:, cols[1]]
                            b_log[name] = m
                        pairs = ([("lo", "hi"), ("hi", "lo"), ("hi", "hi")] if terms == "3x"
                                 else [("hi", "hi")])
                        if ks % 2 == 0:  # a fresh accumulator for two k-steps
                            z = np.zeros((16, 8), np.float32)
                        for an, bn in pairs:
                            z = (z + (a_log[an].astype(np.float64) @ b_log[bn])).astype(np.float32)
                        if ks % 2 == 1:
                            acc = acc + z
                    out[r: r + 16, 8 * nt: 8 * nt + 8] = acc
    return out


def test_fragment_walk_3xtf32_is_f32_accurate_and_1xtf32_is_not():
    """A 64 x 256 tile times a 256 x 128 matrix of normal values: 3xTF32
    within 1e-6 of max |exact| (f64), where f32 FMA sums err at about
    5e-7 and plain TF32 at about 3e-4, past the f32 bar of 2e-5."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((TC_ROWS, 256)).astype(np.float32)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    wp = _pack_tf32_matrix(torch.as_tensor(w)).numpy()
    exact = a.astype(np.float64) @ w.astype(np.float64)
    scale = np.abs(exact).max()
    err3 = np.abs(_walk(a, wp, 128, "3x") - exact).max() / scale
    err1 = np.abs(_walk(a, wp, 128, "1x") - exact).max() / scale
    err32 = np.abs((a @ w) - exact).max() / scale
    assert err3 <= 1e-6, err3
    assert err3 < err32 * 4 and err3 * 100 < err1
    assert err1 > 2e-5, err1


@pytest.mark.parametrize("b", [1, 3, 130])
@pytest.mark.parametrize("n", [2, 5, 19, 29, KERNEL_MAX_N])
def test_tile_plan_covers_every_group_once(b, n):
    plan = tile_plan(b, n)
    assert plan.groups == TC_ROWS // n >= 2 and plan.rows == plan.groups * n <= TC_ROWS
    seen = []
    for cta in range(plan.ctas):
        groups = tile_groups(plan, cta, b, n)
        assert 1 <= len(groups) <= plan.groups
        rows = [q * n + j for q in groups for j in range(n)]
        assert rows == list(range(rows[0], rows[0] + len(rows)))  # contiguous rows of e
        seen += [divmod(q, n) for q in groups]
    assert seen == [(bb, i) for bb in range(b) for i in range(n)]
    assert plan.smem == tc_smem_bytes() == 99_584 <= SMEM_LIMIT
    assert 2 * (plan.smem + 1024) <= 233_472  # two CTAs an SM
    if (b, n) == (128, 19):
        assert plan.ctas == 811


def test_main_path_tile_count():
    plan = tile_plan(128, 19)
    assert (plan.groups, plan.rows, plan.ctas) == (3, 57, 811)


def _layer_inputs(f=16, n=5, b=2, seed=3, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dt=dtype):
        return torch.as_tensor((scale * rng.standard_normal(shape)).astype(np.float32)).to(dt)

    return (t(b, n, 3, scale=0.3, dt=torch.float32), t(b, n, f), t(b, 3, n, f, scale=0.3),
            t(b, n * n, f))


def test_unknown_or_inapplicable_variant_raises():
    base = _layer_inputs()
    wts = with_tf32_weights(_weights(16))
    with pytest.raises(ValueError, match="variant"):
        pair_layer(*base, wts, 10.0, variant="wgmma")
    # "tc" applies at every chain block: f32 chain blocks are B1's 3xTF32
    # kernel, bf16_agg past 4 takes csrc/pair_layer_mma.cu (on the CPU, the
    # plain version)
    for a, r in zip(pair_layer(*base, wts, 10.0, 2, variant="tc"),
                    pair_layer_plain(*base, wts, 10.0)):
        assert torch.equal(a, r)
    base16, w16 = _layer_inputs(dtype=BF16), _weights(16, BF16)
    for a, r in zip(pair_layer(*base16, w16, 10.0, 5, variant="tc"),
                    pair_layer_plain(*base16, w16, 10.0)):
        assert torch.equal(a, r)


@pytest.mark.parametrize("variant,chain_block", [(None, 1), ("tc", 1), ("fma", 1), (None, 2),
                                                 ("fma", 2), ("tc", 4), (None, 5), ("tc", 8)])
def test_cpu_tensors_take_the_plain_version(variant, chain_block):
    """On the CPU every variant is the plain version, bit for bit, and no
    kernel is launched or built."""
    base = _layer_inputs()
    wts = with_tf32_weights(_weights(16))
    before, by_route = dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES)
    out = pair_layer(*base, wts, 10.0, chain_block, variant=variant)
    ref = pair_layer_plain(*base, wts, 10.0)
    assert _build.LAUNCHES == before and _build.ROUTE_LAUNCHES == by_route
    for a, r in zip(out, ref):
        assert a.dtype == r.dtype and torch.equal(a, r)


def test_prepare_packs_f32_layers_once():
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops.pair_layer_kernel import prepare

    torch.manual_seed(0)
    model = CPaiNN(16, 2, n_atoms=5)
    template = graph_template(make_synthetic_molecule(5, seed=0), t_cond=2)
    pm = prepare(model, None, template, None, "cpu")
    assert all(torch.equal(w.mma, pack_tf32_weights(w)) for w in pm.layers)
    # bf16_agg layers carry the bf16 fragment order instead (csrc/pair_layer_mma.cu)
    pmb = prepare(model, None, template, "bf16_agg", "cpu")
    assert all(torch.equal(w.mma, pack_mma_weights(w)) for w in pmb.layers)


def test_launches_are_counted_per_library(monkeypatch):
    """``count_launch`` adds to the kernel's count and to its (kernel, library)
    tally, and records the last library; ``reset_launches`` clears both."""
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    monkeypatch.setattr(_build, "ROUTES", {})
    monkeypatch.setattr(_build, "ROUTE_LAUNCHES", {})
    for lib in ("pair_layer_tf32x3", "pair_layer_tf32x3", "pair_layer"):
        _build.count_launch("pair_layer", lib)
    assert _build.LAUNCHES["pair_layer"] == 3 and _build.ROUTES["pair_layer"] == "pair_layer"
    assert _build.ROUTE_LAUNCHES == {("pair_layer", "pair_layer_tf32x3"): 2,
                                     ("pair_layer", "pair_layer"): 1}
    _build.reset_launches()
    assert not any(_build.LAUNCHES.values()) and _build.ROUTE_LAUNCHES == {}
