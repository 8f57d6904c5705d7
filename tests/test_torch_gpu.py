"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one;
this file imports neither jax nor ti_tpu, so it runs where only PyTorch
is installed:
``python -m pytest --noconftest tests/test_torch_gpu.py -m gpu``
(``--noconftest`` skips tests/conftest.py, which imports JAX).
The random weights are chip_smoke.py's field (``torch_default_weights_``:
PyTorch's default laws, on which a trajectory stays comparable between two
f32 implementations; a fresh model's flax laws make a field whose f32
rounding grows past every sampler bar).
Bars (max |kernel - plain| / max |plain|): 2e-5 in f32 (f32 FMA, or
3xTF32 on the tensor cores, against f32), 2e-2 in bf16_agg (one bf16 rounding may flip where the two sum in
another order).
"""

import pytest
import torch

from torch.func import jvp, vmap

from chip_smoke import torch_default_weights_
from ti_torch.models.cpainn import CPaiNN
from ti_torch.ops import _build
from ti_torch.ops import pallas_kernels as pk
from ti_torch.ops.mlp_block import MLPWeights, mlp_weights
from ti_torch.ops.pair_layer_kernel import (
    MMA_MAX_TILES,
    WidthRefusal,
    mma_smem_bytes,
    mma_tile_plan,
    mma_tiles,
    pack_layer,
    pack_pair_mlps,
    pair_layer,
    pair_layer_plain,
    tc_smem_bytes,
    with_mma_weights,
    with_tf32_weights,
)
from ti_torch.ops.pair_tangent_kernel import pair_tangent, pair_tangent_plain

N, F, B = 19, 128, 6
BARS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _params(n=N):
    model = torch_default_weights_(CPaiNN(F, 1, n_atoms=n))
    return {name: t.detach() for name, t in model.state_dict().items()}


def _layer(dtype, k=0, b=B, N=N):
    w = with_mma_weights(with_tf32_weights(pack_layer(_params(N), 0, F, dtype, "cuda")))
    g = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")).to(dtype)

    x = 0.3 * torch.randn(b, N, 3, generator=g, device="cuda")
    base = (x, rnd(b, N, F), rnd(b, 3, N, F, scale=0.3), rnd(b, N * N, F))
    lanes = (torch.randn(b, k, N, 3, generator=g, device="cuda"), rnd(b, k, N, F, scale=0.1),
             rnd(b, k, 3, N, F, scale=0.1), rnd(b, k, N * N, F, scale=0.1))
    return w, base, lanes


def _rows(*shape, seed=2):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=g, device="cuda")


def _assert_close(outs, refs, dtype):
    for a, r in zip(outs, refs):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert torch.isfinite(a.float()).all()
        err = (a.float() - r.float()).abs().max() / r.float().abs().max()
        assert err.item() <= BARS[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_layer_kernel_matches_plain(dtype):
    _card()
    w, base, _ = _layer(dtype)
    before = _build.LAUNCHES["pair_layer"]
    out = pair_layer(*base, w, 10.0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pair_layer"] == before + 1
    _assert_close(out, pair_layer_plain(*base, w, 10.0), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,chain_block", [(torch.float32, 2), (torch.float32, 3),
                                               (torch.float32, 4), (torch.float32, 5),
                                               (torch.float32, 8), (torch.bfloat16, 2),
                                               (torch.bfloat16, 3), (torch.bfloat16, 4),
                                               (torch.bfloat16, 5), (torch.bfloat16, 8)])
def test_chain_blocked_pair_layer_is_b1(dtype, chain_block):
    """B2 on a batch C does not divide: the result of B1 in the same source
    to the bit (bf16_agg: pair_layer_mma.cu, min(C, 3) row tiles a CTA,
    the last CTA's last tile empty; f32: pair_layer_tf32x3.cu, whose tiles
    C does not change), past csrc/pair_layer.cu's limit of 4 too, and the
    plain version's within the bar."""
    _card()
    w, base, _ = _layer(dtype, b=13)
    bf16 = dtype == torch.bfloat16
    before = dict(_build.LAUNCHES)
    out = pair_layer(*base, w, 10.0, chain_block)
    b1 = pair_layer(*base, w, 10.0)
    torch.cuda.synchronize()
    lib = "pair_layer_mma" if bf16 else "pair_layer_tf32x3"
    assert _build.ROUTES["pair_layer_cb"] == lib and _build.ROUTES["pair_layer"] == lib
    assert _build.LAUNCHES["pair_layer_cb"] == before["pair_layer_cb"] + 1
    assert _build.LAUNCHES["pair_layer"] == before["pair_layer"] + 1
    for a, r in zip(out, b1):
        assert torch.equal(a, r)
    _assert_close(out, pair_layer_plain(*base, w, 10.0), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chain_block", [2, 3, 4])
def test_chain_blocked_pair_layer_fma_matches_plain(dtype, chain_block):
    """B2 as ``variant="fma"`` (csrc/pair_layer.cu, C chains a CTA, the last
    CTA's idle groups on a batch C does not divide) within the bar of the
    plain version."""
    _card()
    w, base, _ = _layer(dtype, b=13)
    before = _build.LAUNCHES["pair_layer_cb"]
    out = pair_layer(*base, w, 10.0, chain_block, variant="fma")
    torch.cuda.synchronize()
    assert _build.ROUTES["pair_layer_cb"] == "pair_layer"
    assert _build.LAUNCHES["pair_layer_cb"] == before + 1
    _assert_close(out, pair_layer_plain(*base, w, 10.0), dtype)


@pytest.mark.gpu
def test_fused_mlp_kernels_match_plain():
    """B4 and B5 at a ragged row count, B4 on the tensor cores, B5 on the
    tensor cores and in f32 FMA at every lane block, B6 at the combine,
    update and readout widths."""
    _card()
    params = _params()
    w = with_tf32_weights(pack_layer(params, 0, F, torch.float32, "cuda"))
    r = 1000 + 7
    in_feat, pe = _rows(r, 2 * F), _rows(r, F, seed=3)
    before = dict(_build.LAUNCHES)
    out = pk.fused_edge_mlp(in_feat, pe, w)
    assert _build.ROUTES["fused_edge_mlp"] == "fused_edge_mlp_tf32x3"
    _assert_close([out], [pk.fused_edge_mlp_reference(in_feat, pe, w.phi, w.w)], torch.float32)
    din, dpe = _rows(6, r, 2 * F, seed=4), _rows(6, r, F, seed=5)
    ref = pk.edge_mlp_jvp_reference(in_feat, pe, din, dpe, w.phi, w.w)
    _assert_close([pk.fused_edge_mlp_jvp(in_feat, pe, din, dpe, w)], [ref], torch.float32)
    for lane_block in (1, 2, 3):
        _assert_close([pk.fused_edge_mlp_jvp(in_feat, pe, din, dpe, w, lane_block, variant="fma")],
                      [ref], torch.float32)
    for name, f_in in (("combine", 4 * F), ("update_0.mlp", 2 * F), ("readout.mlp", F)):
        pack = pk.pack_mlp(mlp_weights(params, name), "cuda")
        x = _rows(r, f_in, seed=6)
        _assert_close([pk.fused_mlp(x, pack)], [pk._mlp_block(x, pack.w)], torch.float32)
    torch.cuda.synchronize()
    got = {k: _build.LAUNCHES[k] - before[k] for k in ("fused_edge_mlp", "fused_edge_mlp_jvp",
                                                        "fused_mlp")}
    assert got == {"fused_edge_mlp": 1, "fused_edge_mlp_jvp": 4, "fused_mlp": 3}


@pytest.mark.gpu
def test_vmapped_lanes_launch_b5_once():
    _card()
    w = with_tf32_weights(pack_layer(_params(), 0, F, torch.float32, "cuda"))
    x, pe, z = _rows(64, 2 * F), _rows(64, F, seed=3), _rows(5, 64, 2 * F, seed=4)
    before = _build.LAUNCHES["fused_edge_mlp_jvp"]
    lanes = vmap(lambda zz: jvp(lambda a: pk.fused_edge_mlp_diff(a, pe, w), (x,), (zz,))[1])(z)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_edge_mlp_jvp"] == before + 1
    assert _build.ROUTES["fused_edge_mlp_jvp"] == "fused_edge_mlp_jvp_tf32x3"
    ref = pk.edge_mlp_jvp_reference(x, pe, z, torch.zeros(5, 64, F, device="cuda"), w.phi, w.w)
    _assert_close([lanes], [ref], torch.float32)


def _jvp_inputs(r, k, seed=2):
    return _rows(r, 2 * F, seed=seed), _rows(r, F, seed=seed + 1), \
        _rows(k, r, 2 * F, seed=seed + 2), _rows(k, r, F, seed=seed + 3)


def _edge_layer(f):
    """A message layer's two MLPs at width ``f`` (random, 1/sqrt(f_in)),
    packed for B4 and B5 with their 3xTF32 split, on the card."""
    g = torch.Generator().manual_seed(f)

    def mlp(f_in):
        def t(*shape):
            return torch.randn(*shape, generator=g) / shape[0] ** 0.5

        return MLPWeights(t(f_in, f), t(f), 1 + 0.1 * t(f), t(f), t(f, f), t(f), 1 + 0.1 * t(f),
                          t(f), t(f, 5 * f), t(5 * f))

    return with_tf32_weights(pack_pair_mlps(mlp(2 * f), mlp(f), torch.float32, "cuda"))


def _edge_rows(f, r, k=0):
    """B4's rows at width ``f`` (in_feat, pe), and with k > 0 B5's lanes."""
    rows = (_rows(r, 2 * f), _rows(r, f, seed=3))
    return rows + ((_rows(k, r, 2 * f, seed=4), _rows(k, r, f, seed=5)) if k else ())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 57, 87])
@pytest.mark.parametrize("r", [5, 65, 11_552])
def test_fused_edge_mlp_jvp_tc_matches_plain(r, k):
    """B5 on the tensor cores (3xTF32) against its plain version: one partial
    tile, a full tile and one row, and the exact node of 32 chains (180.5
    tiles); one lane, 3, and the exact frames at 19 and 29 atoms."""
    _card()
    w = with_tf32_weights(pack_layer(_params(), 0, F, torch.float32, "cuda"))
    args = _jvp_inputs(r, k)
    out = pk.fused_edge_mlp_jvp(*args, w)
    torch.cuda.synchronize()
    assert _build.ROUTES["fused_edge_mlp_jvp"] == "fused_edge_mlp_jvp_tf32x3"
    _assert_close([out], [pk.edge_mlp_jvp_reference(*args, w.phi, w.w)], torch.float32)


@pytest.mark.gpu
def test_fused_edge_mlp_jvp_tc_is_deterministic_and_agrees_with_fma():
    """No atomics: two launches agree to the bit; the f32-FMA kernel on the
    same inputs agrees within the f32 bar (another order of summation)."""
    _card()
    w = with_tf32_weights(pack_layer(_params(), 0, F, torch.float32, "cuda"))
    args = _jvp_inputs(1000 + 7, 6)
    one = pk.fused_edge_mlp_jvp(*args, w)
    two = pk.fused_edge_mlp_jvp(*args, w)
    old = pk.fused_edge_mlp_jvp(*args, w, variant="fma")
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    _assert_close([one], [old], torch.float32)


@pytest.mark.gpu
def test_fused_edge_mlp_jvp_tc_counts_and_refusals():
    """The shared memory and scratch of the wrapper are the kernel's own; a
    layer without its 3xTF32 packing raises on the card (no fallback), and
    so does an unknown variant."""
    import ctypes

    _card()
    for f, name in ((F, "fused_edge_mlp_jvp_tf32x3"), (F256, "fused_edge_mlp_jvp_tf32x3_f256")):
        lib = _build.load(name)
        lib.fused_edge_mlp_jvp_tf32x3_smem_bytes.restype = ctypes.c_ulonglong
        assert lib.fused_edge_mlp_jvp_tf32x3_smem_bytes() == pk.tc_jvp_smem_bytes(f)
        assert lib.fused_edge_mlp_jvp_tf32x3_scratch_floats() == pk.tc_jvp_scratch(f)
        assert lib.fused_edge_mlp_jvp_tf32x3_rows() == pk.edge_tile_rows(f)
    assert pk.tc_jvp_scratch(F) == pk.TC_JVP_SCRATCH
    w = pack_layer(_params(), 0, F, torch.float32, "cuda")
    args = _jvp_inputs(70, 2)
    with pytest.raises(ValueError, match="with_tf32_weights"):
        pk.fused_edge_mlp_jvp(*args, w)
    with pytest.raises(ValueError, match="variant"):
        pk.fused_edge_mlp_jvp(*args, with_tf32_weights(w), variant="mma")
    before = dict(_build.LAUNCHES)
    for f in (64, 32):  # built by no library: refused, nothing launched
        w, rows = _edge_layer(f), _edge_rows(f, 70, k=2)
        with pytest.raises(WidthRefusal, match=f"fused_edge_mlp_jvp_tf32x3 is built for F=128, "
                                               f"got F={f}"):
            pk.fused_edge_mlp_jvp(*rows, w)
    with pytest.raises(WidthRefusal, match="fused_edge_mlp_jvp is built for F=128, got F=256"):
        pk.fused_edge_mlp_jvp(*_edge_rows(F256, 70, k=2), _edge_layer(F256), variant="fma")
    assert _build.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("r", [5, 65, 1007, 11_552, 46_208])
def test_fused_edge_mlp_tc_matches_plain(r):
    """B4 on the tensor cores (3xTF32) against its plain version: one partial
    tile, a tile and one row, a ragged count, the ``dense_fused`` sampler's
    32 chains (180.5 tiles) and the dense grid of 128 chains."""
    _card()
    w = with_tf32_weights(pack_layer(_params(), 0, F, torch.float32, "cuda"))
    in_feat, pe = _rows(r, 2 * F), _rows(r, F, seed=3)
    key = ("fused_edge_mlp", "fused_edge_mlp_tf32x3")
    before = _build.ROUTE_LAUNCHES.get(key, 0)
    out = pk.fused_edge_mlp(in_feat, pe, w)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES[key] == before + 1
    _assert_close([out], [pk.fused_edge_mlp_reference(in_feat, pe, w.phi, w.w)], torch.float32)


@pytest.mark.gpu
def test_fused_edge_mlp_tc_is_deterministic_and_agrees_with_fma():
    """No atomics: two launches agree to the bit; the f32-FMA kernel on the
    same inputs agrees within the f32 bar (another order of summation)."""
    _card()
    w = with_tf32_weights(pack_layer(_params(), 0, F, torch.float32, "cuda"))
    in_feat, pe = _rows(1007, 2 * F), _rows(1007, F, seed=3)
    one = pk.fused_edge_mlp(in_feat, pe, w)
    two = pk.fused_edge_mlp(in_feat, pe, w)
    old = pk.fused_edge_mlp(in_feat, pe, w, variant="fma")
    torch.cuda.synchronize()
    assert _build.ROUTES["fused_edge_mlp"] == "fused_edge_mlp"
    assert torch.equal(one, two)
    _assert_close([one], [old], torch.float32)


@pytest.mark.gpu
def test_fused_edge_mlp_tc_counts_and_refusals():
    """The wrapper's shared-memory and tile-row counts are the kernel's own
    at F = 128 and 256 and the card holds EDGE_CTAS_PER_SM of its CTAs an
    SM at both (so each builds within 128 registers); a layer without its
    3xTF32 packing raises on the card (no fallback), and so does an unknown
    variant; F = 64 and 32, and ``variant="fma"`` at F = 256, are refused
    and launch nothing."""
    import ctypes

    _card()
    for f, name in ((F, "fused_edge_mlp_tf32x3"), (F256, "fused_edge_mlp_tf32x3_f256")):
        lib = _build.load(name)
        lib.fused_edge_mlp_tf32x3_smem_bytes.restype = ctypes.c_ulonglong
        assert lib.fused_edge_mlp_tf32x3_smem_bytes() == pk.tc_edge_smem_bytes(f)
        assert lib.fused_edge_mlp_tf32x3_ctas_per_sm() == pk.EDGE_CTAS_PER_SM
        assert lib.fused_edge_mlp_tf32x3_rows() == pk.edge_tile_rows(f)
    w = pack_layer(_params(), 0, F, torch.float32, "cuda")
    in_feat, pe = _rows(70, 2 * F), _rows(70, F, seed=3)
    with pytest.raises(ValueError, match="with_tf32_weights"):
        pk.fused_edge_mlp(in_feat, pe, w)
    with pytest.raises(ValueError, match="variant"):
        pk.fused_edge_mlp(in_feat, pe, with_tf32_weights(w), variant="mma")
    before = dict(_build.LAUNCHES)
    for f in (64, 32):
        with pytest.raises(WidthRefusal, match=f"fused_edge_mlp_tf32x3 is built for F=128, "
                                               f"got F={f}"):
            pk.fused_edge_mlp(*_edge_rows(f, 70), _edge_layer(f))
    with pytest.raises(WidthRefusal, match="fused_edge_mlp is built for F=128, got F=256"):
        pk.fused_edge_mlp(*_edge_rows(F256, 70), _edge_layer(F256), variant="fma")
    assert _build.LAUNCHES == before


_MLP_SHAPES = [("combine", 4 * F), ("latent combine", 3 * F), ("update_0.mlp", 2 * F),
               ("readout.mlp", F)]


def _mlp_pack(name, f_in):
    """B6's packing of one MLP of the model: the latent combine (3F -> F) is
    the combine with the first 3F rows of its first matrix."""
    w = mlp_weights(_params(), "combine" if name == "latent combine" else name)
    if name == "latent combine":
        w = w._replace(w1=w.w1[:f_in])
    return pk.pack_mlp(w, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name,f_in", _MLP_SHAPES)
def test_fused_mlp_tc_matches_plain(name, f_in):
    """B6 on the tensor cores (csrc/fused_mlp_tf32x3.cu, the default) at the
    node rows of 128 chains (2432) and at ragged row counts: one row, part
    of a tile, a tile and one row, 4,097."""
    _card()
    pack = _mlp_pack(name, f_in)
    for r in (1, 5, 15, 16, 17, 63, 64, 65, 2432, 4097):
        x = _rows(r, f_in, seed=r)
        out = pk.fused_mlp(x, pack)
        torch.cuda.synchronize()
        assert _build.ROUTES["fused_mlp"] == "fused_mlp_tf32x3"
        _assert_close([out], [pk._mlp_block(x, pack.w)], torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("name,f_in", _MLP_SHAPES)
def test_fused_mlp_tc_is_deterministic_and_agrees_with_fma(name, f_in):
    """Two launches on the same inputs agree to the bit (no atomics), and
    the tensor-core kernel agrees with the f32-FMA one at the f32 bar."""
    _card()
    pack = _mlp_pack(name, f_in)
    x = _rows(2432, f_in, seed=9)
    first, second = pk.fused_mlp(x, pack), pk.fused_mlp(x, pack)
    old = pk.fused_mlp(x, pack, variant="fma")
    torch.cuda.synchronize()
    assert _build.ROUTES["fused_mlp"] == "fused_mlp"
    assert torch.equal(first, second)
    _assert_close([first], [old], torch.float32)


@pytest.mark.gpu
def test_fused_mlp_tc_counts_and_refusals():
    """The wrapper's shared-memory and row counts are the kernel's own, and
    the card holds MLP_CTAS_PER_SM of its CTAs an SM (so it builds within
    128 registers), every CTA of 2432 rows at once; a pack without
    its 3xTF32 packing, or of another hidden width, raises on the card (no
    fallback), and so does an unknown variant; an f_in that is not a
    multiple of the k-step is padded in the packing, not refused; both
    variants refuse one that is not a multiple of 4, and "tc" an x whose
    rows do not start 16-byte aligned."""
    import ctypes

    from ti_torch.ops.mlp_block import MLPWeights

    _card()
    for f, name in ((F, "fused_mlp_tf32x3"), (F256, "fused_mlp_tf32x3_f256")):
        lib = _build.load(name)
        lib.fused_mlp_tf32x3_smem_bytes.restype = ctypes.c_ulonglong
        assert lib.fused_mlp_tf32x3_smem_bytes() == pk.tc_mlp_smem_bytes(f)
        assert lib.fused_mlp_tf32x3_rows() == pk.MLP_ROWS
        assert lib.fused_mlp_tf32x3_ctas_per_sm() == pk.mlp_ctas_per_sm(f)
    assert pk.mlp_ctas_per_sm(F) == pk.MLP_CTAS_PER_SM
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert pk.MLP_CTAS_PER_SM * sms >= pk.mlp_plan(2432, 2 * F, 3 * F).ctas
    assert pk.mlp_ctas_per_sm(F256) * sms >= pk.mlp_plan(16 * 29, 2 * F256, 3 * F256, F256).ctas
    pack = _mlp_pack("update_0.mlp", 2 * F)
    x = _rows(70, 2 * F)
    with pytest.raises(ValueError, match="no 3xTF32 packing"):
        pk.fused_mlp(x, pack._replace(tc=None))
    with pytest.raises(ValueError, match="3xTF32 MLP weights must be"):
        pk.fused_mlp(x, pack._replace(tc=pack.tc[:-4]))
    with pytest.raises(ValueError, match="variant"):
        pk.fused_mlp(x, pack, variant="mma")
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g) / shape[0] ** 0.5

    def mlp(f_in, f, f_out):
        return MLPWeights(rnd(f_in, f), rnd(f), 1 + rnd(f), rnd(f), rnd(f, f), rnd(f), 1 + rnd(f),
                          rnd(f), rnd(f, f_out), rnd(f_out))

    with pytest.raises(ValueError, match="hidden width F=128"):
        pk.fused_mlp(_rows(70, 64), pk.pack_mlp(mlp(64, 64, 64), "cuda"))
    with pytest.raises(WidthRefusal, match="fused_mlp takes hidden width F=128, got F=256"):
        pk.fused_mlp(_rows(70, F256), pk.pack_mlp(mlp(F256, F256, 2), "cuda"), variant="fma")
    for f_in in (20, 36):
        odd = pk.pack_mlp(mlp(f_in, F, 3), "cuda")
        x = _rows(70, f_in, seed=f_in)
        _assert_close([pk.fused_mlp(x, odd)], [pk._mlp_block(x, odd.w)], torch.float32)
    with pytest.raises(ValueError, match="16-byte"):
        pk.fused_mlp(_rows(70 * f_in + 1)[1:].view(70, f_in), odd)  # 4 bytes past
    odd = pk.pack_mlp(mlp(130, F, 3), "cuda")
    for variant in ("tc", "fma"):
        with pytest.raises(ValueError, match="multiple of 4"):
            pk.fused_mlp(_rows(70, 130), odd, variant=variant)


@pytest.mark.gpu
def test_fused_velocity_fn_takes_b4_on_the_tensor_cores():
    """Every B4 launch of a ``fused_velocity_fn`` forward (one a layer)
    comes from fused_edge_mlp_tf32x3 and every B6 launch (combine, one
    update a layer, readout) from fused_mlp_tf32x3, and the forward agrees
    with ``dense_velocity_fn`` (rtol 1e-4, atol 1e-5)."""
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.cpainn import state_of
    from ti_torch.models.cpainn_dense import dense_velocity_fn
    from ti_torch.models.cpainn_fused import fused_velocity_fn

    _card()
    model = torch_default_weights_(CPaiNN(F, 2, n_atoms=N))
    template = graph_template(make_synthetic_molecule(N, seed=0), t_cond=2)
    xs = 0.1 * _rows(4, N, 3, seed=8)
    xs = xs - xs.mean(dim=1, keepdim=True)
    temps = torch.tensor([[1000.0, 300.0]], device="cuda").expand(4, 2)
    fused = fused_velocity_fn(model, None, template, device="cuda")
    p = {k: t.detach().to("cuda") for k, t in state_of(model, None).items()}
    _build.reset_launches()
    v = fused(xs, 0.5, temps)
    torch.cuda.synchronize()
    routes = {key: n for key, n in _build.ROUTE_LAUNCHES.items() if n}
    assert routes == {("fused_edge_mlp", "fused_edge_mlp_tf32x3"): 2,
                      ("fused_mlp", "fused_mlp_tf32x3"): 4}
    assert _build.LAUNCHES["fused_edge_mlp"] == 2 and _build.LAUNCHES["fused_mlp"] == 4
    with torch.no_grad():
        ref = dense_velocity_fn(model, p, template)(xs, 0.5, temps)
    assert torch.allclose(v, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_dense_fused_exact_sampler_takes_b5_on_the_tensor_cores():
    """Every B5 launch of a ``dense_fused`` exact batch comes from
    fused_edge_mlp_jvp_tf32x3 and every B4 launch from
    fused_edge_mlp_tf32x3, and its samples and dlogp agree with the
    ``dense`` sampler's (rtol 1e-4 / atol 1e-5; rtol 1e-3)."""
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of

    _card()
    model = torch_default_weights_(CPaiNN(F, 2, n_atoms=N))
    template = graph_template(make_synthetic_molecule(N, seed=0), t_cond=2)
    x0 = (0.1 * _rows(4, N, 3, seed=8)).cpu().numpy()
    x0 -= x0.mean(axis=1, keepdims=True)
    temps = torch.tensor([[1000.0, 300.0]]).expand(4, 2).numpy()
    kw = dict(solver="rk4", n_steps=2, dlogp_quad="gauss", dlogp_quad_points=2,
              steps_per_dispatch=25, divergence="exact", device="cuda")
    outs = []
    for impl in ("dense_fused", "dense"):
        sampler = make_ode_sampler(molecular_v_fn_of(model, None, template, impl=impl,
                                                     device="cuda"), **kw)
        _build.reset_launches()
        outs.append(sampler(x0, temps, torch.Generator(device="cuda").manual_seed(0)))
        torch.cuda.synchronize()
        if impl == "dense_fused":
            routes = {key: n for key, n in _build.ROUTE_LAUNCHES.items() if n}
            assert _build.LAUNCHES["fused_edge_mlp"] > 0
            assert routes == {("fused_edge_mlp_jvp", "fused_edge_mlp_jvp_tf32x3"): 2 * 2,
                              ("fused_edge_mlp", "fused_edge_mlp_tf32x3"):
                                  _build.LAUNCHES["fused_edge_mlp"]}
    fused, dense = outs
    assert torch.allclose(fused.xs, dense.xs, rtol=1e-4, atol=1e-5)
    assert torch.allclose(fused.dlogp, dense.dlogp, rtol=1e-3,
                          atol=1e-3 * dense.dlogp.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3, 130])
@pytest.mark.parametrize("n", [2, 5, 19, 29, 32])
def test_pair_layer_tc_matches_plain(b, n):
    """B1 in f32 on the tensor cores (3xTF32) against its plain version, at
    2..32 atoms (32 down to 2 groups a 64-row tile) and batches whose groups
    do and do not fill the last tile."""
    _card()
    w, base, _ = _layer(torch.float32, b=b, N=n)
    before = _build.LAUNCHES["pair_layer"]
    out = pair_layer(*base, w, 10.0, variant="tc")
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pair_layer"] == before + 1
    assert _build.ROUTES["pair_layer"] == "pair_layer_tf32x3"
    _assert_close(out, pair_layer_plain(*base, w, 10.0), torch.float32)


@pytest.mark.gpu
def test_pair_layer_routes_and_variants_agree():
    """f32 takes the 3xTF32 kernel unless ``variant="fma"``, f32 chain blocks
    too; bf16_agg takes pair_layer_mma.cu, each launch counted under its
    library; "tc" and "fma" agree at the f32 bar."""
    _card()
    w, base, _ = _layer(torch.float32, b=13)
    _build.reset_launches()
    tc = pair_layer(*base, w, 10.0)
    assert _build.ROUTES["pair_layer"] == "pair_layer_tf32x3"
    fma = pair_layer(*base, w, 10.0, variant="fma")
    assert _build.ROUTES["pair_layer"] == "pair_layer"
    torch.cuda.synchronize()
    _assert_close(tc, fma, torch.float32)
    pair_layer(*base, w, 10.0, 2)
    assert _build.ROUTES["pair_layer_cb"] == "pair_layer_tf32x3"
    wb, bb, _ = _layer(torch.bfloat16, b=13)
    pair_layer(*bb, wb, 10.0)
    assert _build.ROUTES["pair_layer"] == "pair_layer_mma"
    pair_layer(*bb, wb, 10.0, 4)
    assert _build.ROUTES["pair_layer_cb"] == "pair_layer_mma"
    assert _build.ROUTE_LAUNCHES == {("pair_layer", "pair_layer_tf32x3"): 1,
                                     ("pair_layer", "pair_layer"): 1,
                                     ("pair_layer_cb", "pair_layer_tf32x3"): 1,
                                     ("pair_layer", "pair_layer_mma"): 1,
                                     ("pair_layer_cb", "pair_layer_mma"): 1}


@pytest.mark.gpu
def test_pair_layer_tc_is_deterministic():
    """Two launches on the same inputs agree to the bit (no atomics)."""
    _card()
    w, base, _ = _layer(torch.float32, b=130)
    first = pair_layer(*base, w, 10.0)
    second = pair_layer(*base, w, 10.0)
    torch.cuda.synchronize()
    for a, r in zip(first, second):
        assert torch.equal(a, r)


@pytest.mark.gpu
def test_pair_layer_tc_refusals_and_smem_count():
    import ctypes

    _card()
    w, base, _ = _layer(torch.float32)
    b1 = pair_layer(*base, w, 10.0)
    for a, r in zip(pair_layer(*base, w, 10.0, 2, variant="tc"), b1):  # f32 chain blocks: B1's kernel
        assert torch.equal(a, r)
    assert _build.ROUTES["pair_layer_cb"] == "pair_layer_tf32x3"
    wb, bb, _ = _layer(torch.bfloat16)
    b1 = pair_layer(*bb, wb, 10.0)
    for a, r in zip(pair_layer(*bb, wb, 10.0, 5, variant="tc"), b1):  # bf16_agg past 4 as well
        assert torch.equal(a, r)
    assert _build.ROUTES["pair_layer_cb"] == "pair_layer_mma"
    with pytest.raises(ValueError, match="with_tf32_weights"):
        pair_layer(*base, w._replace(mma=None), 10.0)
    with pytest.raises(ValueError, match="3xTF32 weights must be"):
        pair_layer(*base, w._replace(mma=w.mma[:-4]), 10.0)
    big = torch.zeros(1, 33, 3, device="cuda")
    with pytest.raises(ValueError, match="2..32 atoms, got 33"):
        pair_layer(big, *base[1:], w, 10.0)
    lib = _build.load("pair_layer_tf32x3")
    lib.pair_layer_tf32x3_smem_bytes.restype = ctypes.c_ulonglong
    assert lib.pair_layer_tf32x3_smem_bytes() == tc_smem_bytes()


@pytest.mark.gpu
@pytest.mark.parametrize("chain_block", [1, 2, 3, 4])
@pytest.mark.parametrize("b,n", [(128, 19), (130, 19), (130, 29), (3, 2), (5, 32)])
def test_pair_layer_mma_matches_plain(b, n, chain_block):
    """B1 (C = 1) and B2 in bf16_agg on the tensor cores against the plain
    version: the main path's 128 chains, 130 chains whose groups do not fill
    the last tile (19 and 29 atoms, 3 and 2 groups a tile), 32 groups a tile
    (2 atoms) and 2 (32 atoms)."""
    _card()
    w, base, _ = _layer(torch.bfloat16, b=b, N=n)
    out = pair_layer(*base, w, 10.0, chain_block)
    torch.cuda.synchronize()
    assert _build.ROUTES["pair_layer" if chain_block == 1 else "pair_layer_cb"] == "pair_layer_mma"
    _assert_close(out, pair_layer_plain(*base, w, 10.0), torch.bfloat16)


@pytest.mark.gpu
def test_pair_layer_mma_is_deterministic_and_b2_is_b1():
    """Two launches on the same inputs agree to the bit, and every chain
    block gives B1's outputs to the bit (no atomics, one order of sums)."""
    _card()
    w, base, _ = _layer(torch.bfloat16, b=130)
    first = pair_layer(*base, w, 10.0)
    for c in (1, 2, 3, 4):
        again = pair_layer(*base, w, 10.0, c)
        torch.cuda.synchronize()
        for a, r in zip(again, first):
            assert torch.equal(a, r)


@pytest.mark.gpu
def test_pair_layer_mma_variants_refusals_and_counts():
    """The tensor-core kernel against the f32-FMA one on the same inputs (the
    same rounding sites, another order of sums: bar 2e-2); what the wrapper
    refuses; the shared memory and CTAs the CUDA source counts against the
    tile plan."""
    import ctypes

    _card()
    w, base, _ = _layer(torch.bfloat16, b=13)
    new = pair_layer(*base, w, 10.0, variant="tc")
    old = pair_layer(*base, w, 10.0, variant="fma")
    torch.cuda.synchronize()
    _assert_close(new, old, torch.bfloat16)
    with pytest.raises(ValueError, match="with_mma_weights"):
        pair_layer(*base, w._replace(mma=None), 10.0)
    with pytest.raises(ValueError, match="fragment-order weights must be"):
        pair_layer(*base, w._replace(mma=w.mma[:-8]), 10.0, 2)
    with pytest.raises(ValueError, match="cannot launch"):  # csrc/pair_layer.cu takes C <= 4
        pair_layer(*base, w, 10.0, 5, variant="fma")
    lib = _build.load("pair_layer_mma")
    lib.pair_layer_mma_smem_bytes.restype = ctypes.c_ulonglong
    lib.pair_layer_mma_ctas.restype = ctypes.c_longlong
    assert lib.pair_layer_mma_max_tiles() == MMA_MAX_TILES
    for c in (1, 2, 3, 4):
        assert lib.pair_layer_mma_smem_bytes(mma_tiles(c)) == mma_smem_bytes(c)
        for b, n in ((128, 19), (130, 29), (8192, 19), (3, 2)):
            assert lib.pair_layer_mma_ctas(b, n, mma_tiles(c)) == mma_tile_plan(b, n, c).ctas


F256 = 256  # the 10506 profile's width: B1 on the tensor cores (pair_layer_mma_f256, pair_layer_tf32x3_f256)


def _layer256(dtype, b, n=29, k=0):
    """One message layer at F = 256 (chip_smoke.py's field laws) and its
    inputs; k > 0 adds B3's lanes."""
    model = torch_default_weights_(CPaiNN(F256, 1, n_atoms=n))
    params = {name: t.detach() for name, t in model.state_dict().items()}
    w = with_mma_weights(with_tf32_weights(pack_layer(params, 0, F256, dtype, "cuda")))
    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")).to(dtype)

    x = 0.3 * torch.randn(b, n, 3, generator=g, device="cuda")
    base = (x, rnd(b, n, F256), rnd(b, 3, n, F256, scale=0.3), rnd(b, n * n, F256))
    lanes = (torch.randn(b, k, n, 3, generator=g, device="cuda"), rnd(b, k, n, F256, scale=0.1),
             rnd(b, k, 3, n, F256, scale=0.1), rnd(b, k, n * n, F256, scale=0.1))
    return w, base, lanes


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(16, 29), (128, 29), (13, 29), (7, 19), (3, 2), (5, 32)])
def test_pair_layer_mma_f256_matches_plain(b, n):
    """B1 in bf16_agg at F = 256 (pair_layer_mma_f256, one 64-row tile a CTA
    of 16 warps) against its plain version: the 10506 molecule's 29 atoms
    at the profile's 16 chains and at 128, 13 chains (the last tile holds one
    of its two groups), 19 atoms, 32 groups a tile (2 atoms) and 2 (32
    atoms). Two launches agree to the bit, and B2 at chain_block 2, 3, 4
    and 8 is B1's launch at this width, to the bit."""
    _card()
    w, base, _ = _layer256(torch.bfloat16, b, n)
    before = dict(_build.ROUTE_LAUNCHES)
    out = pair_layer(*base, w, 10.0)
    torch.cuda.synchronize()
    key = ("pair_layer", "pair_layer_mma_f256")
    assert _build.ROUTE_LAUNCHES[key] == before.get(key, 0) + 1
    _assert_close(out, pair_layer_plain(*base, w, 10.0), torch.bfloat16)
    for c in (1, 2, 3, 4, 8):
        again = pair_layer(*base, w, 10.0, c)
        torch.cuda.synchronize()
        assert _build.ROUTES["pair_layer" if c == 1 else "pair_layer_cb"] == "pair_layer_mma_f256"
        for a, r in zip(again, out):
            assert torch.equal(a, r)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(16, 29), (128, 29), (13, 29), (130, 19), (3, 2), (5, 32)])
def test_pair_layer_tf32x3_f256_matches_plain(b, n):
    """B1 in f32 at F = 256 (pair_layer_tf32x3_f256: the 3xTF32 kernel with
    16 warps a CTA) against its plain version at the f32 bar, 2e-5 of max
    |plain|: the 10506 molecule at 16 and 128 chains, a ragged last tile (13
    chains; 130 at 19 atoms), 32 groups a tile (2 atoms) and 2 (32 atoms).
    The library's shared memory, threads and CTAs an SM are the wrapper's
    reckoning (197,888 bytes, 512 threads, one CTA); two launches agree to
    the bit, and B2 at chain_block 2 and 4 is B1's launch, to the bit."""
    import ctypes

    from ti_torch.ops.pair_layer_kernel import tc_smem_bytes, tc_threads, tile_plan

    _card()
    lib = _build.load("pair_layer_tf32x3_f256")
    lib.pair_layer_tf32x3_smem_bytes.restype = ctypes.c_ulonglong
    assert lib.pair_layer_tf32x3_smem_bytes() == tc_smem_bytes(F256) == 197_888
    assert tile_plan(b, n, F256).smem == tc_smem_bytes(F256)
    assert lib.pair_layer_tf32x3_threads() == tc_threads(F256) == 512
    assert lib.pair_layer_tf32x3_ctas_per_sm() == 1
    w, base, _ = _layer256(torch.float32, b, n)
    before = dict(_build.ROUTE_LAUNCHES)
    out = pair_layer(*base, w, 10.0)
    torch.cuda.synchronize()
    key = ("pair_layer", "pair_layer_tf32x3_f256")
    assert _build.ROUTE_LAUNCHES[key] == before.get(key, 0) + 1
    _assert_close(out, pair_layer_plain(*base, w, 10.0), torch.float32)
    for c in (1, 2, 4):
        again = pair_layer(*base, w, 10.0, c)
        torch.cuda.synchronize()
        assert _build.ROUTES["pair_layer" if c == 1 else "pair_layer_cb"] == \
            "pair_layer_tf32x3_f256"
        for a, r in zip(again, out):
            assert torch.equal(a, r)


@pytest.mark.gpu
def test_pair_layer_f256_refusals_and_counts():
    """At F = 256 the bf16_agg library's tile count, shared memory and CTAs
    are the wrapper's (one 132,352-byte tile a CTA); ``variant="fma"`` of B1
    and of B3 and B4 refuse the width on the card, naming the routes that
    take it, and launch nothing (B1 in f32 runs:
    test_pair_layer_tf32x3_f256_matches_plain; B3 on the tensor cores:
    test_pair_tangent_f256_matches_plain; B4 on the tensor cores:
    test_fused_edge_mlp_f256_matches_plain)."""
    import ctypes

    from ti_torch.ops.pair_layer_kernel import mma_max_tiles, mma_tile_bytes

    _card()
    lib = _build.load("pair_layer_mma_f256")
    lib.pair_layer_mma_smem_bytes.restype = ctypes.c_ulonglong
    lib.pair_layer_mma_ctas.restype = ctypes.c_longlong
    assert lib.pair_layer_mma_max_tiles() == mma_max_tiles(F256) == 1
    assert lib.pair_layer_mma_smem_bytes(1) == mma_tile_bytes(F256) == 132_352
    for c in (1, 2, 4):
        assert mma_smem_bytes(c, F256) == 132_352
        for b, n in ((16, 29), (128, 29), (13, 29), (3, 2)):
            assert lib.pair_layer_mma_ctas(b, n, mma_tiles(c, F256)) == \
                mma_tile_plan(b, n, c, F256).ctas
    w16, base16, lanes16 = _layer256(torch.bfloat16, 4, k=2)
    w32, base32, lanes32 = _layer256(torch.float32, 4, k=2)
    before = dict(_build.LAUNCHES)
    route = "got F=256; F = 64, 128 and 256 run in B1, B2 and B3 on the tensor cores"
    with pytest.raises(ValueError, match="pair_layer is built for F=128, " + route):
        pair_layer(*base32, w32, 10.0, variant="fma")
    with pytest.raises(ValueError, match="pair_layer is built for F=128, " + route):
        pair_layer(*base16, w16, 10.0, variant="fma")
    with pytest.raises(ValueError, match="pair_tangent is built for F=128, " + route):
        pair_tangent(*base32, *lanes32, w32, 10.0, variant="fma")
    with pytest.raises(ValueError, match="takes f32 weights"):
        pair_tangent(*base16, *lanes16, w16, 10.0, variant="fma")
    x, s = base32[0], base32[1]
    rows = s.reshape(-1, F256)
    with pytest.raises(ValueError, match="fused_edge_mlp is built for F=128, " + route):
        pk.fused_edge_mlp(torch.cat([rows, rows], dim=-1), rows, w32, variant="fma")
    assert _build.LAUNCHES == before


_BF16_CASES = [(torch.bfloat16, k, lane_block, b, "mma")
               for (k, lane_block) in ((8, 4), (16, 4), (6, 2), (3, 1)) for b in (B, 130)]
_LIBS = {(torch.bfloat16, "mma"): "pair_tangent_mma", (torch.float32, "mma"): "pair_tangent_tf32x3",
         (torch.float32, "fma"): "pair_tangent"}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,k,lane_block,b,variant",
                         [(torch.float32, 3, 1, B, "mma"), (torch.float32, 3, 1, B, "fma")]
                         + _BF16_CASES)
def test_pair_tangent_kernel_matches_plain(dtype, k, lane_block, b, variant):
    """B3 against its plain version: bf16_agg on the tensor cores at batches
    that are and are not multiples of anything; f32 on the tensor cores
    (3xTF32, ``"mma"``) and the f32-FMA kernel (``"fma"``)."""
    _card()
    w, base, lanes = _layer(dtype, k, b)
    before = _build.LAUNCHES["pair_tangent"]
    out = pair_tangent(*base, *lanes, w, 10.0, lane_block, variant=variant)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pair_tangent"] == before + 1
    assert _build.ROUTES["pair_tangent"] == _LIBS[dtype, variant]
    _assert_close(out, pair_tangent_plain(*base, *lanes, w, 10.0, lane_block), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 7, 16, 17, 32])
def test_pair_tangent_mma_other_atom_counts(n):
    """The tensor-core kernel where the 32-row tile has no padding (32 atoms),
    one empty row tile (16 and fewer) and a ragged second one (17)."""
    _card()
    w, base, lanes = _layer(torch.bfloat16, 4, 3, N=n)
    out = pair_tangent(*base, *lanes, w, 10.0, 4)
    torch.cuda.synchronize()
    _assert_close(out, pair_tangent_plain(*base, *lanes, w, 10.0, 4), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,b", [(19, 57, 3), (19, 16, 130), (29, 5, 7), (32, 1, 2), (5, 7, 2),
                                   (2, 40, 3)])
def test_pair_tangent_tf32x3_matches_plain(n, k, b):
    """B3 in f32 on the tensor cores against its plain version: the exact
    frame (K = 3N, 19 full tiles of 3 lanes), partial last tiles (K = 16, 5),
    2 lanes a tile (29 and 32 atoms), one lane, and 12 and 32 lanes a tile
    (5 and 2 atoms)."""
    _card()
    w, base, lanes = _layer(torch.float32, k, b, N=n)
    out = pair_tangent(*base, *lanes, w, 10.0)
    torch.cuda.synchronize()
    assert _build.ROUTES["pair_tangent"] == "pair_tangent_tf32x3"
    _assert_close(out, pair_tangent_plain(*base, *lanes, w, 10.0, 1), torch.float32)


@pytest.mark.gpu
def test_pair_tangent_tf32x3_is_deterministic():
    """No atomics: two launches on the same inputs agree to the bit."""
    _card()
    w, base, lanes = _layer(torch.float32, 16, 5)
    one = pair_tangent(*base, *lanes, w, 10.0)
    two = pair_tangent(*base, *lanes, w, 10.0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, q) for a, q in zip(one, two))


@pytest.mark.gpu
def test_pair_tangent_smem_count_is_the_kernels_own():
    """``smem_bytes`` and ``tf32_smem_bytes`` of the wrapper, and the lanes a
    tile of ``lane_tile_plan``, against what the CUDA sources export."""
    import ctypes

    from ti_torch.ops.pair_tangent_kernel import lane_tile_plan, smem_bytes, tf32_smem_bytes

    _card()
    lib = _build.load("pair_tangent_mma")
    lib.pair_tangent_mma_smem_bytes.restype = ctypes.c_ulonglong
    for lane_block in (1, 2, 4):
        assert lib.pair_tangent_mma_smem_bytes(lane_block) == smem_bytes(True, lane_block)
    lib = _build.load("pair_tangent_tf32x3")
    lib.pair_tangent_tf32x3_smem_bytes.restype = ctypes.c_ulonglong
    assert lib.pair_tangent_tf32x3_smem_bytes() == tf32_smem_bytes()
    for n in (2, 5, 19, 29, 32):
        assert lib.pair_tangent_tf32x3_lanes(n) == lane_tile_plan(n, 57).lanes
    # the F = 256 builds: lane blocks 1, 2 and the refused 4; 32-row lane tiles;
    # the scratch the wrapper allocates
    from ti_torch.ops.pair_tangent_kernel import tf32_scratch_floats

    lib = _build.load("pair_tangent_mma_f256")
    lib.pair_tangent_mma_smem_bytes.restype = ctypes.c_ulonglong
    for lane_block in (1, 2, 4):
        assert lib.pair_tangent_mma_smem_bytes(lane_block) == smem_bytes(True, lane_block, F256)
    lib = _build.load("pair_tangent_tf32x3_f256")
    lib.pair_tangent_tf32x3_smem_bytes.restype = ctypes.c_ulonglong
    lib.pair_tangent_tf32x3_scratch_floats.restype = ctypes.c_ulonglong
    assert lib.pair_tangent_tf32x3_smem_bytes() == tf32_smem_bytes(F256) == 169_856
    for n in (2, 5, 16, 29, 32):
        assert lib.pair_tangent_tf32x3_lanes(n) == lane_tile_plan(n, 87, F256).lanes
        assert lib.pair_tangent_tf32x3_scratch_floats(n) == tf32_scratch_floats(n, F256)


# B3 at F = 256 (chip_smoke.py phase 21(b)): the 10506 node shape (16
# chains, 29 atoms, K = 32; f32 also at the exact frame K = 87), 17 chains,
# 32 and 17 atoms, K = 6 at lane blocks 2 and 1, partial last lane tiles
_F256_CASES = [(torch.bfloat16, 16, 29, 32, None), (torch.bfloat16, 17, 29, 8, None),
               (torch.bfloat16, 3, 32, 4, None), (torch.bfloat16, 3, 17, 4, None),
               (torch.bfloat16, 3, 29, 6, 2), (torch.bfloat16, 3, 29, 6, 1),
               (torch.float32, 16, 29, 32, None), (torch.float32, 4, 29, 87, None),
               (torch.float32, 17, 29, 8, None), (torch.float32, 3, 32, 4, None),
               (torch.float32, 3, 17, 4, None), (torch.float32, 3, 10, 7, None),
               (torch.float32, 3, 16, 5, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,n,k,lane_block", _F256_CASES)
def test_pair_tangent_f256_matches_plain(dtype, b, n, k, lane_block):
    """B3 at F = 256 against its plain version: bf16_agg from
    pair_tangent_mma_f256 (lane blocks of 1 or 2), f32 from
    pair_tangent_tf32x3_f256 (32-row lane tiles)."""
    _card()
    bf16 = dtype == torch.bfloat16
    w, base, lanes = _layer256(dtype, b, n, k)
    lib = "pair_tangent_mma_f256" if bf16 else "pair_tangent_tf32x3_f256"
    before = _build.ROUTE_LAUNCHES.get(("pair_tangent", lib), 0)
    out = pair_tangent(*base, *lanes, w, 10.0, lane_block)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES[("pair_tangent", lib)] == before + 1
    ref = pair_tangent_plain(*base, *lanes, w, 10.0, lane_block or (2 if bf16 else 1))
    _assert_close(out, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_tangent_f256_is_deterministic(dtype):
    """No atomics at F = 256 either: two launches on the 10506 node shape
    agree to the bit."""
    _card()
    w, base, lanes = _layer256(dtype, 16, 29, 32)
    one = pair_tangent(*base, *lanes, w, 10.0)
    two = pair_tangent(*base, *lanes, w, 10.0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, q) for a, q in zip(one, two))


@pytest.mark.gpu
def test_validate_mdqm9_cli_b3_route_at_f256(tmp_path, capsys):
    """``validate_mdqm9_physics --features 256 --layers 1 --div_impl
    pair_tangent_bf16`` (4 atoms, one epoch of 64 frames a temperature, 1024
    chains, GL-2 nodes): its nodes run B3 from pair_tangent_mma_f256, 2
    nodes x 1 layer, nothing else launches, and its JSON is finite."""
    import json
    import math

    from ti_torch.cli import validate_mdqm9_physics

    _card()
    _build.reset_launches()
    assert validate_mdqm9_physics.main([
        "--features", "256", "--layers", "1", "--epochs", "1", "--frames", "64", "--batch", "32",
        "--eval_steps", "8", "--quad_dlogp", "--div_impl", "pair_tangent_bf16", "--divergence",
        "hutchinson", "--num_probes", "4", "--gl_points", "2", "--out_dir", str(tmp_path)]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _build.route_counts() == {"pair_tangent:pair_tangent_mma_f256": 2}
    assert row["div_impl"] == "pair_tangent_bf16"
    assert all(math.isfinite(v) for v in row.values() if isinstance(v, float))


@pytest.mark.gpu
def test_pair_tangent_variants_agree():
    """B3 in f32: the 3xTF32 tensor-core kernel against the f32-FMA kernel on
    the same inputs (another order of summation; bar 2e-5)."""
    _card()
    w, base, lanes = _layer(torch.float32, 16, 13)
    new = pair_tangent(*base, *lanes, w, 10.0, variant="mma")
    old = pair_tangent(*base, *lanes, w, 10.0, 1, variant="fma")
    torch.cuda.synchronize()
    _assert_close(new, old, torch.float32)


@pytest.mark.gpu
def test_pair_tangent_div_fn_f32_frame_matches_plain():
    """``pair_tangent_div_fn`` in f32 with the full orthogonal frame (K = 3N)
    through B3 on the tensor cores against its ``kernel=False`` twin on the
    same probes (bar 2e-5 of max |plain|)."""
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.ops.pair_tangent_kernel import pair_tangent_div_fn

    _card()
    model = torch_default_weights_(CPaiNN(F, 2, n_atoms=N))
    template = graph_template(make_synthetic_molecule(N, seed=0), t_cond=2)
    xs = 0.1 * _rows(4, N, 3, seed=7)
    temps = torch.tensor([[1000.0, 300.0]], device="cuda").expand(4, 2)
    divs = []
    for kernel in (True, False):
        div_fn = pair_tangent_div_fn(model, None, template, num_probes=3 * N,
                                     probe_mode="orthogonal", device="cuda", kernel=kernel)
        _build.reset_launches()
        divs.append(div_fn(xs, 0.5, temps, torch.Generator(device="cuda").manual_seed(0)))
        torch.cuda.synchronize()
        assert dict(_build.ROUTE_LAUNCHES) == ({("pair_tangent", "pair_tangent_tf32x3"): 2}
                                               if kernel else {})
    _assert_close([divs[0]], [divs[1]], torch.float32)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take():
    _card()
    w, (x, s, v, e), lanes = _layer(torch.float32, 4)
    with pytest.raises(ValueError, match="F=128"):  # F = 32: no library is built for it
        pair_layer(x, s[..., :32].contiguous(), v, e, w, 10.0)
    with pytest.raises(ValueError, match="contiguous"):
        pair_layer(x, s.transpose(0, 1).contiguous().transpose(0, 1), v, e, w, 10.0)
    with pytest.raises(ValueError, match="must be"):
        pair_layer(x, s.to(torch.bfloat16), v, e, w, 10.0)
    with pytest.raises(ValueError, match="lane_block"):
        pair_tangent(x, s, v, e, *lanes, w, 10.0, 3, variant="fma")
    with pytest.raises(ValueError, match="shared memory"):
        pair_tangent(x, s, v, e, *lanes, w, 10.0, 2, variant="fma")
    with pytest.raises(ValueError, match="with_tf32_weights"):
        pair_tangent(x, s, v, e, *lanes, w._replace(mma=None), 10.0)
    wb, (xb, sb, vb, eb), lb = _layer(torch.bfloat16, 8)
    with pytest.raises(ValueError, match="1, 2 or 4"):
        pair_tangent(xb, sb, vb, eb, *lb, wb, 10.0, 8)
    with pytest.raises(ValueError, match="takes f32 weights"):
        pair_tangent(xb, sb, vb, eb, *lb, wb, 10.0, variant="fma")
    with pytest.raises(ValueError, match="must divide"):
        pair_tangent(xb, sb, vb, eb, *lb, wb, 10.0, 3)
    with pytest.raises(ValueError, match="with_mma_weights"):
        pair_tangent(xb, sb, vb, eb, *lb, wb._replace(mma=None), 10.0)
    with pytest.raises(ValueError, match="fragment-order weights must be"):
        pair_tangent(xb, sb, vb, eb, *lb, wb._replace(mma=wb.mma[:-8]), 10.0)
    with pytest.raises(ValueError, match="variant"):
        pair_tangent(xb, sb, vb, eb, *lb, wb, 10.0, variant="wgmma")
    with pytest.raises(ValueError, match="F=128"):
        pair_tangent(xb, sb[..., :32].contiguous(), vb, eb, *lb, wb, 10.0)
    big = torch.zeros(1, 33, 3, device="cuda")
    with pytest.raises(ValueError, match="2..32 atoms, got 33"):
        pair_tangent(big, sb, vb, eb, *lb, wb, 10.0)
    with pytest.raises(ValueError, match="cannot launch.*shared memory"):
        pair_layer(x, s, v, e, w, 10.0, 5, variant="fma")
    with pytest.raises(ValueError, match="chain_block"):
        pair_layer(x, s, v, e, w, 10.0, 0)
    with pytest.raises(ValueError, match="float32"):
        pk.fused_edge_mlp(s.reshape(-1, F)[:, :64].contiguous(), s.reshape(-1, F), w)


def _div_setup(n, f, layers, c, L):
    """Kernel B7's packed inputs for c chains of an n-atom molecule on the card."""
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.ops import div_kernel as dk

    model = torch_default_weights_(CPaiNN(f, layers, n_atoms=n))
    p = {k: t.detach().to("cuda") for k, t in model.state_dict().items()}
    template = graph_template(make_synthetic_molecule(n, seed=0), t_cond=2)
    xs = 0.1 * _rows(c, n, 3, seed=7)
    temps = torch.tensor([[1000.0, 300.0]], device="cuda").expand(c, 2)
    etype = torch.as_tensor(dk.dense_edge_type_matrix(template.edges), device="cuda").long()
    with torch.no_grad():
        st = dk._primal_layer_states(model, p, xs, 0.5, temps,
                                     torch.as_tensor(template.atom_ids, device="cuda"), etype)
    return model, template, xs, temps, dk.pack_inputs(st, L), dk._pack_mlp_stacks(p, layers)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["tc", "fma"])
@pytest.mark.parametrize("n,layers,c,L", [(6, 2, 3, 4), (6, 2, 3, 3), (19, 5, 5, 4), (19, 5, 4, 6),
                                          (29, 5, 2, 3), (32, 5, 2, 57), (5, 3, 3, 1),
                                          (19, 5, 1, 4), (19, 2, 130, 4)])
def test_div_kernel_matches_plain(n, layers, c, L, variant):
    """B7 against its plain version, on the tensor cores (3xTF32) and in f32
    FMA; bar 1e-4 (five layers of f32 tangent sums taken in another order)."""
    from ti_torch.ops import div_kernel as dk

    _card()
    *_, inp, stacks = _div_setup(n, F, layers, c, L)
    before = _build.LAUNCHES["div_kernel"]
    with torch.no_grad():
        out = dk.div_kernel(inp, stacks, L, variant=variant)
        torch.cuda.synchronize()
        ref = dk.div_kernel_plain(inp, stacks, L)
    assert _build.LAUNCHES["div_kernel"] == before + 1
    assert _build.ROUTES["div_kernel"] == dk.DIV_LIBS[variant]
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-4


@pytest.mark.gpu
def test_div_kernel_tc_is_deterministic_at_every_chunk_count():
    """Two launches of the tensor-core B7 agree to the bit; G = 1, 3 and
    every chunk of a chain a CTA agree with the plain version."""
    from ti_torch.ops import div_kernel as dk

    _card()
    *_, inp, stacks = _div_setup(19, F, 3, 4, 4)
    tf32 = dk.pack_tf32_stacks(stacks)
    with torch.no_grad():
        out = dk.div_kernel(inp, stacks, 4, tf32=tf32)
        again = dk.div_kernel(inp, stacks, 4, tf32=tf32)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        ref = dk.div_kernel_plain(inp, stacks, 4)
        for g in (1, 3, 15):
            got = dk.div_kernel(inp, stacks, 4, tf32=tf32, chunks_per_cta=g)
            torch.cuda.synchronize()
            assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-4


@pytest.mark.gpu
def test_divergence_kernel_batch_launches_b7_once():
    from ti_torch.ops.div_kernel import divergence_kernel_batch
    from ti_torch.ops.dense_divergence import dense_divergence

    _card()
    model, template, xs, temps, *_ = _div_setup(19, F, 2, 3, 4)
    model = model.to("cuda")
    _build.reset_launches()
    divs = divergence_kernel_batch(model, None, xs, 0.5, temps, template)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"div_kernel": 1}
    assert _build.ROUTE_LAUNCHES == {("div_kernel", "div_kernel_tf32x3"): 1}
    ref = torch.stack([dense_divergence(model, None, xs[i], 0.5, temps[i], template.atom_ids,
                                        template.edges)[1].detach() for i in range(3)])
    torch.testing.assert_close(divs, ref, rtol=3e-4, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["tc", "fma"])
def test_div_kernel_rejects_what_it_does_not_take(variant):
    from ti_torch.ops import div_kernel as dk

    _card()
    *_, inp, stacks = _div_setup(6, 256, 1, 2, 4)
    with pytest.raises(ValueError, match="F=128"):
        dk.div_kernel(inp, stacks, 4, variant=variant)
    *_, inp, stacks = _div_setup(33, F, 1, 1, 4)
    with pytest.raises(ValueError, match="2..32 atoms, got 33"):
        dk.div_kernel(inp, stacks, 4, variant=variant)
    *_, inp, stacks = _div_setup(6, F, 1, 2, 4)
    with pytest.raises(ValueError, match="lanes_per_chunk"):
        dk.div_kernel(inp, stacks, 3, variant=variant)
    with pytest.raises(ValueError, match="contiguous"):
        dk.div_kernel(inp._replace(e=inp.e.transpose(2, 3).contiguous().transpose(2, 3)), stacks, 4,
                      variant=variant)
    if variant == "tc":
        with pytest.raises(ValueError, match="chunks_per_cta"):
            dk.div_kernel(inp, stacks, 4, chunks_per_cta=99)
        with pytest.raises(ValueError, match="pack_tf32_stacks"):
            dk.div_kernel(inp, stacks, 4, tf32=dk.pack_tf32_stacks(stacks)[:, :-4].contiguous())


@pytest.mark.gpu
def test_div_kernel_tc_smem_and_tile_counts_are_the_kernels_own():
    import ctypes

    from ti_torch.ops import div_kernel as dk

    _card()
    lib = _build.load("div_kernel_tf32x3")
    lib.div_kernel_tf32x3_smem_bytes.restype = ctypes.c_ulonglong
    assert lib.div_kernel_tf32x3_smem_bytes() == dk.tc_smem_bytes()
    for n in (2, 5, 19, 29, 32):
        assert lib.div_kernel_tf32x3_lanes(n) == dk.div_tc_plan(1, n, 4, -(-3 * n // 4), 132).lanes_per_tile


# ---- the reference's sampler, the edge form, stage-coupled B4/B5 ---------

def _full_width(b=3, seed=5):
    """The 00031 width (19 atoms, F = 128, 5 layers), the smoke's random
    weights, b zero-centred chains, T0 = 1000 K -> T1 = 300 K."""
    import numpy as np

    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule

    model = torch_default_weights_(CPaiNN(F, 5, n_atoms=N))
    template = graph_template(make_synthetic_molecule(N, seed=0), t_cond=2)
    x0 = (0.1 * np.random.default_rng(seed).standard_normal((b, N, 3))).astype(np.float32)
    temps = np.tile(np.array([1000.0, 300.0], np.float32), (b, 1))
    return model, template, x0 - x0.mean(1, keepdims=True), temps


@pytest.mark.gpu
def test_reference_sampler_on_card():
    """sample_ambient on the preset's own route (dopri5, atol = rtol = 1e-5,
    exact dlogp in every stage; 5 save points, 3 chains) against
    stage-coupled RK4 at 64 steps: rtol 1e-3 / atol 1e-3, 100 x the solver's
    tolerance."""
    _card()
    from ti_torch.config import ambient_preset
    from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of, sample_ambient

    model, template, x0, temps = _full_width()
    out = sample_ambient(ambient_preset("00031", n_steps=5, batch_size=3), model, None, template,
                         x0, save=False, device="cuda")
    assert (out["nfe_per_chain"] >= 4 * 7).all()
    fine = make_ode_sampler(molecular_v_fn_of(model, None, template, device="cuda"),
                            solver="rk4", n_steps=64, n_save=5, device="cuda")(x0, temps)
    torch.testing.assert_close(torch.from_numpy(out["samples"]), fine.xs.cpu(), rtol=1e-3,
                               atol=1e-3)
    torch.testing.assert_close(torch.from_numpy(out["dlogps"]), fine.dlogp[:, -1].cpu(),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
def test_edge_form_reference_shape_on_card():
    """The edge form against the dense one (rtol 2e-3 / atol 2e-4), and the
    Euler exact-dlogp sampler bench.py prices over each (samples rtol 1e-4 /
    atol 1e-5, dlogp rtol 1e-3 / atol 1e-3 max |dlogp|)."""
    _card()
    from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of

    model, template, x0, temps = _full_width()
    edge = molecular_v_fn_of(model, None, template, impl="edge", device="cuda")
    dense = molecular_v_fn_of(model, None, template, device="cuda")
    xt, tt = torch.as_tensor(x0, device="cuda"), torch.as_tensor(temps, device="cuda")
    with torch.no_grad():
        torch.testing.assert_close(edge(tt)(xt, 0.5), dense(tt)(xt, 0.5), rtol=2e-3, atol=2e-4)
    kw = dict(solver="euler", n_steps=8, n_save=2, steps_per_dispatch=8, device="cuda")
    a = make_ode_sampler(edge, **kw)(x0, temps)
    b = make_ode_sampler(dense, **kw)(x0, temps)
    torch.testing.assert_close(a.xs, b.xs, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(a.dlogp, b.dlogp, rtol=1e-3,
                               atol=1e-3 * b.dlogp.abs().max().item())


@pytest.mark.gpu
def test_stage_coupled_dense_fused_on_card():
    """Stage-coupled RK4-8 (chip_smoke.py phase 11's steps, 3 chains)
    through impl="dense_fused": every evaluation runs two B4 launches a
    layer (the velocity and the JVPs' primal) and one B5 a layer, all on
    the tensor-core libraries, and agrees with impl="dense" (samples rtol
    1e-4 / atol 1e-5, dlogp rtol 1e-3, phase 9's bars)."""
    _card()
    from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of

    model, template, x0, temps = _full_width()
    kw = dict(solver="rk4", n_steps=8, device="cuda")
    fused = make_ode_sampler(molecular_v_fn_of(model, None, template, impl="dense_fused",
                                               device="cuda"), **kw)
    _build.reset_launches()
    a = fused(x0, temps)
    torch.cuda.synchronize()
    evals = 8 * 4
    assert {k: n for k, n in _build.ROUTE_LAUNCHES.items() if n} == {
        ("fused_edge_mlp", "fused_edge_mlp_tf32x3"): 2 * evals * 5,
        ("fused_edge_mlp_jvp", "fused_edge_mlp_jvp_tf32x3"): evals * 5}
    b = make_ode_sampler(molecular_v_fn_of(model, None, template, device="cuda"), **kw)(x0, temps)
    torch.testing.assert_close(a.xs, b.xs, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(a.dlogp, b.dlogp, rtol=1e-3,
                               atol=1e-3 * b.dlogp.abs().max().item())


def _train_batch(b, seed=12):
    import numpy as np

    rng = np.random.default_rng(seed)
    x0 = (0.3 * rng.standard_normal((b, N, 3))).astype("float32")
    x1 = (0.2 * rng.standard_normal((b, N, 3))).astype("float32")
    temps = np.tile(np.array([1000.0, 300.0], "float32"), (b, 1))
    t = rng.uniform(0.0, 1.0, b).astype("float32")
    z = rng.standard_normal((b, N, 3)).astype("float32")
    return x0, x1, temps, t, z


@pytest.mark.gpu
@pytest.mark.parametrize("impl,dtype,b", [("edge", "f32", 12), ("dense", "bf16_agg", 16)])
def test_train_step_on_card_matches_cpu(impl, dtype, b):
    """One update's loss and gradients at F = 128, 2 layers, on the card
    against the CPU from the same weights, batch, t and z (chip_smoke.py
    phase 12(a)'s bars: f32 loss rtol 1e-5, gradients rtol 1e-4 with atol
    1e-5 of each leaf's largest |gradient|; bf16_agg loss and the whole
    gradient within 2e-2), and the optimizer step moves the weights on
    the card as on the CPU."""
    _card()
    from ti_torch.config import MDQM9Config
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.interpolants import linear
    from ti_torch.losses import molecular_velocity_loss
    from ti_torch.train import common

    template = graph_template(make_synthetic_molecule(N, seed=0), t_cond=2)
    cfg = MDQM9Config(train_impl=impl, train_compute_dtype=dtype)
    init = torch_default_weights_(CPaiNN(F, 2, n_atoms=N)).state_dict()
    got = {}
    for dev in ("cuda", "cpu"):
        model = CPaiNN(F, 2, n_atoms=N)
        model.load_state_dict(init)
        model.to(dev)
        params = dict(model.named_parameters())
        x0, x1, temps, t, z = (torch.from_numpy(a).to(dev) for a in _train_batch(b))
        loss = molecular_velocity_loss(common.make_batched_apply(cfg, model, template), params,
                                       x0, x1, temps, linear(a=1.0, gamma="sin2"), t=t, z=z)
        grads = torch.autograd.grad(loss, list(params.values()))
        got[dev] = (loss.item(), {k: g.cpu() for k, g in zip(params, grads)})
    (lg, gg), (lc, gc) = got["cuda"], got["cpu"]
    if dtype == "f32":
        assert abs(lg - lc) <= 1e-5 * abs(lc)
        for k in gc:
            torch.testing.assert_close(gg[k], gc[k], rtol=1e-4,
                                       atol=1e-5 * gc[k].abs().max().item())
    else:
        assert abs(lg - lc) <= 2e-2 * abs(lc)
        flat_g = torch.cat([gg[k].ravel() for k in sorted(gc)])
        flat_c = torch.cat([gc[k].ravel() for k in sorted(gc)])
        assert (flat_g - flat_c).abs().max() <= 2e-2 * flat_c.abs().max()


@pytest.mark.gpu
def test_train_ambient_runs_on_the_card_by_default(tmp_path):
    """``train_ambient`` with no device trains on the card: its parameters
    live there, its losses are finite, and its checkpoints are written."""
    _card()
    import numpy as np

    from ti_torch.config import MDQM9Config
    from ti_torch.data.mdqm9 import (
        MDQM9AmbientDataset,
        make_synthetic_frames,
        make_synthetic_molecule,
    )
    from ti_torch.train import train_ambient

    mol = make_synthetic_molecule(N, seed=0)
    frames = np.concatenate([make_synthetic_frames(mol, 24, T, seed=T) for T in (1000, 300)])
    temps = np.concatenate([np.full(24, 1000.0), np.full(24, 300.0)])
    ds = MDQM9AmbientDataset.from_arrays(frames, temps, mol)
    cfg = MDQM9Config(n_features=F, score_layers=2, batch_size=12, n_epochs=2, T0s=[1000, 300],
                      T1s=[1000, 300], scale_trajs=False, model_save_path=str(tmp_path),
                      model_save_name="card", use_wandb=False)
    res = train_ambient(cfg, ds, ds)
    assert all(p.is_cuda for p in res["params"].values())
    assert all(np.isfinite(v).all() for v in res["history"].values())
    assert res["state"].nan_count == 0
    assert (tmp_path / "card" / "card_1_weights.npz").exists()


@pytest.mark.gpu
@pytest.mark.parametrize("Ts", [[300], [300, 500, 700]], ids=["none", "latent"])
def test_latent_kernel_route_matches_plain_route(Ts):
    """``sample_latent`` on the latent kernel route (``fast_profile(family=
    "latent")`` in f32 with B1's trajectory and B3's full orthogonal frame,
    temps (B, 0) or (B, 1)) against the same sampler built from the plain
    versions on the same noise, 2 layers, 8 chains, RK4-9, GL-8: samples
    rtol 1e-4 / atol 1e-5, dlogp rtol 1e-3 with atol 1e-3 of max |dlogp|
    (chip_smoke.py phase 4's bars); every B1 launch from pair_layer_tf32x3
    (9 gaps x 1 step x 4 stages x 2 layers) and every B3 launch from
    pair_tangent_tf32x3 (8 nodes x 2 layers)."""
    import numpy as np

    from ti_torch.config import fast_profile, latent_preset
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.ops.pair_layer_kernel import pair_kernel_drift
    from ti_torch.ops.pair_tangent_kernel import pair_tangent_div_fn
    from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of, sample_latent
    from ti_torch.train.latent import build_latent_model

    _card()
    cfg = fast_profile(latent_preset("00031", Ts=Ts, score_layers=2, batch_size=8),
                       family="latent", compute_dtype="f32", traj_forward_impl="pair_kernel",
                       div_forward_impl="pair_tangent", n_steps=9)
    t_cond = 1 if len(Ts) > 1 else 0
    model = torch_default_weights_(build_latent_model(cfg, N))
    template = graph_template(make_synthetic_molecule(N, seed=0), t_cond=t_cond)
    z = np.random.default_rng(0).standard_normal((8, N, 3)).astype(np.float32)
    z -= z.mean(axis=1, keepdims=True)
    _build.reset_launches()
    out = sample_latent(cfg, model, None, template, n_samples=8, noise=z, save=False,
                        device="cuda")
    torch.cuda.synchronize()
    assert dict(_build.ROUTE_LAUNCHES) == {("pair_layer", "pair_layer_tf32x3"): 9 * 4 * 2,
                                           ("pair_tangent", "pair_tangent_tf32x3"): 8 * 2}
    plain = make_ode_sampler(
        molecular_v_fn_of(model, None, template, device="cuda"), solver="rk4", n_steps=9,
        n_save=2, divergence="exact", steps_per_dispatch=cfg.steps_per_dispatch,
        dlogp_quad_points=8, dlogp_quad="gauss",
        traj_drift=pair_kernel_drift(model, None, template, device="cuda", kernel=False),
        div_drift=pair_tangent_div_fn(model, None, template, num_probes=3 * N,
                                      probe_mode="orthogonal", device="cuda", kernel=False),
        device="cuda")
    temps = torch.full((8, t_cond), float(cfg.sampling_T), device="cuda")
    ref = plain(z, temps, torch.Generator(device="cuda").manual_seed(0))
    ref_dlogp = ref.dlogp[:, -1].cpu().numpy()
    np.testing.assert_allclose(out["samples"], ref.xs.cpu().numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["dlogps"], ref_dlogp, rtol=1e-3,
                               atol=1e-3 * np.abs(ref_dlogp).max())
    np.testing.assert_array_equal(out["samples"][:, 0], z)


@pytest.mark.gpu
def test_published_latent_profile_at_its_batch():
    """The published 00031 latent profile (``fast_profile(latent_preset(
    "00031", Ts=[300]), family="latent")``: bf16, the dense forward, GL-8
    exact nodes) at its batch of 256 chains, RK4-9: the nodes run in the
    lane blocks ``exact_lane_block`` sizes from the card's total memory
    (blocked, at least 1), no kernel launches, the samples and dlogp are
    finite, and two calls agree to the bit."""
    import numpy as np

    from ti_torch.config import fast_profile, latent_preset
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.sampling.drivers import _exact_div_chunk, sample_latent
    from ti_torch.train.latent import build_latent_model

    _card()
    cfg = fast_profile(latent_preset("00031", Ts=[300]), family="latent", n_steps=9)
    assert (cfg.batch_size, cfg.compute_dtype, cfg.divergence) == (256, "bf16", "exact")
    model = torch_default_weights_(build_latent_model(cfg, N))
    template = graph_template(make_synthetic_molecule(N, seed=0), t_cond=0)
    block = _exact_div_chunk(cfg, model, template, torch.device("cuda"), cfg.batch_size)
    assert block is not None and 1 <= block < 3 * N
    runs = []
    for _ in range(2):
        _build.reset_launches()
        runs.append(sample_latent(cfg, model, None, template, n_samples=256, save=False,
                                  device="cuda"))
        torch.cuda.synchronize()
        assert not any(_build.ROUTE_LAUNCHES.values())
    a, b = runs
    assert a["samples"].shape == (256, 2, N, 3)
    assert np.isfinite(a["samples"]).all() and np.isfinite(a["dlogps"]).all()
    np.testing.assert_array_equal(a["samples"], b["samples"])
    np.testing.assert_array_equal(a["dlogps"], b["dlogps"])


@pytest.mark.gpu
def test_train_latent_runs_on_the_card_by_default(tmp_path):
    import numpy as np

    from ti_torch.config import MDQM9Config
    from ti_torch.data.mdqm9 import MDQM9LatentDataset, make_synthetic_molecule
    from ti_torch.train import train_latent

    _card()
    mol = make_synthetic_molecule(5, seed=0)
    frames = 0.25 * np.random.default_rng(0).standard_normal((32, 5, 3)).astype(np.float32)
    ds = MDQM9LatentDataset.from_arrays(frames - frames.mean(1, keepdims=True),
                                        np.full(32, 300.0), mol, t_cond=0)
    cfg = MDQM9Config(n_features=16, score_layers=1, batch_size=8, n_epochs=2, T=[300],
                      model_save_path=str(tmp_path), use_wandb=False)
    res = train_latent(cfg, ds)
    assert all(p.is_cuda for p in res["params"].values())
    assert res["state"].count == 8 and np.isfinite(res["history"]["train_loss"]).all()


ADW_ROUTES = {"rk4": dict(solver_type="rk4", n_step=32),
              "dopri5": dict(solver_type="dopri5", n_step=20),
              "gauss": dict(solver_type="rk4", n_step=32, dlogp_quad_points=8,
                            dlogp_quad="gauss")}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("route", sorted(ADW_ROUTES))
def test_sample_adw_on_card_matches_cpu(route, dtype):
    """``sample_adw`` of 256 chains on the card against the CPU on the same
    weights (a fresh 64 x 3 ``FCNetMultiBeta``) and inputs: samples rtol
    1e-4 / atol 1e-5 and dlogp rtol 1e-3 / atol 1e-5 in f32, both 1e-9 in
    f64 (chip_smoke.py phase 14(c)'s bars)."""
    import numpy as np

    from ti_torch.analysis.potentials import BoltzmannDensity1D
    from ti_torch.config import ADWConfig
    from ti_torch.sampling.drivers import sample_adw
    from ti_torch.train import build_adw_model

    _card()
    cfg = ADWConfig(hidden_size=64, num_layers=3, dtype=dtype, beta1s=[1.5],
                    **ADW_ROUTES[route])
    model = build_adw_model(cfg, generator=torch.Generator().manual_seed(0))
    x0 = BoltzmannDensity1D(1.0).sample(0, 256)[:, None]
    outs = {}
    for dev in ("cuda", "cpu"):
        m = build_adw_model(cfg)
        m.load_state_dict(model.state_dict())
        outs[dev] = sample_adw(cfg, m.to(dev), None, x0, np.ones(256), save=False, device=dev)
    bars = ((dict(rtol=1e-4, atol=1e-5), dict(rtol=1e-3, atol=1e-5)) if dtype == "f32"
            else (dict(rtol=1e-9, atol=1e-9),) * 2)
    np.testing.assert_allclose(outs["cuda"]["samples"], outs["cpu"]["samples"], **bars[0])
    np.testing.assert_allclose(outs["cuda"]["dlogps"], outs["cpu"]["dlogps"], **bars[1])
    assert outs["cuda"]["samples"].dtype == (np.float32 if dtype == "f32" else np.float64)
    assert np.isfinite(outs["cuda"]["dlogps"]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_adw_update_on_card_matches_cpu(dtype):
    """One ADW update at the published width (5 x 256, batch 512) from the
    same weights, batch, t and z: the loss and gradients on the card
    against the CPU (f32: loss rtol 1e-5, gradients rtol 1e-4 with atol
    1e-5 of each leaf's largest; f64: 1e-10), and the optimizer step moves
    the weights on both. (Adam's first step divides each gradient by its own
    magnitude, so a gradient element near eps = 1e-8, within the gradient
    bar, moves its weight by a different fraction of lr on each device.)"""
    import numpy as np

    from ti_torch.config import ADWConfig
    from ti_torch.models.mlp import param_dtype
    from ti_torch.train import build_adw_model, common, make_adw_loss

    _card()
    cfg = ADWConfig(dtype=dtype)
    init = build_adw_model(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(4)
    b = cfg.batch_size
    batch = [rng.standard_normal((b, 1)), rng.standard_normal((b, 1)), np.full((b, 1), 1.0),
             np.full((b, 1), 1.25), rng.uniform(0.0, 1.0, (b, 1)), rng.standard_normal((b, 1))]
    got = {}
    for dev in ("cuda", "cpu"):
        m = build_adw_model(cfg)
        m.load_state_dict(init)
        m.to(dev)
        params = dict(m.named_parameters())
        x0, x1, b0, b1, t, z = (torch.as_tensor(a, dtype=param_dtype(dtype), device=dev)
                                for a in batch)
        loss_fn = make_adw_loss(cfg, m, params)
        opt = common.make_optimizer(list(params.values()), cfg.lr, weight_decay=cfg.wd)
        step = common.make_update_step(lambda g, *a: loss_fn(g, *a, t=t, z=z), opt)
        loss = loss_fn(None, x0, x1, b0, b1, t=t, z=z)
        grads = torch.autograd.grad(loss, list(params.values()))
        step(None, x0, x1, b0, b1)
        got[dev] = (loss.item(), {k: g.cpu() for k, g in zip(params, grads)},
                    max((p.detach().cpu() - init[k]).abs().max().item()
                        for k, p in params.items()))
    (lg, gg, moved_g), (lc, gc, moved_c) = got["cuda"], got["cpu"]
    f32 = dtype == "f32"
    assert abs(lg - lc) <= (1e-5 if f32 else 1e-10) * abs(lc)
    for k in gc:
        assert gg[k].dtype == param_dtype(dtype)
        torch.testing.assert_close(gg[k], gc[k], rtol=1e-4 if f32 else 1e-10,
                                   atol=(1e-5 if f32 else 1e-10) * gc[k].abs().max().item())
    assert moved_g > 0.0 and moved_c > 0.0


@pytest.mark.gpu
def test_train_adw_runs_on_the_card_by_default_in_f64(tmp_path):
    """``train_adw`` with no device trains on the card, in f64 when the
    config says so: its parameters live there in float64, its losses are
    finite, and it writes one checkpoint an epoch."""
    import numpy as np

    from ti_torch.config import ADWConfig
    from ti_torch.data.adw import make_synthetic_adw_csv
    from ti_torch.train import train_adw

    _card()
    make_synthetic_adw_csv(str(tmp_path / "samples.csv"), betas=[1.0, 1.25], n_samples=2000)
    cfg = ADWConfig(n_samples=2000, hidden_size=64, num_layers=3, epochs=2, batch_size=128,
                    dtype="f64", traj_path=str(tmp_path), model_save_path=str(tmp_path / "m"),
                    use_wandb=False)
    res = train_adw(cfg)
    assert all(p.is_cuda and p.dtype == torch.float64 for p in res["params"].values())
    assert all(np.isfinite(v).all() for v in res["history"].values())
    assert res["state"].nan_count == 0 and res["state"].count == 2 * (1600 // 128)
    assert (tmp_path / "m" / "velocity" / "epoch_1.npz").exists()


def _wrapped(a):
    return (a + torch.pi) % (2 * torch.pi) - torch.pi


def _zmatrix_case(n, conformations):
    import numpy as np

    from ti_torch.analysis.sort_atoms import (
        adjacency_from_bonds,
        compute_atom_order_and_references_groups,
    )
    from ti_torch.data.mdqm9 import make_synthetic_frames, make_synthetic_molecule

    mol = make_synthetic_molecule(n, seed=0)
    order, _, refs = compute_atom_order_and_references_groups(
        adjacency_from_bonds(n, mol.bond_index))
    x = make_synthetic_frames(mol, conformations, 300.0, seed=3)[:, np.asarray(order)]
    return torch.from_numpy(x), refs


@pytest.mark.gpu
@pytest.mark.parametrize("n", [19, 29])
def test_zmatrix_nerf_and_log_det_on_the_card_match_the_cpu(n):
    """The port's z-matrices, NeRF reconstruction and log|det J| on the card
    against the same functions on the CPU, at the float32 bars of
    tests/test_torch_zmatrix.py (rtol 1e-5 / atol 1e-6, torsions modulo
    2 pi; ``valid_z_mask`` exactly). The cartesians' atol is one float32
    ulp of the largest |coordinate| for each of the N - 3 placements: the
    NeRF places each atom from earlier ones, so its rounding accumulates
    along the placement order and a coordinate near 0 carries the error of
    references far from it (the card and the CPU contract other products
    into FMAs: 5.2e-6 apart at 29 atoms, coordinates up to 7.3, where the
    bar is 2.3e-5)."""
    from ti_torch.analysis.zmatrix import (
        compute_jacobian_batch,
        construct_z_matrix,
        deconstruct_z_matrix,
        valid_z_mask,
    )

    _card()
    x, refs = _zmatrix_case(n, 4096)
    z_cpu = construct_z_matrix(x, refs)
    z = construct_z_matrix(x.cuda(), refs)
    assert z.is_cuda and z.dtype == torch.float32
    torch.testing.assert_close(z[..., :2].cpu(), z_cpu[..., :2], rtol=1e-5, atol=1e-6)
    d = _wrapped(z[..., 2].cpu() - z_cpu[..., 2]).abs()
    assert bool((d <= 1e-6 + 1e-5 * z_cpu[..., 2].abs()).all()), float(d.max())
    assert torch.equal(valid_z_mask(z).cpu(), valid_z_mask(z_cpu))
    cart, logdet = deconstruct_z_matrix(z_cpu.cuda(), refs)
    cart_cpu, logdet_cpu = deconstruct_z_matrix(z_cpu, refs)
    ulp = torch.finfo(torch.float32).eps * float(cart_cpu.abs().max())
    torch.testing.assert_close(cart.cpu(), cart_cpu, rtol=1e-5, atol=(n - 3) * ulp)
    torch.testing.assert_close(logdet.cpu(), logdet_cpu, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(compute_jacobian_batch(z_cpu.cuda(), refs).cpu(),
                               compute_jacobian_batch(z_cpu, refs), rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_full_report_on_the_card_matches_the_cpu(tmp_path):
    """``generate_full_report`` with its z-matrices on the card against the
    same on the CPU: the marginals at the float32 bar (torsions modulo
    2 pi), everything else (host numpy on the same arrays) equal."""
    import numpy as np

    from ti_torch.analysis import results
    from ti_torch.analysis.sort_atoms import adjacency_from_bonds
    from ti_torch.data.mdqm9 import make_synthetic_frames, make_synthetic_molecule

    _card()
    mol = make_synthetic_molecule(N, seed=0)
    adj = adjacency_from_bonds(N, mol.bond_index)
    rng = np.random.default_rng(4)
    src = results.MDTISource(x0s=make_synthetic_frames(mol, 512, 1000.0, seed=1),
                             x1s=make_synthetic_frames(mol, 512, 300.0, seed=2),
                             E0s=rng.normal(10, 1, 512), E1s=rng.normal(10.5, 1, 512),
                             neg_dlogps_ti=rng.normal(0, 0.2, 512))
    kw = dict(md_ti=src, md_T0=make_synthetic_frames(mol, 512, 1000.0, seed=3),
              md_T1=make_synthetic_frames(mol, 512, 300.0, seed=4), n_bootstrap=50)
    rep = results.generate_full_report(adj, save_path=str(tmp_path), **kw)  # device=None: cuda
    ref = results.generate_full_report(adj, device="cpu", **kw)
    assert set(rep) == set(ref) and len(list(tmp_path.iterdir())) == len(rep)
    for key in ref:
        if key.startswith(("torsions", "bond_angles", "bond_lengths")):
            a, b = torch.from_numpy(rep[key]), torch.from_numpy(ref[key])
            d = _wrapped(a - b) if key.startswith("torsions") else a - b
            assert bool((d.abs() <= 1e-6 + 1e-5 * b.abs()).all()), (key, float(d.abs().max()))
        else:
            np.testing.assert_array_equal(np.asarray(rep[key], np.float64),
                                          np.asarray(ref[key], np.float64))


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """NCCL at world size 1 (NCCL refuses two ranks on one card) and a 1-D
    cuda mesh over it; the ranks themselves are the CPU tests' (gloo)."""
    _card()
    import torch.distributed as dist

    from ti_torch.parallel import init_distributed, make_mesh

    store = tmp_path_factory.mktemp("nccl") / "store"
    init_distributed("nccl", init_method=f"file://{store}", rank=0, world_size=1, local_rank=0,
                     timeout_s=120)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_chain_sharded_main_path_on_nccl(nccl_mesh):
    """``parallel_sampler`` over the main path's route (2 layers) on NCCL
    equals ``sample_ambient`` unsharded with the same seed (phase 4's bars;
    the probes are the same by construction), through B1 from
    pair_layer_tf32x3 and B3 from pair_tangent_mma."""
    import numpy as np

    from ti_torch.config import ambient_preset, fast_profile
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.parallel import parallel_sampler
    from ti_torch.sampling.drivers import _config_sampler, sample_ambient

    _card()
    model = torch_default_weights_(CPaiNN(F, 2, n_atoms=N))
    template = graph_template(make_synthetic_molecule(N, seed=0), t_cond=2)
    cfg = fast_profile(ambient_preset("00031", score_layers=2))
    rng = np.random.default_rng(3)
    x0 = (0.1 * rng.standard_normal((B, N, 3))).astype("float32")
    x0 -= x0.mean(axis=1, keepdims=True)
    temps = np.tile(np.array([cfg.sampling_T0, cfg.sampling_T1], "float32"), (B, 1))
    whole = sample_ambient(cfg, model, None, template, x0, save=False, batch_size=B)
    sampler = parallel_sampler(_config_sampler(cfg, model, None, template, torch.device("cuda")),
                               nccl_mesh)
    _build.reset_launches()
    sol = sampler(x0, temps, torch.Generator(device="cuda").manual_seed(cfg.seed))
    routes = {k: n for k, n in _build.ROUTE_LAUNCHES.items() if n}
    assert routes == {("pair_layer", "pair_layer_tf32x3"): 9 * 4 * 2,
                      ("pair_tangent", "pair_tangent_mma"): 8 * 2}
    np.testing.assert_allclose(sol.xs.cpu().numpy(), whole["samples"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sol.dlogp[:, -1].cpu().numpy(), whole["dlogps"], rtol=1e-3)


@pytest.mark.gpu
def test_lane_sharded_divergence_and_parallel_update_on_nccl(nccl_mesh):
    """On the same group: the lane-sharded exact divergence of the dense
    forward against ``divergence_exact`` (rtol 3e-4), and one
    ``parallel_update`` step of the dense f32 loss against
    ``make_update_step``'s (loss rtol 1e-5, parameters rtol 1e-4 / atol
    1e-6)."""
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.interpolants import linear
    from ti_torch.losses import molecular_velocity_loss
    from ti_torch.ops.divergence import divergence_exact
    from ti_torch.parallel import parallel_update
    from ti_torch.sampling.drivers import molecular_v_fn_of
    from ti_torch.train import common

    _card()
    init = torch_default_weights_(CPaiNN(F, 2, n_atoms=N))
    template = graph_template(make_synthetic_molecule(N, seed=0), t_cond=2)
    x0, x1, temps, _, _ = (torch.from_numpy(a).cuda() for a in _train_batch(16))
    v = molecular_v_fn_of(init, None, template, device="cuda")(temps[:B])
    f = lambda y: v(y, 0.5)  # noqa: E731
    _, lanes = divergence_exact(f, x0[:B], chunk=N, axis_name=nccl_mesh.get_group("data"))
    _, ref = divergence_exact(f, x0[:B], chunk=N)
    torch.testing.assert_close(lanes, ref, rtol=3e-4, atol=0.0)

    class Cfg:
        train_impl = "dense"
        train_compute_dtype = "f32"

    got = []
    for wrap in (lambda s: s, lambda s: parallel_update(s, nccl_mesh)):
        model = CPaiNN(F, 2, n_atoms=N)
        model.load_state_dict(init.state_dict())
        model.cuda()
        params = dict(model.named_parameters())
        apply = common.make_batched_apply(Cfg, model, template)
        step = wrap(common.make_update_step(
            lambda g, a, b, tp: molecular_velocity_loss(apply, params, a, b, tp,
                                                        linear(a=1.0, gamma="sin2"), generator=g),
            common.make_optimizer(list(params.values()), 1e-4)))
        loss = step(torch.Generator(device="cuda").manual_seed(0), x0, x1, temps)
        got.append((loss, {k: p.detach().cpu() for k, p in params.items()}))
    assert abs(got[1][0] - got[0][0]) <= 1e-5 * abs(got[0][0])
    for k, p in got[0][1].items():
        torch.testing.assert_close(got[1][1][k], p, rtol=1e-4, atol=1e-6)


def _cli_workspace(root, layers=2):
    """A synthetic workspace at 19 atoms and the flags of the CLIs at F =
    128 with ``layers`` message layers (no ``--device``: the card)."""
    from ti_torch.data.mdqm9 import write_synthetic_workspace

    write_synthetic_workspace(str(root), N, 8)
    return ["--preset", "00031:300", "--traj_path", str(root / "trajs"), "--sdf_path", str(root),
            "--model_save_path", str(root / "models"), "--data_save_path", str(root / "out"),
            "--score_layers", str(layers), "--batch_size", "8", "--n_epochs", "1",
            "--model_epoch", "0", "--data_save_name", "cli"]


def _cli_json(main, argv, capsys):
    import json

    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.gpu
def test_latent_cli_kernel_route_on_the_card(tmp_path, capsys):
    """``mdqm9_train_latent`` then ``mdqm9_sample_latent`` on the latent
    kernel route with no ``--device`` (2 layers, 8 chains, RK4-9, GL-8):
    every B1 launch from pair_layer_tf32x3 (9 gaps x 1 step x 4 stages x 2
    layers), every B3 launch from pair_tangent_tf32x3 (8 nodes x 2 layers),
    and the artifacts equal to ``sample_latent`` with the same config and
    seed, to the bit."""
    import numpy as np

    from ti_torch.cli import mdqm9_sample_latent, mdqm9_train_latent
    from ti_torch.data.mdqm9 import MDQM9LatentDataset
    from ti_torch.sampling.drivers import sample_latent
    from ti_torch.train.common import load_checkpoint
    from ti_torch.train.latent import build_latent_model

    _card()
    flags = _cli_workspace(tmp_path) + ["--model_save_name", "lat", "--n_latent_samples", "8"]
    _cli_json(mdqm9_train_latent.main, flags, capsys)
    argv = flags + ["--fast_profile", "--compute_dtype", "f32", "--traj_forward_impl",
                    "pair_kernel", "--div_forward_impl", "pair_tangent", "--n_steps", "9"]
    line = _cli_json(mdqm9_sample_latent.main, argv, capsys)
    assert line["route_launches"] == {"pair_layer:pair_layer_tf32x3": 9 * 4 * 2,
                                      "pair_tangent:pair_tangent_tf32x3": 8 * 2}
    cfg = mdqm9_train_latent.parse(argv)
    ds = MDQM9LatentDataset.load(cfg.traj_path, cfg.sdf_path, cfg.mdqm9_traj_filename,
                                 cfg.sdf_filename, split="test", Ts=cfg.T)
    ref = sample_latent(cfg, build_latent_model(cfg, N), load_checkpoint(
        str(tmp_path / "models" / "lat" / "lat_0.npz")), ds.template, save=False)
    for stem in ("samples", "dlogps"):
        np.testing.assert_array_equal(np.load(tmp_path / "out" / f"{stem}_cli_forward.npy"),
                                      ref[stem])


@pytest.mark.gpu
def test_sde_cli_on_the_card(tmp_path, capsys):
    """``mdqm9_sample_sde --sde_forward_impl pair_kernel`` with no
    ``--device`` over the test split (8 chains, 4 steps, 2 layers): one B1
    launch a layer a step, all from pair_layer_tf32x3, and the samples equal
    to ``sample_molecular_sde`` with the same seed, to the bit."""
    import numpy as np

    from ti_torch.cli import mdqm9_sample_sde
    from ti_torch.cli.mdqm9_train_ambient import parse
    from ti_torch.data.mdqm9 import MDQM9AmbientDataset
    from ti_torch.sampling.drivers import sample_molecular_sde
    from ti_torch.train.ambient import build_ambient_model
    from ti_torch.train.common import checkpoint_path, load_checkpoint, save_checkpoint

    _card()
    argv = _cli_workspace(tmp_path) + ["--model_save_name", "smoke", "--sde_forward_impl",
                                       "pair_kernel", "--n_steps", "4"]
    (tmp_path / "models" / "smoke").mkdir(parents=True)
    ckpt = checkpoint_path(str(tmp_path / "models" / "smoke"), "smoke", 0)
    save_checkpoint(ckpt, torch_default_weights_(CPaiNN(F, 2, n_atoms=N)).state_dict())
    line = _cli_json(mdqm9_sample_sde.main, argv, capsys)
    assert line["route_launches"] == {"pair_layer:pair_layer_tf32x3": 4 * 2}
    cfg = parse(argv)
    ds = MDQM9AmbientDataset.load(cfg.traj_path, cfg.sdf_path, cfg.mdqm9_traj_filename,
                                  cfg.sdf_filename, split="test", Ts=[cfg.sampling_T0])
    temps = np.tile(np.array([cfg.sampling_T0, cfg.sampling_T1], np.float32), (8, 1))
    ref = sample_molecular_sde(build_ambient_model(cfg, N), load_checkpoint(ckpt), ds.template,
                               ds.frames, temps, torch.Generator(device="cuda").manual_seed(0),
                               g_fn=cfg.sde_g, n_steps=4, forward_impl="pair_kernel")
    np.testing.assert_array_equal(np.load(tmp_path / "out" / "samples_cli_sde.npy"),
                                  ref.cpu().numpy())


@pytest.mark.gpu
def test_sde_scan_launches_b1_and_b2_on_the_card(capsys):
    """``sde_scan`` with no ``--device`` (64 chains, 2 layers, 4 steps):
    every pair_kernel row launches its kernel once a layer a step, B1 at
    chain block 1 and B2 at 4, from pair_layer_tf32x3 (f32) or
    pair_layer_mma (bf16_agg)."""
    import json

    from ti_torch.cli import sde_scan

    _card()
    assert sde_scan.main(["--chains", "64", "--layers", "2", "--steps", "4", "--reps", "1",
                          "--dtypes", "f32,bf16_agg", "--impls", "pair_kernel",
                          "--chain_blocks", "1,4"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rows = json.loads(out[-1][len("rows: "):])
    assert len(rows) == 4 and not any("FAILED" in line for line in out)
    for r in rows:
        lib = "pair_layer_tf32x3" if r["dtype"] == "f32" else "pair_layer_mma"
        kernel = "pair_layer" if r["chain_block"] == 1 else "pair_layer_cb"
        assert r["launches"] == {f"{kernel}:{lib}": 2 * 4}, r
        assert r["samples_per_s"] > 0


@pytest.mark.gpu
def test_large_scale_scan_refuses_f32_at_f256_and_runs_bf16_agg(capsys):
    """``large_scale_scan`` at F = 256 (29 atoms, one layer, 4 chains, RK4-2
    over GL-2's three gaps): both trajectory kernels run, the f32 row
    through pair_layer_tf32x3_f256 and the bf16_agg row through
    pair_layer_mma_f256, 3 gaps x 1 step x 4 stages a batch; the rows whose
    nodes reach B3 (``pair_tangent_bf16``) run it from
    pair_tangent_mma_f256, 2 nodes x 1 layer a batch."""
    import json

    from ti_torch.cli import large_scale_scan

    _card()
    assert large_scale_scan.main(["--layers", "1", "--chains", "4", "--probes", "4", "--steps",
                                  "2", "--gl_points", "2", "--reps", "1", "--impls",
                                  "pair_kernel,pair_kernel_bf16", "--div_impls",
                                  "default,pair_tangent_bf16"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    ran = {r["impl"]: r for r in rows if r["div_impl"] == "default"}
    for impl, lib in (("pair_kernel", "pair_layer_tf32x3_f256"),
                      ("pair_kernel_bf16", "pair_layer_mma_f256")):
        assert "error" not in ran[impl], ran[impl]
        assert ran[impl]["launches"] == {f"pair_layer:{lib}": 3 * 1 * 4}
        assert ran[impl]["samples_per_sec"] > 0
    nodes = {r["impl"]: r for r in rows if r["div_impl"] == "pair_tangent_bf16"}
    assert len(nodes) == 2
    for impl, lib in (("pair_kernel", "pair_layer_tf32x3_f256"),
                      ("pair_kernel_bf16", "pair_layer_mma_f256")):
        assert "error" not in nodes[impl], nodes[impl]
        assert nodes[impl]["launches"] == {f"pair_layer:{lib}": 3 * 1 * 4,
                                           "pair_tangent:pair_tangent_mma_f256": 2 * 1}
        assert nodes[impl]["samples_per_sec"] > 0


F64 = 64
F64_LIBS = {("pair_layer", torch.float32): "pair_layer_tf32x3_f64",
            ("pair_layer", torch.bfloat16): "pair_layer_mma_f64",
            ("pair_tangent", torch.float32): "pair_tangent_tf32x3_f64",
            ("pair_tangent", torch.bfloat16): "pair_tangent_mma_f64"}


def _layer64(dtype, n, b, k=0, seed=3):
    """Layer 0 of an F = 64 field packed for both tensor-core types, and
    inputs for b chains of n atoms with k lanes."""
    model = torch_default_weights_(CPaiNN(F64, 1, n_atoms=n))
    params = {name: t.detach() for name, t in model.state_dict().items()}
    w = with_mma_weights(with_tf32_weights(pack_layer(params, 0, F64, dtype, "cuda")))
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")).to(dtype)

    x = 0.3 * torch.randn(b, n, 3, generator=g, device="cuda")
    base = (x, rnd(b, n, F64), rnd(b, 3, n, F64, scale=0.3), rnd(b, n * n, F64))
    lanes = (torch.randn(b, k, n, 3, generator=g, device="cuda"), rnd(b, k, n, F64, scale=0.1),
             rnd(b, k, 3, n, F64, scale=0.1), rnd(b, k, n * n, F64, scale=0.1))
    return w, base, lanes


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,b", [(4, 37), (19, 13), (32, 5)])
def test_pair_layer_f64_matches_plain(dtype, n, b):
    """B1 at F = 64 (pair_layer_tf32x3_f64, pair_layer_mma_f64) against its
    plain version at N = 4, 19 and 32, each batch leaving the last 64-row
    tile ragged; B2 at C = 2, 3 and 4 equal to B1 to the bit, every launch
    from the type's ``_f64`` library."""
    _card()
    w, base, _ = _layer64(dtype, n, b)
    _build.reset_launches()
    out = pair_layer(*base, w, 10.0)
    torch.cuda.synchronize()
    _assert_close(out, pair_layer_plain(*base, w, 10.0), dtype)
    for c in (2, 3, 4):
        cb = pair_layer(*base, w, 10.0, c)
        torch.cuda.synchronize()
        assert all(torch.equal(a, q) for a, q in zip(cb, out))
    lib = F64_LIBS["pair_layer", dtype]
    assert _build.route_counts() == {f"pair_layer:{lib}": 1, f"pair_layer_cb:{lib}": 3}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,lane_block", [(torch.float32, None), (torch.bfloat16, None),
                                              (torch.bfloat16, 2), (torch.bfloat16, 1)])
@pytest.mark.parametrize("n,b,k", [(4, 9, 12), (19, 3, 8), (32, 2, 6)])
def test_pair_tangent_f64_matches_plain(dtype, lane_block, n, b, k):
    """B3 at F = 64 (pair_tangent_tf32x3_f64, pair_tangent_mma_f64) against
    its plain version at N = 4, 19 and 32: f32 in 128-row lane tiles (32
    lanes a tile at N = 4, 6 at N = 19 with a partial last tile, 4 at N =
    32 with 2 tiles of 4 and 2), bf16_agg in lane blocks of 4 (where they
    divide K), 2 and 1; two launches agree to the bit."""
    _card()
    if lane_block is None and dtype == torch.bfloat16 and k % 4:
        lane_block = 2
    w, base, lanes = _layer64(dtype, n, b, k)
    _build.reset_launches()
    out = pair_tangent(*base, *lanes, w, 10.0, lane_block)
    again = pair_tangent(*base, *lanes, w, 10.0, lane_block)
    torch.cuda.synchronize()
    assert all(torch.equal(a, q) for a, q in zip(out, again))
    _assert_close(out, pair_tangent_plain(*base, *lanes, w, 10.0, lane_block), dtype)
    assert _build.route_counts() == {f"pair_tangent:{F64_LIBS['pair_tangent', dtype]}": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("traj_impl,div_impl", [
    ("pair_kernel", "pair_tangent"), ("pair_kernel_bf16", "pair_tangent_bf16"),
    ("pair_kernel", "pair_tangent_bf16"), ("pair_kernel_bf16", "pair_tangent")])
def test_validate_mdqm9_cli_kernel_routes_at_f64(tmp_path, capsys, traj_impl, div_impl):
    """``validate_mdqm9_physics`` at its default ``--features 64`` and 3
    layers, one epoch of 64 frames a temperature, 1024 chains, RK4-8 over
    GL-2's three gaps with the exact divergence (the K = 12 frame): B1 runs
    3 gaps x 3 steps x 4 stages x 3 layers, B3 2 nodes x 3 layers, each from
    its type's ``_f64`` library, and the JSON is finite."""
    import json
    import math

    from ti_torch.cli import validate_mdqm9_physics

    _card()
    _build.reset_launches()
    assert validate_mdqm9_physics.main([
        "--epochs", "1", "--frames", "64", "--batch", "32", "--eval_steps", "8", "--quad_dlogp",
        "--traj_impl", traj_impl, "--div_impl", div_impl, "--gl_points", "2", "--out_dir",
        str(tmp_path)]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    layer = F64_LIBS["pair_layer", torch.bfloat16 if traj_impl.endswith("bf16") else torch.float32]
    tangent = F64_LIBS["pair_tangent",
                       torch.bfloat16 if div_impl.endswith("bf16") else torch.float32]
    assert _build.route_counts() == {f"pair_layer:{layer}": 3 * 3 * 4 * 3,
                                     f"pair_tangent:{tangent}": 2 * 3}
    assert (row["traj_impl"], row["div_impl"]) == (traj_impl, div_impl)
    assert all(math.isfinite(v) for v in row.values() if isinstance(v, float))


# B4, B5 and B6 at F = 256 (chip_smoke.py phase 23(a)): the 10506 model's
# shapes (16 chains of 29 atoms: 13,456 pair rows, 12,992 edge rows, 464
# node rows; K = 32 probes, K = 87 exact lanes at 4 chains) and ragged ones,
# each against its plain version and twice to the bit

def _params256():
    model = torch_default_weights_(CPaiNN(F256, 1, n_atoms=29))
    return {name: t.detach() for name, t in model.state_dict().items()}


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 31, 33, 1007, 12_992, 13_456])
def test_fused_edge_mlp_f256_matches_plain(r):
    """B4 at F = 256 (fused_edge_mlp_tf32x3_f256, 32-row tiles): every
    launch from the ``_f256`` library, two launches equal to the bit."""
    _card()
    w = with_tf32_weights(pack_layer(_params256(), 0, F256, torch.float32, "cuda"))
    in_feat, pe = _edge_rows(F256, r)
    key = ("fused_edge_mlp", "fused_edge_mlp_tf32x3_f256")
    before = _build.ROUTE_LAUNCHES.get(key, 0)
    out, again = pk.fused_edge_mlp(in_feat, pe, w), pk.fused_edge_mlp(in_feat, pe, w)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES[key] == before + 2
    assert torch.equal(out, again)
    _assert_close([out], [pk.fused_edge_mlp_reference(in_feat, pe, w.phi, w.w)], torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("r,k", [(5, 1), (65, 3), (1007, 7), (3364, 87), (13_456, 32)])
def test_fused_edge_mlp_jvp_f256_matches_plain(r, k):
    """B5 at F = 256 (fused_edge_mlp_jvp_tf32x3_f256, 32-row tiles, the
    residuals in shared memory): every launch from the ``_f256`` library,
    two launches equal to the bit."""
    _card()
    w = with_tf32_weights(pack_layer(_params256(), 0, F256, torch.float32, "cuda"))
    args = _edge_rows(F256, r, k)
    key = ("fused_edge_mlp_jvp", "fused_edge_mlp_jvp_tf32x3_f256")
    before = _build.ROUTE_LAUNCHES.get(key, 0)
    out, again = pk.fused_edge_mlp_jvp(*args, w), pk.fused_edge_mlp_jvp(*args, w)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES[key] == before + 2
    assert torch.equal(out, again)
    _assert_close([out], [pk.edge_mlp_jvp_reference(*args, w.phi, w.w)], torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("name,f_in", [("combine", 4 * F256), ("latent combine", 3 * F256),
                                       ("update_0.mlp", 2 * F256), ("readout.mlp", F256)])
def test_fused_mlp_f256_matches_plain(name, f_in):
    """B6 at F = 256 (fused_mlp_tf32x3_f256, 32 columns a warp, 256-column
    chunks) at one row, a tile and one row, the 464 node rows of 16 chains
    and 2432: every launch from the ``_f256`` library, two to the bit."""
    _card()
    w = mlp_weights(_params256(), "combine" if name == "latent combine" else name)
    pack = pk.pack_mlp(w._replace(w1=w.w1[:f_in]), "cuda")
    key = ("fused_mlp", "fused_mlp_tf32x3_f256")
    for r in (1, 17, 464, 2432):
        x = _rows(r, f_in, seed=r)
        before = _build.ROUTE_LAUNCHES.get(key, 0)
        out, again = pk.fused_mlp(x, pack), pk.fused_mlp(x, pack)
        torch.cuda.synchronize()
        assert _build.ROUTE_LAUNCHES[key] == before + 2
        assert torch.equal(out, again)
        _assert_close([out], [pk._mlp_block(x, pack.w)], torch.float32)
