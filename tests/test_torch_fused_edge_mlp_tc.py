"""Kernel B5 in f32 on the tensor cores (csrc/fused_edge_mlp_jvp_tf32x3.cu,
3xTF32), as far as the CPU reaches it: the route table of
``fused_edge_mlp_jvp``, the kernel's shared-memory count, a numpy model of
its persistent work split (row tiles x lanes over the CTAs), the 3xTF32
packing that ``pack_message_layers`` attaches and the custom op carries
under ``vmap``, and a plain-torch model of the kernel's arithmetic on B5's
chain. The kernel itself runs only on the card (tests/test_torch_gpu.py);
the plain version it is held against there is held against the JAX package
in tests/test_torch_fused.py.
"""

import numpy as np
import pytest
import torch
from torch.func import jvp, vmap

from ti_torch.ops import _build
from ti_torch.ops import pallas_kernels as tpk
from ti_torch.ops.mlp_block import BF16, MLPWeights, _ln_silu_jvp
from ti_torch.ops.pair_layer_kernel import (
    SMEM_LIMIT,
    TC_ROWS,
    pack_pair_mlps,
    pack_tf32_weights,
    split_tf32,
    with_mma_weights,
    with_tf32_weights,
)

H100_SMS = 132


def _weights(f: int, dtype=torch.float32, seed: int = 0):
    rng = np.random.default_rng(seed)

    def mlp(f_in):
        def t(*shape):
            return torch.as_tensor(rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[0]))

        return MLPWeights(t(f_in, f), t(f), 1 + 0.1 * t(f), t(f), t(f, f), t(f), 1 + 0.1 * t(f), t(f),
                          t(f, 5 * f), t(5 * f))

    return pack_pair_mlps(mlp(2 * f), mlp(f), dtype, "cpu")


def _rows(f: int, r: int, k: int, seed: int = 1):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))

    return t(r, 2 * f), t(r, f), t(k, r, 2 * f), t(k, r, f)


@pytest.mark.parametrize("variant,lib", [("tc", "fused_edge_mlp_jvp_tf32x3"),
                                         ("fma", "fused_edge_mlp_jvp")])
def test_route_table(variant, lib):
    assert tpk._jvp_route(variant) == lib
    assert lib in _build.KERNELS


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="variant must be one of"):
        tpk._jvp_route("mma")
    wts = _weights(16)
    with pytest.raises(ValueError, match="variant must be one of"):  # on the CPU as well
        tpk.fused_edge_mlp_jvp(*_rows(16, 5, 2), wts, variant="wgmma")


@pytest.mark.parametrize("variant", ["tc", "fma"])
def test_cpu_tensors_take_the_plain_version(variant):
    """On the CPU either variant is the plain version, bit for bit, with no
    launch and no packing needed (these weights carry none)."""
    wts = _weights(16)
    assert wts.mma is None
    args = _rows(16, 70, 3)
    before, routes = dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES)
    calls = tpk.PLAIN_CALLS["fused_edge_mlp_jvp"]
    out = tpk.fused_edge_mlp_jvp(*args, wts, variant=variant)
    assert tpk.PLAIN_CALLS["fused_edge_mlp_jvp"] == calls + 1
    assert _build.LAUNCHES == before and _build.ROUTE_LAUNCHES == routes
    assert torch.equal(out, tpk.edge_mlp_jvp_reference(*args, wts.phi, wts.w))


def test_shared_memory_fits_the_card():
    """Four residual tiles, the statistics, the [in | din] and [pe | dpe]
    tiles: 231,424 bytes, within the 232,448 a CTA may take (one CTA an SM)."""
    assert tpk.tc_jvp_smem_bytes() == 231_424 <= SMEM_LIMIT
    assert 2 * tpk.tc_jvp_smem_bytes() > SMEM_LIMIT
    assert tpk.TC_JVP_SCRATCH == 10 * TC_ROWS * 128  # p and q, 5F each, of one 64-row tile


@pytest.mark.parametrize("k", [1, 3, 57, 87])
@pytest.mark.parametrize("r", [1, 5, 63, 64, 65, 11_552])
def test_work_split_covers_every_lane_and_row_once(r, k):
    """A numpy model of the kernel's loop: CTA c walks units
    [U c / C, U (c + 1) / C) of the tile-major (tile, lane) list, stores the
    rows of the tile below R (the padding of the last tile never), and
    recomputes the primal where the tile changes. Every (lane, row) is
    stored exactly once, the CTAs' loads differ by at most one unit, and the
    primal runs at most once per tile and CTA boundary."""
    plan = tpk.jvp_plan(r, k, H100_SMS)
    assert plan.tiles == -(-r // TC_ROWS) and plan.units == plan.tiles * k
    assert plan.ctas == min(H100_SMS, plan.units)
    seen = np.zeros(k * r, np.int64)
    sizes, primal_passes = [], 0
    covered = 0
    for cta in range(plan.ctas):
        units = np.arange(plan.units * cta // plan.ctas, plan.units * (cta + 1) // plan.ctas)
        assert len(units) and units[0] == covered  # contiguous ranges, in order
        covered = units[-1] + 1
        sizes.append(len(units))
        tiles, lanes = units // k, units % k
        primal_passes += 1 + int(np.count_nonzero(np.diff(tiles)))
        rows = tiles[:, None] * TC_ROWS + np.arange(TC_ROWS)[None, :]
        stored = rows < r
        np.add.at(seen, (lanes[:, None] * r + rows)[stored], 1)
    assert covered == plan.units
    assert (seen == 1).all()
    assert max(sizes) - min(sizes) <= 1
    assert primal_passes <= plan.tiles + plan.ctas - 1
    if (r, k) == (11_552, 57):  # the exact node of 32 chains at 19 atoms
        assert (plan.tiles, plan.units, plan.ctas) == (181, 10_317, 132)
        assert primal_passes < 1.02 * plan.tiles + plan.ctas


def test_pack_message_layers_attaches_the_packing_once(monkeypatch):
    """Every layer carries ``pack_tf32_weights`` of itself, made once when
    the layers are packed: the forward and the exact divergence through
    ``fused_edge_mlp_diff`` pack nothing more."""
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models import cpainn_dense
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops import pair_layer_kernel
    from ti_torch.ops.divergence import divergence_exact

    torch.manual_seed(0)
    model = CPaiNN(16, 2, n_atoms=5)
    template = graph_template(make_synthetic_molecule(5, seed=0), t_cond=2)
    count = {"n": 0}
    real = pair_layer_kernel.pack_tf32_weights

    def counting(wts):
        count["n"] += 1
        return real(wts)

    monkeypatch.setattr(pair_layer_kernel, "pack_tf32_weights", counting)
    layers = cpainn_dense.pack_message_layers(model, None, "cpu")
    assert count["n"] == len(layers) == 2
    for w in layers:
        assert w.mma is not None and torch.equal(w.mma, real(w))
    x = 0.3 * torch.as_tensor(np.random.default_rng(2).standard_normal((2, 5, 3)), dtype=torch.float32)
    temps = torch.tensor([[700.0, 300.0]]).expand(2, 2)

    def v(y):
        return cpainn_dense.apply_dense(model, None, y, torch.full((2,), 0.5), temps,
                                        template.atom_ids, template.edges, fused=True,
                                        packed=layers)

    divergence_exact(v, x)
    assert count["n"] == 2


def test_the_op_carries_the_packing_unbatched(monkeypatch):
    """vmap(jvp) of ``fused_edge_mlp_diff``: the lanes fold into one B5 call
    whose weights carry the layer's own packing, unbatched and unexpanded;
    a batched packing is refused."""
    wts = with_tf32_weights(_weights(16))
    x, pe, din, dpe = _rows(16, 9, 3)
    seen = []
    real = tpk.fused_edge_mlp_jvp

    def spy(in_feat, pe_, din_, dpe_, w, *a, **kw):
        seen.append((w.mma, din_.shape))
        return real(in_feat, pe_, din_, dpe_, w, *a, **kw)

    monkeypatch.setattr(tpk, "fused_edge_mlp_jvp", spy)
    lanes = vmap(lambda a, q: jvp(lambda a2, q2: tpk.fused_edge_mlp_diff(a2, q2, wts), (x, pe),
                                  (a, q))[1])(din, dpe)
    assert len(seen) == 1
    mma, shape = seen[0]
    assert tuple(shape) == (3, 9, 32)
    assert mma.shape == wts.mma.shape and mma.data_ptr() == wts.mma.data_ptr()
    torch.testing.assert_close(lanes, tpk.edge_mlp_jvp_reference(x, pe, din, dpe, wts.phi, wts.w),
                               rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="packing"):
        vmap(lambda p: tpk._edge_mlp_jvp_op(x, pe, din, dpe, wts.mats, wts.vecs, p))(
            torch.stack([wts.mma, wts.mma]))


def test_a_layer_without_its_packing_raises():
    x = torch.zeros(5, 32)
    wts = _weights(16)
    with pytest.raises(ValueError, match="with_tf32_weights"):
        tpk._tc_weights(wts, x)
    packed = with_tf32_weights(wts)
    assert tpk._tc_weights(packed, x) is packed.mma
    with pytest.raises(ValueError, match="3xTF32 weights must be"):
        tpk._tc_weights(packed._replace(mma=packed.mma[:-4]), x)
    with pytest.raises(ValueError, match="3xTF32 weights must be"):  # the bf16 order is not it
        tpk._tc_weights(packed._replace(mma=with_mma_weights(_weights(16, BF16)).mma), x)


def _trunc(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared: the kernel's A hi part."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, w: torch.Tensor, terms: str) -> torch.Tensor:
    """a @ w as the kernel forms it: A split by truncation (hi = trunc(a),
    lo = a - hi as the tensor core reads it), the weights by ``split_tf32``;
    "3x" sums lo·w_hi + hi·w_lo + hi·w_hi, "1x" only hi·w_hi (plain TF32).
    Products and sums in f64, rounded to f32 once."""
    hi = _trunc(a)
    lo = split_tf32(a - hi)[0]
    w_hi, w_lo = split_tf32(w)
    d = torch.float64
    out = hi.to(d) @ w_hi.to(d)
    if terms == "3x":
        out = out + lo.to(d) @ w_hi.to(d) + hi.to(d) @ w_lo.to(d)
    return out.to(torch.float32)


def _model_jvp(x, pe, din, dpe, wts, terms):
    def mlp(a, da, w):
        h, dh = _mm(a, w.w1, terms) + w.b1, _mm(da, w.w1, terms)
        a, da = _ln_silu_jvp(h, dh, w.ln1_scale, w.ln1_bias)
        h, dh = _mm(a, w.w2, terms) + w.b2, _mm(da, w.w2, terms)
        a, da = _ln_silu_jvp(h, dh, w.ln2_scale, w.ln2_bias)
        return _mm(a, w.w3, terms) + w.b3, _mm(da, w.w3, terms)

    p, dp = mlp(x, din, wts.phi)
    q, dq = mlp(pe, dpe, wts.w)
    return dp * q + p * dq


def test_3xtf32_model_of_the_chain_meets_the_f32_bar_and_1xtf32_does_not():
    """B5's chain with every product in the kernel's 3xTF32 arithmetic is
    within the card's f32 bar (2e-5 of max |plain|) of the plain version;
    with plain TF32 products it is not."""
    f = 32
    wts = _weights(f, seed=4)
    args = _rows(f, 96, 3, seed=5)
    ref = tpk.edge_mlp_jvp_reference(*args, wts.phi, wts.w)
    scale = ref.abs().max().item()
    err3 = (_model_jvp(*args, wts, "3x") - ref).abs().max().item() / scale
    err1 = (_model_jvp(*args, wts, "1x") - ref).abs().max().item() / scale
    assert err3 <= 2e-5, err3
    assert err1 > 2e-5, err1
    assert err3 * 20 < err1


def test_tf32_packing_of_the_weights_is_the_layers_own():
    wts = with_tf32_weights(_weights(16))
    assert torch.equal(wts.mma, pack_tf32_weights(wts))
    assert wts.mma.numel() == 2 * wts.mats.numel()
