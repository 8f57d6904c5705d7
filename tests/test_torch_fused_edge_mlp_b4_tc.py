"""Kernel B4 in f32 on the tensor cores (csrc/fused_edge_mlp_tf32x3.cu,
3xTF32), as far as the CPU reaches it: the route table of
``fused_edge_mlp``, the kernel's shared memory and work split (one 64-row
tile a CTA, two CTAs an SM), the 3xTF32 packing that ``pack_fused``
attaches and ``fused_edge_mlp_diff`` hands to B4, and a plain-torch model
of the kernel's arithmetic held against the JAX Pallas kernel in
interpret mode. The kernel itself runs only on the card
(tests/test_torch_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.ops import pallas_kernels as jpk
from ti_torch.models.convert import params_from_flax
from ti_torch.ops import _build
from ti_torch.ops import pallas_kernels as tpk
from ti_torch.ops.mlp_block import MLPWeights, _ln_silu_block
from ti_torch.ops.pair_layer_kernel import (
    SMEM_LIMIT,
    TC_ROWS,
    pack_layer,
    pack_pair_mlps,
    pack_tf32_weights,
    split_tf32,
    with_tf32_weights,
)

H100_SMS = 132
SM_SMEM = 233_472   # bytes of shared memory an H100 SM holds (228 KB)
CTA_RESERVED = 1024  # of which the card keeps back per resident CTA
SM_REGISTERS = 65_536
BAR = 2e-5          # max |kernel - reference| / max |reference| in f32, as on the card


def _weights(f: int, seed: int = 0):
    rng = np.random.default_rng(seed)

    def mlp(f_in):
        def t(*shape):
            return torch.as_tensor(rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[0]))

        return MLPWeights(t(f_in, f), t(f), 1 + 0.1 * t(f), t(f), t(f, f), t(f), 1 + 0.1 * t(f), t(f),
                          t(f, 5 * f), t(5 * f))

    return pack_pair_mlps(mlp(2 * f), mlp(f), torch.float32, "cpu")


def _rows(f: int, r: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.standard_normal((r, 2 * f)).astype(np.float32)),
            torch.as_tensor(rng.standard_normal((r, f)).astype(np.float32)))


@pytest.mark.parametrize("variant,lib", [("tc", "fused_edge_mlp_tf32x3"),
                                         ("fma", "fused_edge_mlp")])
def test_route_table(variant, lib):
    assert tpk._edge_route(variant) == lib
    assert lib in _build.KERNELS


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="variant must be one of"):
        tpk._edge_route("mma")
    with pytest.raises(ValueError, match="variant must be one of"):  # on the CPU as well
        tpk.fused_edge_mlp(*_rows(16, 5), _weights(16), variant="wgmma")


@pytest.mark.parametrize("variant", ["tc", "fma"])
def test_cpu_tensors_take_the_plain_version(variant):
    """On the CPU either variant is the plain version, bit for bit, with no
    launch and no packing needed (these weights carry none)."""
    wts = _weights(16)
    assert wts.mma is None
    args = _rows(16, 70)
    before, routes = dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES)
    calls = tpk.PLAIN_CALLS["fused_edge_mlp"]
    out = tpk.fused_edge_mlp(*args, wts, variant=variant)
    assert tpk.PLAIN_CALLS["fused_edge_mlp"] == calls + 1
    assert _build.LAUNCHES == before and _build.ROUTE_LAUNCHES == routes
    assert torch.equal(out, tpk.fused_edge_mlp_reference(*args, wts.phi, wts.w))


def test_shared_memory_fits_two_ctas_an_sm():
    """The [in] and [pe] tiles, 98,304 bytes: within what one CTA may take,
    two CTAs (with the card's 1 KB each) fit an SM and three do not, and two
    CTAs of 256 threads leave 128 registers a thread."""
    smem = tpk.tc_edge_smem_bytes()
    assert smem == 4 * TC_ROWS * 3 * 128 == 98_304 <= SMEM_LIMIT
    assert tpk.EDGE_CTAS_PER_SM * (smem + CTA_RESERVED) <= SM_SMEM
    assert (tpk.EDGE_CTAS_PER_SM + 1) * (smem + CTA_RESERVED) > SM_SMEM
    assert SM_REGISTERS // (tpk.EDGE_CTAS_PER_SM * 256) == 128


@pytest.mark.parametrize("r", [1, 5, 63, 64, 65, 11_552, 43_776, 46_208])
def test_work_split_covers_every_row_once(r):
    """A numpy model of the kernel's split: CTA c stages rows
    [64 c, 64 c + 64) (zero from row R on) and stores those below R. Every
    row is stored exactly once, no CTA is empty, and the CTAs run in
    ceil(ctas / (2 x 132)) waves: the dense_fused sampler's 11,552 rows
    (32 chains) in one, the 43,776 edge rows of fused_velocity_fn and the
    46,208 pair rows of 128 chains in three."""
    plan = tpk.edge_plan(r, H100_SMS)
    assert plan.ctas == -(-r // TC_ROWS) and plan.resident == 2 * H100_SMS
    seen = np.zeros(r, np.int64)
    for cta in range(plan.ctas):
        rows = cta * TC_ROWS + np.arange(TC_ROWS)
        stored = rows < r
        assert stored.any()
        np.add.at(seen, rows[stored], 1)
    assert (seen == 1).all()
    assert plan.waves == -(-plan.ctas // plan.resident)
    want = {11_552: (181, 1), 43_776: (684, 3), 46_208: (722, 3)}
    if r in want:
        assert (plan.ctas, plan.waves) == want[r]


def test_pack_fused_attaches_the_packing_once(monkeypatch):
    """Every message layer of ``pack_fused`` carries ``pack_tf32_weights``
    of itself, made once by ``fused_velocity_fn``; each forward hands it to
    B4 and packs nothing more."""
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models import cpainn_fused
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops import pair_layer_kernel

    torch.manual_seed(0)
    model = CPaiNN(16, 2, n_atoms=5)
    template = graph_template(make_synthetic_molecule(5, seed=0), t_cond=2)
    count = {"n": 0}
    real = pair_layer_kernel.pack_tf32_weights

    def counting(wts):
        count["n"] += 1
        return real(wts)

    monkeypatch.setattr(pair_layer_kernel, "pack_tf32_weights", counting)
    seen = []
    real_b4 = cpainn_fused.fused_edge_mlp

    def spy(in_feat, pe, wts, *a, **kw):
        seen.append(wts)
        return real_b4(in_feat, pe, wts, *a, **kw)

    monkeypatch.setattr(cpainn_fused, "fused_edge_mlp", spy)
    drift = cpainn_fused.fused_velocity_fn(model, None, template, device="cpu")
    assert count["n"] == 2
    x = 0.3 * torch.as_tensor(np.random.default_rng(2).standard_normal((2, 5, 3)), dtype=torch.float32)
    temps = torch.tensor([[700.0, 300.0]]).expand(2, 2)
    drift(x, 0.5, temps)
    drift(x, 0.7, temps)
    assert count["n"] == 2 and len(seen) == 4
    for w in seen:
        assert w.mma is not None and torch.equal(w.mma, real(w))
    packed = cpainn_fused.pack_fused(model, None, "cpu")
    assert all(torch.equal(w.mma, real(w)) for w in packed.messages)


def test_fused_edge_mlp_diff_hands_the_packing_to_b4(monkeypatch):
    """The forward of ``fused_edge_mlp_diff`` (``_FusedEdgeMLP.forward``)
    passes the layer's own 3xTF32 packing to ``fused_edge_mlp``, so B4 on
    the tensor cores can read it."""
    wts = with_tf32_weights(_weights(16))
    x, pe = _rows(16, 9)
    seen = []
    real = tpk.fused_edge_mlp

    def spy(in_feat, pe_, w, *a, **kw):
        seen.append(w.mma)
        return real(in_feat, pe_, w, *a, **kw)

    monkeypatch.setattr(tpk, "fused_edge_mlp", spy)
    out = tpk.fused_edge_mlp_diff(x, pe, wts)
    assert len(seen) == 1 and seen[0] is not None
    assert seen[0].data_ptr() == wts.mma.data_ptr() and seen[0].shape == wts.mma.shape
    assert torch.equal(out, tpk.fused_edge_mlp_reference(x, pe, wts.phi, wts.w))


def _trunc(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared: the kernel's A hi part."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, w: torch.Tensor, terms: str) -> torch.Tensor:
    """a @ w as the kernel forms it: A split by truncation (hi = trunc(a),
    lo = a - hi as the tensor core reads it), the weights by ``split_tf32``;
    per two k-steps (16 of K) the products lo·w_hi + hi·w_lo + hi·w_hi
    ("3x") or hi·w_hi alone ("1x", plain TF32), in f64, rounded to f32 into
    a fresh accumulator, which is added to the running sum in f32."""
    hi = _trunc(a)
    lo = split_tf32(a - hi)[0]
    w_hi, w_lo = split_tf32(w)
    d = torch.float64
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 16):
        ks = slice(k0, k0 + 16)
        z = hi[:, ks].to(d) @ w_hi[ks].to(d)
        if terms == "3x":
            z = z + lo[:, ks].to(d) @ w_hi[ks].to(d) + hi[:, ks].to(d) @ w_lo[ks].to(d)
        acc = acc + z.to(torch.float32)
    return acc


def _model_b4(x, pe, wts, terms):
    def mlp(a, w):
        h = _ln_silu_block(_mm(a, w.w1, terms) + w.b1, w.ln1_scale, w.ln1_bias)
        h = _ln_silu_block(_mm(h, w.w2, terms) + w.b2, w.ln2_scale, w.ln2_bias)
        return _mm(h, w.w3, terms) + w.b3

    return mlp(x, wts.phi) * mlp(pe, wts.w)


def test_3xtf32_model_meets_the_f32_bar_against_pallas_and_1xtf32_does_not():
    """B4's arithmetic (truncation split, three TF32 products, two k-steps a
    fresh accumulator, over phi, w and their product) on a JAX CPaiNN's
    first message layer at F = 16, converted by ``params_from_flax``, is
    within the card's f32 bar (2e-5 of max |ref|) of the JAX Pallas kernel
    in interpret mode; with plain TF32 products it is not."""
    f, r = 16, 40
    jt = jax_template(jax_molecule(5, seed=0), t_cond=2)
    jp = JaxCPaiNN(n_features=f, score_layers=1, conditioning="ambient").init(
        jax.random.PRNGKey(3), jt)
    msg = jp["params"]["message_0"]
    wts = pack_layer(params_from_flax(jax.tree_util.tree_map(np.asarray, jp)), 0, f,
                     torch.float32, "cpu")
    x, pe = _rows(f, r, seed=7)
    ref = np.asarray(jpk.fused_edge_mlp(jnp.asarray(x.numpy()), jnp.asarray(pe.numpy()),
                                        jpk.mlp_weights_from_flax(msg["phi"]),
                                        jpk.mlp_weights_from_flax(msg["w"]), tile=32,
                                        interpret=True))
    scale = np.abs(ref).max()
    err3 = np.abs(_model_b4(x, pe, wts, "3x").numpy() - ref).max() / scale
    err1 = np.abs(_model_b4(x, pe, wts, "1x").numpy() - ref).max() / scale
    assert err3 <= BAR, err3
    assert err1 > BAR, err1
    assert err3 * 20 < err1
    assert torch.equal(with_tf32_weights(wts).mma, pack_tf32_weights(wts))
