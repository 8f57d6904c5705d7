"""Kernel B6 in f32 on the tensor cores (csrc/fused_mlp_tf32x3.cu, 3xTF32), as
far as the CPU reaches it: the route table of ``fused_mlp``, the kernel's
shared memory and work split (one 16-row tile a CTA), the 3xTF32 packing
that ``pack_mlp`` attaches once and ``pack_fused`` carries, and a
plain-torch model of the kernel's arithmetic held against the JAX Pallas
kernel in interpret mode. The kernel itself runs only on the card
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
from ti_torch.ops.mlp_block import MLPWeights, _ln_silu_block, _mlp_block, mlp_weights
from ti_torch.ops.pair_layer_kernel import SMEM_LIMIT, split_tf32

H100_SMS = 132
SM_SMEM = 233_472   # bytes of shared memory an H100 SM holds (228 KB)
CTA_RESERVED = 1024  # of which the card keeps back per resident CTA
SM_REGISTERS = 65_536
BAR = 2e-5          # max |kernel - reference| / max |reference| in f32, as on the card
ROWS = (1, 5, 15, 16, 17, 63, 64, 65, 2432, 4097)


def _mlp(f_in: int, f: int, f_out: int, seed: int = 0) -> MLPWeights:
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.as_tensor((rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32))

    return MLPWeights(t(f_in, f), t(f), 1 + 0.1 * t(f), t(f), t(f, f), t(f), 1 + 0.1 * t(f), t(f),
                      t(f, f_out), t(f_out))


def _x(r: int, f_in: int, seed: int = 1) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(seed).standard_normal((r, f_in)).astype(np.float32))


@pytest.mark.parametrize("variant,lib", [("tc", "fused_mlp_tf32x3"), ("fma", "fused_mlp")])
def test_route_table(variant, lib):
    assert tpk._mlp_route(variant) == lib
    assert lib in _build.KERNELS


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="variant must be one of"):
        tpk._mlp_route("mma")
    with pytest.raises(ValueError, match="variant must be one of"):  # on the CPU as well
        tpk.fused_mlp(_x(5, 32), tpk.pack_mlp(_mlp(32, 16, 3), "cpu"), variant="wgmma")


@pytest.mark.parametrize("variant", ["tc", "fma"])
def test_cpu_tensors_take_the_plain_version(variant):
    """On the CPU either variant is the plain version, bit for bit, with no
    launch, and without the 3xTF32 packing too."""
    pack = tpk.pack_mlp(_mlp(32, 16, 3), "cpu")
    x = _x(70, 32)
    before, routes = dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES)
    calls = tpk.PLAIN_CALLS["fused_mlp"]
    out = tpk.fused_mlp(x, pack, variant=variant)
    bare = tpk.fused_mlp(x, pack._replace(tc=None), variant=variant)
    assert tpk.PLAIN_CALLS["fused_mlp"] == calls + 2
    assert _build.LAUNCHES == before and _build.ROUTE_LAUNCHES == routes
    assert torch.equal(out, _mlp_block(x, pack.w)) and torch.equal(bare, out)


def test_shared_memory_registers_and_residency():
    """Two input chunks of MLP_ROWS x 128 f32, which then hold the two
    hidden activations: 16,384 bytes. MLP_CTAS_PER_SM CTAs an SM (at most
    128 registers a thread; their shared memory fits), and at the node rows
    of 128 chains (2432) all 152 CTAs are resident at once on 132 SMs."""
    smem = tpk.tc_mlp_smem_bytes()
    f = 128
    assert smem == 4 * 2 * tpk.MLP_ROWS * tpk.MLP_CHUNK == 16_384 <= SMEM_LIMIT
    assert tpk.MLP_CHUNK == f  # a chunk buffer holds a hidden activation
    assert tpk.MLP_CTAS_PER_SM * (smem + CTA_RESERVED) <= SM_SMEM
    assert SM_REGISTERS // (tpk.MLP_CTAS_PER_SM * 256) == 128
    plan = tpk.mlp_plan(2432, 2 * f, 3 * f)
    assert (plan.ctas, plan.out_tiles, plan.chunks) == (152, 48, 2)
    assert plan.ctas <= tpk.MLP_CTAS_PER_SM * H100_SMS
    assert tpk.mlp_plan(2432, 4 * f, f).chunks == 4 and tpk.mlp_plan(2432, f, 2).out_tiles == 1


def _kernel_split(rows: int, f_in: int, f_out: int, f: int = 128) -> tuple:
    """A numpy model of the kernel's work split, one MLP_ROWS-row tile a CTA
    of 8 warps: how often each (row, hidden column) of the hidden Dense
    layers and each (row, output column) of the last Dense is stored, and
    how often each input element is staged."""
    tm = tpk.MLP_ROWS
    hidden = np.zeros((rows, f), np.int64)
    last = np.zeros((rows, f_out), np.int64)
    staged = np.zeros((rows, f_in), np.int64)
    plan = tpk.mlp_plan(rows, f_in, f_out)
    nt3 = plan.out_tiles
    gs = 3 if nt3 % (8 * 3) == 0 else 2
    assert plan.chunks == len(range(0, tpk.mlp_k_pad(f_in), tpk.MLP_CHUNK))
    for c in range(plan.ctas):
        real = np.arange(c * tm, min(c * tm + tm, rows))  # rows past R are zero, never stored
        for kc in range(0, tpk.mlp_k_pad(f_in), tpk.MLP_CHUNK):  # zero past f_in
            cols = np.arange(kc, min(kc + tpk.MLP_CHUNK, f_in))
            np.add.at(staged, (real[:, None], cols[None, :]), 1)
        for w in range(8):
            np.add.at(hidden, (real[:, None], 16 * w + np.arange(16)[None, :]), 1)
            for nt in range(gs * w, nt3, 8 * gs):  # the last Dense: groups dealt in turn
                cols = np.arange(8 * nt, 8 * min(nt + gs, nt3))
                np.add.at(last, (real[:, None], cols[cols < f_out][None, :]), 1)
    return hidden, last, staged


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("f_in,f_out", [(512, 128), (384, 128), (256, 384), (128, 2), (20, 3)])
def test_work_split_covers_every_row_and_column_once(rows, f_in, f_out):
    """Every (row, column) of each hidden Dense and of the output is
    computed exactly once and every input element staged once; padding rows
    and columns reach no output."""
    hidden, last, staged = _kernel_split(rows, f_in, f_out)
    assert (hidden == 1).all() and (last == 1).all() and (staged == 1).all()


def _unpack_tf32(buf: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """hi + lo of a matrix packed by ``_pack_tf32_matrix``: per (k-step,
    n-tile, g, t) the hi and lo of rows 2t, 2t + 1 of column g."""
    v = buf.reshape(k // 8, n // 8, 8, 4, 2, 2)  # ks, nt, g, t, hi|lo, e
    w = (v[..., 0, :] + v[..., 1, :]).permute(0, 3, 4, 1, 2)  # ks, t, e, nt, g
    return w.reshape(k, n)


@pytest.mark.parametrize("f_in,f_out", [(512, 128), (384, 128), (256, 384), (128, 2), (20, 3)])
def test_pack_mlp_attaches_the_3xtf32_packing(f_in, f_out):
    """``pack_mlp`` attaches ``pack_tf32_mlp`` of the MLP once: W1 with its
    rows padded with zeros to a multiple of 16 (f_in = 20 to 32), W2, and W3
    with its columns padded to a multiple of 8 (the readout's 2 to 8, not to
    F), each hi + lo within 2^-21 of the weights; the f32-FMA layout
    (``mats``) is unchanged."""
    f = 128
    w = _mlp(f_in, f, f_out)
    pack = tpk.pack_mlp(w, "cpu")
    k_pad, n_pad = tpk.mlp_k_pad(f_in), tpk.mlp_n_pad(f_out)
    assert k_pad == -(-f_in // 16) * 16 and n_pad == -(-f_out // 8) * 8
    assert pack.tc.dtype == torch.float32 and pack.tc.is_contiguous()
    assert pack.tc.numel() == 2 * f * (k_pad + f + n_pad)
    assert pack.mats.numel() == (f_in + f + -(-f_out // f) * f) * f
    assert torch.equal(pack.tc, tpk.pack_tf32_mlp(pack.w))
    m1, m2 = 2 * k_pad * f, 2 * (k_pad + f) * f
    w1 = _unpack_tf32(pack.tc[:m1], k_pad, f)
    w2 = _unpack_tf32(pack.tc[m1:m2], f, f)
    w3 = _unpack_tf32(pack.tc[m2:], f, n_pad)
    for got, want in ((w1[:f_in], w.w1), (w2, w.w2), (w3[:, :f_out], w.w3)):
        assert torch.allclose(got, want, rtol=2 ** -21, atol=0)
    assert not w1[f_in:].any() and not w3[:, f_out:].any()


def test_pack_fused_carries_the_packing_once(monkeypatch):
    """Every B6 pack of ``pack_fused`` (combine, one update a layer,
    readout) carries its 3xTF32 packing, made once by ``fused_velocity_fn``;
    each forward hands it to B6 and packs nothing more."""
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models import cpainn_fused
    from ti_torch.models.cpainn import CPaiNN

    torch.manual_seed(0)
    model = CPaiNN(16, 2, n_atoms=5)
    template = graph_template(make_synthetic_molecule(5, seed=0), t_cond=2)
    count = {"n": 0}
    real = tpk.pack_tf32_mlp

    def counting(w):
        count["n"] += 1
        return real(w)

    monkeypatch.setattr(tpk, "pack_tf32_mlp", counting)
    seen = []
    real_b6 = cpainn_fused.fused_mlp

    def spy(x, pack, *a, **kw):
        seen.append(pack)
        return real_b6(x, pack, *a, **kw)

    monkeypatch.setattr(cpainn_fused, "fused_mlp", spy)
    drift = cpainn_fused.fused_velocity_fn(model, None, template, device="cpu")
    assert count["n"] == 4
    x = 0.3 * torch.as_tensor(np.random.default_rng(2).standard_normal((2, 5, 3)), dtype=torch.float32)
    temps = torch.tensor([[700.0, 300.0]]).expand(2, 2)
    drift(x, 0.5, temps)
    drift(x, 0.7, temps)
    assert count["n"] == 4 and len(seen) == 8
    for pack in seen:
        assert pack.tc is not None and torch.equal(pack.tc, real(pack.w))
    packed = cpainn_fused.pack_fused(model, None, "cpu")
    for pack in (packed.combine, *packed.updates, packed.readout):
        assert torch.equal(pack.tc, real(pack.w))


def _trunc(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared: the kernel's A hi part."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, w: torch.Tensor, terms: str) -> torch.Tensor:
    """a @ w as the kernel forms it: A split by truncation (hi = trunc(a),
    lo = a - hi as the tensor core reads it), the weights by ``split_tf32``,
    K padded with zeros to a multiple of 16; per two k-steps (16 of K) the
    products lo·w_hi + hi·w_lo + hi·w_hi ("3x") or hi·w_hi alone ("1x",
    plain TF32), in f64, rounded to f32 into a fresh accumulator, which is
    added to the running sum in f32."""
    pad = -a.shape[1] % 16
    a = torch.nn.functional.pad(a, (0, pad))
    w = torch.nn.functional.pad(w, (0, 0, 0, pad))
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


def _model_b6(x, w: MLPWeights, terms: str):
    h = _ln_silu_block(_mm(x, w.w1, terms) + w.b1, w.ln1_scale, w.ln1_bias)
    h = _ln_silu_block(_mm(h, w.w2, terms) + w.b2, w.ln2_scale, w.ln2_bias)
    return _mm(h, w.w3, terms) + w.b3


@pytest.mark.parametrize("name,flax", [("combine", ("combine",)),
                                       ("update_0.mlp", ("update_0", "mlp")),
                                       ("readout.mlp", ("readout", "mlp"))])
def test_3xtf32_model_meets_the_f32_bar_against_pallas_and_1xtf32_does_not(name, flax):
    """B6's arithmetic (truncation split, three TF32 products, two k-steps a
    fresh accumulator added to the running sum in f32, f32 LayerNorm
    statistics over the whole row) on a JAX CPaiNN's combine
    (4F -> F), update (2F -> 3F) and readout (F -> 2) at F = 16, converted
    by ``params_from_flax``, is within the card's f32 bar (2e-5 of max
    |ref|) of the JAX Pallas kernel in interpret mode; with plain TF32
    products it is not."""
    f, r = 16, 40
    jt = jax_template(jax_molecule(5, seed=0), t_cond=2)
    jp = JaxCPaiNN(n_features=f, score_layers=1, conditioning="ambient").init(
        jax.random.PRNGKey(3), jt)
    sub = jp["params"]
    for k in flax:
        sub = sub[k]
    w = mlp_weights(params_from_flax(jax.tree_util.tree_map(np.asarray, jp)), name)
    x = _x(r, w.w1.shape[0], seed=7)
    ref = np.asarray(jpk.fused_mlp(jnp.asarray(x.numpy()), jpk.mlp_weights_from_flax(sub), tile=32,
                                   interpret=True))
    scale = np.abs(ref).max()
    err3 = np.abs(_model_b6(x, w, "3x").numpy() - ref).max() / scale
    err1 = np.abs(_model_b6(x, w, "1x").numpy() - ref).max() / scale
    assert err3 <= BAR, err3
    assert err1 > BAR, err1
    assert err3 * 20 < err1
    assert torch.equal(tpk.pack_mlp(w, "cpu").tc, tpk.pack_tf32_mlp(w))
