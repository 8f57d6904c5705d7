"""Kernels B4, B5 and B6 at F = 256, the 10506 model's width (libraries
``fused_edge_mlp_tf32x3_f256``, ``fused_edge_mlp_jvp_tf32x3_f256`` and
``fused_mlp_tf32x3_f256``: csrc/fused_edge_mlp_tf32x3.cu,
csrc/fused_edge_mlp_jvp_tf32x3.cu and csrc/fused_mlp_tf32x3.cu built with
-DPK_F=256), as far as the CPU reaches them: their plain versions against
the JAX Pallas kernels in interpret mode, ``apply_fused`` and
``apply_dense(fused=True)`` against ``ti_tpu``, the route table, shared
memory, scratch and work split at F = 256, the 3xTF32 packings the kernels
read, a plain-torch model of the kernels' arithmetic at this width, and
the refusals that stay (F = 64 and 32; ``variant="fma"`` at F = 256). The
kernels run only on the card (tests/test_torch_gpu.py, ``-k f256``).

Bars: the kernels' rtol 1e-4 / atol 1e-4 of tests/test_pallas_kernels.py;
forwards rtol 1e-4 / atol 1e-5 (two BLAS libraries sum in different
orders); the arithmetic model 2e-5 of max |ref|, the card's f32 bar.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.models.cpainn_dense import apply_dense as jax_apply_dense
from ti_tpu.models.cpainn_fused import apply_fused as jax_apply_fused
from ti_tpu.models.embeddings import MLP as JaxMLP
from ti_tpu.ops import pallas_kernels as jpk
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.convert import params_from_flax
from ti_torch.models.cpainn import CPaiNN
from ti_torch.models.cpainn_dense import apply_dense, pack_message_layers
from ti_torch.models.cpainn_fused import apply_fused, pack_fused
from ti_torch.ops import _build
from ti_torch.ops import pair_layer_kernel as plk
from ti_torch.ops import pallas_kernels as tpk
from ti_torch.ops.mlp_block import MLPWeights, _ln_silu_block, mlp_weights

F256 = 256
R = 40  # rows: a 32-row tile and a partial one at F = 256
N_ATOMS, LAYERS, B = 4, 2, 2
KERNEL_BAR = dict(rtol=1e-4, atol=1e-4)
FORWARD_BAR = dict(rtol=1e-4, atol=1e-5)
BAR = 2e-5  # max |model - ref| / max |ref| in f32, as on the card
H100_SMS = 132
H100_L2 = 50 * 2 ** 20
SM_SMEM = 233_472   # bytes of shared memory an H100 SM holds (228 KB)
CTA_RESERVED = 1024  # of which the card keeps back per resident CTA
ROUTE = "F = 64, 128 and 256 run in B1, B2 and B3 on the tensor cores"
LIBS = {"fused_edge_mlp_tf32x3_f256": "fused_edge_mlp_tf32x3",
        "fused_edge_mlp_jvp_tf32x3_f256": "fused_edge_mlp_jvp_tf32x3",
        "fused_mlp_tf32x3_f256": "fused_mlp_tf32x3"}
MLP_SHAPES = [(4 * F256, F256), (3 * F256, F256), (2 * F256, 3 * F256), (F256, 2)]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _mlp_weights(p):
    """The port's MLPWeights of a flax MLP param subtree."""
    names = {"w1": ("Dense_0", "kernel"), "b1": ("Dense_0", "bias"),
             "ln1_scale": ("LayerNorm_0", "scale"), "ln1_bias": ("LayerNorm_0", "bias"),
             "w2": ("Dense_1", "kernel"), "b2": ("Dense_1", "bias"),
             "ln2_scale": ("LayerNorm_1", "scale"), "ln2_bias": ("LayerNorm_1", "bias"),
             "w3": ("Dense_2", "kernel"), "b3": ("Dense_2", "bias")}
    return MLPWeights(**{k: torch.tensor(np.array(p[a][b], np.float32))
                         for k, (a, b) in names.items()})


@pytest.fixture(scope="module")
def mlps():
    """Flax weights of phi (2F -> 5F) and w (F -> 5F) at F = 256, numpy rows."""
    rng = np.random.default_rng(0)
    in_feat = rng.standard_normal((R, 2 * F256)).astype(np.float32)
    pe = rng.standard_normal((R, F256)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    phi_p = JaxMLP(F256, 5 * F256).init(jax.random.fold_in(key, 2), in_feat)["params"]
    w_p = JaxMLP(F256, 5 * F256).init(jax.random.fold_in(key, 3), pe)["params"]
    wts = plk.pack_pair_mlps(_mlp_weights(phi_p), _mlp_weights(w_p), torch.float32, "cpu")
    return in_feat, pe, jpk.mlp_weights_from_flax(phi_p), jpk.mlp_weights_from_flax(w_p), wts, rng


@pytest.fixture(scope="module")
def model():
    """A JAX CPaiNN at F = 256 (4 atoms, 2 layers), its weights converted,
    and 2 chains."""
    jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=2)
    jm = JaxCPaiNN(n_features=F256, score_layers=LAYERS, conditioning="ambient")
    jp = jm.init(jax.random.PRNGKey(0), jt)
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    tm = CPaiNN(F256, LAYERS, n_atoms=N_ATOMS)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2)
    rng = np.random.default_rng(1)
    x = (0.3 * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    x -= x.mean(axis=1, keepdims=True)
    t = np.array([0.3, 0.8], np.float32)
    temps = np.tile(np.array([700.0, 300.0], np.float32), (B, 1))
    return jm, jp, jt, params, tm, template, x, t, temps


# ---- B4, B5, B6 at F = 256: plain versions against the Pallas kernels ----

def test_fused_edge_mlp_plain_matches_pallas_at_f256(mlps):
    in_feat, pe, phi, w, wts, _ = mlps
    ref = jpk.fused_edge_mlp(jnp.asarray(in_feat), jnp.asarray(pe), phi, w, tile=32,
                             interpret=True)
    out = tpk.fused_edge_mlp(_t(in_feat), _t(pe), plk.with_tf32_weights(wts))
    assert out.shape == (R, 5 * F256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_BAR)


def test_fused_edge_mlp_jvp_plain_matches_pallas_at_f256(mlps):
    in_feat, pe, phi, w, wts, rng = mlps
    din = rng.standard_normal((2, R, 2 * F256)).astype(np.float32)
    dpe = rng.standard_normal((2, R, F256)).astype(np.float32)
    out = tpk.fused_edge_mlp_jvp(_t(in_feat), _t(pe), _t(din), _t(dpe), wts)
    assert out.shape == (2, R, 5 * F256)
    for k in range(2):
        ref = jpk.fused_edge_mlp_jvp(jnp.asarray(in_feat), jnp.asarray(pe), jnp.asarray(din[k]),
                                     jnp.asarray(dpe[k]), phi, w, tile=32, interpret=True)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref), **KERNEL_BAR)


@pytest.mark.parametrize("f_in,f_out", [(4 * F256, F256), (2 * F256, 3 * F256), (F256, 2)])
def test_fused_mlp_plain_matches_pallas_at_f256(f_in, f_out):
    """The combine (4F -> F), update (2F -> 3F) and readout (F -> 2) at F =
    256."""
    x = np.random.default_rng(f_in + f_out).standard_normal((R, f_in)).astype(np.float32)
    p = JaxMLP(F256, f_out).init(jax.random.PRNGKey(f_out), x)["params"]
    ref = jpk.fused_mlp(jnp.asarray(x), jpk.mlp_weights_from_flax(p), tile=32, interpret=True)
    out = tpk.fused_mlp(_t(x), tpk.pack_mlp(_mlp_weights(p), "cpu"))
    assert out.shape == (R, f_out)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_BAR)


# ---- the fused forwards at F = 256 -----------------------------------------

def test_apply_fused_matches_jax_at_f256(model):
    """``apply_fused`` (B4 and B6 through their plain versions on the CPU)
    against the JAX fused forward in interpret mode, and against
    ``apply_dense``; one B4 a layer and layers + 2 B6 calls, no launch."""
    jm, jp, jt, params, tm, template, x, t, temps = model
    ref = np.asarray(jax_apply_fused(jm, jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps),
                                     jt.atom_ids, jt.edges, interpret=True, tile=32))
    _build.reset_launches()
    before = dict(tpk.PLAIN_CALLS)
    out = apply_fused(tm, params, _t(x), _t(t), _t(temps), template.atom_ids, template.edges)
    calls = {k: tpk.PLAIN_CALLS[k] - before[k] for k in before}
    assert calls == {"fused_edge_mlp": LAYERS, "fused_edge_mlp_jvp": 0, "fused_mlp": LAYERS + 2}
    assert sum(_build.LAUNCHES.values()) == 0
    np.testing.assert_allclose(out.numpy(), ref, **FORWARD_BAR)
    dense = apply_dense(tm, params, _t(x), _t(t), _t(temps), template.atom_ids, template.edges)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), **FORWARD_BAR)


def test_apply_dense_fused_matches_jax_at_f256(model):
    """``apply_dense(fused=True)`` with the packing ``molecular_v_fn_of``
    makes (``pack_message_layers``) against the JAX dense forward with its
    fused edge MLP in interpret mode, and against the unfused forward."""
    jm, jp, jt, params, tm, template, x, t, temps = model
    ref = np.asarray(jax_apply_dense(jm, jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps),
                                     jt.atom_ids, jt.edges, fused=True, tile=32, interpret=True))
    args = (tm, params, _t(x), _t(t), _t(temps), template.atom_ids, template.edges)
    packed = pack_message_layers(tm, params, "cpu")
    out = apply_dense(*args, fused=True, packed=packed).numpy()
    np.testing.assert_allclose(out, ref, **FORWARD_BAR)
    np.testing.assert_allclose(out, apply_dense(*args).numpy(), **FORWARD_BAR)


# ---- routes, builds and refusals ------------------------------------------

@pytest.mark.parametrize("route,variant,f,lib", [
    (tpk._edge_route, "tc", 256, "fused_edge_mlp_tf32x3_f256"),
    (tpk._edge_route, "tc", 128, "fused_edge_mlp_tf32x3"),
    (tpk._edge_route, "tc", 64, "fused_edge_mlp_tf32x3"),
    (tpk._edge_route, "fma", 256, "fused_edge_mlp"),
    (tpk._jvp_route, "tc", 256, "fused_edge_mlp_jvp_tf32x3_f256"),
    (tpk._jvp_route, "tc", 128, "fused_edge_mlp_jvp_tf32x3"),
    (tpk._jvp_route, "tc", 32, "fused_edge_mlp_jvp_tf32x3"),
    (tpk._jvp_route, "fma", 256, "fused_edge_mlp_jvp"),
    (tpk._mlp_route, "tc", 256, "fused_mlp_tf32x3_f256"),
    (tpk._mlp_route, "tc", 128, "fused_mlp_tf32x3"),
    (tpk._mlp_route, "tc", 64, "fused_mlp_tf32x3"),
    (tpk._mlp_route, "fma", 256, "fused_mlp"),
])
def test_route_table_at_f256(route, variant, f, lib):
    """``"tc"`` takes the ``_f256`` build at F = 256 and the F = 128
    library at every width no library is built for (whose launch check then
    refuses it); ``"fma"`` keeps its F = 128 library."""
    assert route(variant, f) == lib
    assert lib in _build.KERNELS
    assert plk.LIB_WIDTHS.get(lib, plk.KERNEL_F) == (256 if lib in LIBS else 128)


@pytest.mark.parametrize("lib", sorted(LIBS))
def test_f256_library_is_built_from_its_f128_source(lib):
    """Each ``_f256`` library is its F = 128 source built with -DPK_F=256,
    whose C functions keep their names."""
    assert lib in _build.KERNELS and LIBS[lib] in _build.KERNELS
    assert _build.BUILT_FROM[lib] == (LIBS[lib], ("-DPK_F=256",))
    assert _build.source_of(lib) == LIBS[lib]
    assert (_build.CSRC / f"{LIBS[lib]}.cu").exists()
    assert plk.width_library(LIBS[lib], F256) == lib


def _on_card(monkeypatch):
    """Send CPU tensors down the wrappers' card route (their checks and
    routing), with ``_build.load`` recording the library and stopping there."""
    class Loaded(Exception):
        pass

    monkeypatch.setattr(tpk, "_on_card", lambda x, what: True)

    def load(name):
        raise Loaded(name)

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=H100_SMS))
    return Loaded


def _edge_args(f: int, k: int = 0):
    rng = np.random.default_rng(f)
    rows = [_t(rng.standard_normal((5, 2 * f))), _t(rng.standard_normal((5, f)))]
    if k:
        rows += [_t(rng.standard_normal((k, 5, 2 * f))), _t(rng.standard_normal((k, 5, f)))]
    mlp = lambda f_in: MLPWeights(*(_t(rng.standard_normal(s) / np.sqrt(s[0])) for s in (
        (f_in, f), (f,), (f,), (f,), (f, f), (f,), (f,), (f,), (f, 5 * f), (5 * f,))))
    return rows, plk.with_tf32_weights(plk.pack_pair_mlps(mlp(2 * f), mlp(f), torch.float32, "cpu"))


def _mlp(f_in: int, f: int, f_out: int, seed: int = 0) -> MLPWeights:
    rng = np.random.default_rng(seed)

    def t(*shape):
        return _t(rng.standard_normal(shape) / np.sqrt(shape[0]))

    return MLPWeights(t(f_in, f), t(f), 1 + 0.1 * t(f), t(f), t(f, f), t(f), 1 + 0.1 * t(f), t(f),
                      t(f, f_out), t(f_out))


def test_f256_launches_reach_the_f256_libraries(monkeypatch):
    """On the card's route, F = 256 passes every check of B4, B5 and B6 and
    loads the ``_f256`` library (nothing falls back to a plain version)."""
    loaded = _on_card(monkeypatch)
    calls = dict(tpk.PLAIN_CALLS)
    rows, wts = _edge_args(F256)
    with pytest.raises(loaded, match="^fused_edge_mlp_tf32x3_f256$"):
        tpk.fused_edge_mlp(*rows, wts)
    rows, wts = _edge_args(F256, k=3)
    with pytest.raises(loaded, match="^fused_edge_mlp_jvp_tf32x3_f256$"):
        tpk.fused_edge_mlp_jvp(*rows, wts)
    for f_in, f_out in MLP_SHAPES:
        with pytest.raises(loaded, match="^fused_mlp_tf32x3_f256$"):
            tpk.fused_mlp(_t(np.ones((5, f_in))), tpk.pack_mlp(_mlp(f_in, F256, f_out), "cpu"))
    assert tpk.PLAIN_CALLS == calls


@pytest.mark.parametrize("f", [64, 32])
def test_other_widths_are_refused_on_the_card(monkeypatch, f):
    """F = 64 and 32 are built by no B4, B5 or B6 library: each wrapper's
    card route refuses the width, naming the routes that run, and calls no
    plain version."""
    _on_card(monkeypatch)
    calls = dict(tpk.PLAIN_CALLS)
    rows, wts = _edge_args(f)
    with pytest.raises(plk.WidthRefusal,
                       match=f"fused_edge_mlp_tf32x3 is built for F=128, got F={f}; {ROUTE}"):
        tpk.fused_edge_mlp(*rows, wts)
    rows, wts = _edge_args(f, k=2)
    with pytest.raises(plk.WidthRefusal,
                       match=f"fused_edge_mlp_jvp_tf32x3 is built for F=128, got F={f}; {ROUTE}"):
        tpk.fused_edge_mlp_jvp(*rows, wts)
    with pytest.raises(plk.WidthRefusal,
                       match=f"fused_mlp_tf32x3 takes hidden width F=128, got F={f}; {ROUTE}"):
        tpk.fused_mlp(_t(np.ones((5, 2 * f))), tpk.pack_mlp(_mlp(2 * f, f, 3 * f), "cpu"))
    assert tpk.PLAIN_CALLS == calls


def test_fma_is_refused_at_f256_on_the_card(monkeypatch):
    """The f32-FMA kernels stay built at F = 128 only."""
    _on_card(monkeypatch)
    rows, wts = _edge_args(F256)
    with pytest.raises(plk.WidthRefusal, match=f"fused_edge_mlp is built for F=128, got F=256; "
                                               f"{ROUTE}"):
        tpk.fused_edge_mlp(*rows, wts, variant="fma")
    rows, wts = _edge_args(F256, k=2)
    with pytest.raises(plk.WidthRefusal, match="fused_edge_mlp_jvp is built for F=128, got F=256"):
        tpk.fused_edge_mlp_jvp(*rows, wts, variant="fma")
    with pytest.raises(plk.WidthRefusal, match="fused_mlp takes hidden width F=128, got F=256"):
        tpk.fused_mlp(_t(np.ones((5, F256))), tpk.pack_mlp(_mlp(F256, F256, 2), "cpu"),
                      variant="fma")


# ---- shared memory, scratch and work split at F = 256 ------------------------

def test_b4_tiles_and_shared_memory_at_f256():
    """32-row tiles at F = 256: the [in] (32 x 512) and [pe] (32 x 256)
    tiles take F = 128's 98,304 bytes, so two CTAs still share an SM (three
    do not); at the 10506 shapes (13,456 dense pair rows of 16 chains, 12,992
    edge rows) the CTAs run in two waves."""
    assert tpk.edge_tile_rows(F256) == 32 and tpk.edge_tile_rows() == plk.TC_ROWS == 64
    smem = tpk.tc_edge_smem_bytes(F256)
    assert smem == tpk.tc_edge_smem_bytes() == 4 * 32 * 3 * F256 == 98_304 <= plk.SMEM_LIMIT
    assert tpk.EDGE_CTAS_PER_SM * (smem + CTA_RESERVED) <= SM_SMEM
    assert (tpk.EDGE_CTAS_PER_SM + 1) * (smem + CTA_RESERVED) > SM_SMEM
    assert tpk.edge_plan(16 * 29 * 29, H100_SMS, F256) == (421, 264, 2)
    assert tpk.edge_plan(16 * 29 * 28, H100_SMS, F256) == (406, 264, 2)


@pytest.mark.parametrize("r", [1, 31, 32, 33, 12_992, 13_456])
def test_b4_work_split_covers_every_row_once_at_f256(r):
    """A numpy model of the split at F = 256: CTA c stages rows [32 c, 32 c
    + 32) and stores those below R; warp w owns the tile's 32 rows and
    columns [32 w, 32 w + 32) of each F-wide chunk, so every (row, column)
    of the (R, 5F) output is stored exactly once."""
    plan = tpk.edge_plan(r, H100_SMS, F256)
    tr = tpk.edge_tile_rows(F256)
    seen = np.zeros((r, 5 * F256), np.int64)
    for cta in range(plan.ctas):
        rows = cta * tr + np.arange(tr)
        rows = rows[rows < r]
        assert rows.size
        for w in range(8):
            for k in range(5):
                cols = k * F256 + 32 * w + np.arange(32)
                np.add.at(seen, (rows[:, None], cols[None, :]), 1)
    assert (seen == 1).all()


def test_b5_shared_memory_and_scratch_at_f256():
    """B5's buffers at F = 256 on 32-row tiles (four residual tiles, the
    statistics, [din | in] and [dpe | pe]) take 230,400 bytes: one CTA an
    SM, within what a CTA may take. A CTA's scratch (p, q of a tile) is
    F = 128's 81,920 floats, 43 MB over 132 CTAs: inside the 50 MB L2."""
    smem = tpk.tc_jvp_smem_bytes(F256)
    assert smem == 4 * 32 * (7 * F256 + 8) == 230_400 <= plk.SMEM_LIMIT < 2 * smem
    assert tpk.tc_jvp_smem_bytes() == 231_424
    assert tpk.tc_jvp_scratch(F256) == tpk.TC_JVP_SCRATCH == 10 * 32 * F256 == 81_920
    assert H100_SMS * 4 * tpk.tc_jvp_scratch(F256) < H100_L2
    # one node of 16 chains (K = 32 over 13,456 rows), the exact frame at 4 chains
    assert tpk.jvp_plan(16 * 29 * 29, 32, H100_SMS, F256) == (421, 13_472, 132)
    assert tpk.jvp_plan(4 * 29 * 29, 87, H100_SMS, F256) == (106, 9_222, 132)
    assert tpk.jvp_plan(5, 1, H100_SMS, F256) == (1, 1, 1)


@pytest.mark.parametrize("f_in,f_out", MLP_SHAPES)
def test_b6_shared_memory_and_plan_at_f256(f_in, f_out):
    """B6 at F = 256: 256-column chunks, so a chunk buffer holds a hidden
    activation (32,768 bytes), one CTA an SM; at the 464 node rows of 16
    chains 29 CTAs, all resident at once."""
    assert tpk.MLP_CHUNK == 128  # F = 128's chunk; F = 256 stages 256 columns a chunk
    assert tpk.tc_mlp_smem_bytes(F256) == 4 * 2 * tpk.MLP_ROWS * F256 == 32_768
    assert tpk.mlp_ctas_per_sm(F256) == 1 and tpk.mlp_ctas_per_sm() == tpk.MLP_CTAS_PER_SM == 2
    plan = tpk.mlp_plan(16 * 29, f_in, f_out, F256)
    assert plan == (29, -(-f_out // 8), f_in // F256)
    assert plan.ctas <= tpk.mlp_ctas_per_sm(F256) * H100_SMS


@pytest.mark.parametrize("rows", [1, 17, 464])
@pytest.mark.parametrize("f_in,f_out", MLP_SHAPES)
def test_b6_work_split_covers_every_row_and_column_once_at_f256(rows, f_in, f_out):
    """A numpy model of B6's split at F = 256: 8 warps of 32 hidden columns,
    the last Dense's n-tiles in groups of 4 where they come in 32s (else 2)
    dealt to the warps in turn, 256-column input chunks. Every hidden and
    output (row, column) is computed once, every input element staged once."""
    tm, f = tpk.MLP_ROWS, F256
    hidden = np.zeros((rows, f), np.int64)
    last = np.zeros((rows, f_out), np.int64)
    staged = np.zeros((rows, f_in), np.int64)
    plan = tpk.mlp_plan(rows, f_in, f_out, f)
    nt3 = plan.out_tiles
    gs = 4 if nt3 % (8 * 4) == 0 else 2
    chunks = range(0, tpk.mlp_k_pad(f_in), f)  # a chunk holds a hidden activation
    assert plan.chunks == len(chunks)
    for c in range(plan.ctas):
        real = np.arange(c * tm, min(c * tm + tm, rows))
        for kc in chunks:
            cols = np.arange(kc, min(kc + f, f_in))
            np.add.at(staged, (real[:, None], cols[None, :]), 1)
        for w in range(8):
            np.add.at(hidden, (real[:, None], 32 * w + np.arange(32)[None, :]), 1)
            for nt in range(gs * w, nt3, 8 * gs):
                cols = np.arange(8 * nt, 8 * min(nt + gs, nt3))
                np.add.at(last, (real[:, None], cols[cols < f_out][None, :]), 1)
    assert (hidden == 1).all() and (last == 1).all() and (staged == 1).all()


# ---- the 3xTF32 packings at F = 256 ---------------------------------------

def _unpack_tf32(buf: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """hi + lo of a matrix packed by ``_pack_tf32_matrix``."""
    v = buf.reshape(k // 8, n // 8, 8, 4, 2, 2)  # ks, nt, g, t, hi|lo, e
    return (v[..., 0, :] + v[..., 1, :]).permute(0, 3, 4, 1, 2).reshape(k, n)


def test_message_layer_packing_at_f256():
    """``pack_message_layers`` and ``pack_fused`` at F = 256 attach
    ``pack_tf32_weights`` (2 x 15 F^2 values, each matrix at twice its
    offset), which the wrappers' check accepts; hi + lo of each matrix is
    within 2^-21 of it."""
    torch.manual_seed(0)
    model = CPaiNN(F256, 1, n_atoms=N_ATOMS)
    dense = pack_message_layers(model, None, "cpu")[0]
    fused = pack_fused(model, None, "cpu").messages[0]
    assert torch.equal(dense.mma, fused.mma)
    assert dense.mma.numel() == 2 * 15 * F256 * F256
    assert tpk._tc_weights(dense, dense.mats) is dense.mma
    off = 0
    for m in (dense.phi.w1, dense.phi.w2, dense.phi.w3, dense.w.w1, dense.w.w2, dense.w.w3):
        got = _unpack_tf32(dense.mma[2 * off: 2 * (off + m.numel())], *m.shape)
        assert torch.allclose(got, m, rtol=2 ** -21, atol=0)
        off += m.numel()


@pytest.mark.parametrize("f_in,f_out", MLP_SHAPES)
def test_mlp_packing_at_f256(f_in, f_out):
    """``pack_mlp`` at F = 256: W1 (rows to the k-step), W2 and W3 (columns
    to an n-tile) split into hi and lo within 2^-21; the wrapper's check of
    the packing at this width passes, and a truncated one raises."""
    w = _mlp(f_in, F256, f_out)
    pack = tpk.pack_mlp(w, "cpu")
    k_pad, n_pad = tpk.mlp_k_pad(f_in), tpk.mlp_n_pad(f_out)
    assert pack.tc.numel() == 2 * F256 * (k_pad + F256 + n_pad)
    x = _t(np.ones((3, f_in)))
    assert tpk._tc_mlp_weights(pack, x, F256) is pack.tc
    with pytest.raises(ValueError, match="3xTF32 MLP weights must be"):
        tpk._tc_mlp_weights(pack._replace(tc=pack.tc[:-4]), x, F256)
    m1, m2 = 2 * k_pad * F256, 2 * (k_pad + F256) * F256
    for got, want in ((_unpack_tf32(pack.tc[:m1], k_pad, F256)[:f_in], w.w1),
                      (_unpack_tf32(pack.tc[m1:m2], F256, F256), w.w2),
                      (_unpack_tf32(pack.tc[m2:], F256, n_pad)[:, :f_out], w.w3)):
        assert torch.allclose(got, want, rtol=2 ** -21, atol=0)


# ---- the kernels' arithmetic at F = 256 -------------------------------------

def _trunc(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared: the kernels' A hi part."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w as the kernels form it in 3xTF32: A split by truncation, the
    weights by ``split_tf32``, per two k-steps (16 of K) lo·w_hi + hi·w_lo
    + hi·w_hi in f64, rounded to f32 into a fresh accumulator that is added
    to the running sum in f32."""
    hi = _trunc(a)
    lo = plk.split_tf32(a - hi)[0]
    w_hi, w_lo = plk.split_tf32(w)
    d = torch.float64
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 16):
        ks = slice(k0, k0 + 16)
        z = (hi[:, ks].to(d) @ w_hi[ks].to(d) + lo[:, ks].to(d) @ w_hi[ks].to(d)
             + hi[:, ks].to(d) @ w_lo[ks].to(d))
        acc = acc + z.to(torch.float32)
    return acc


def _model_mlp(x, w: MLPWeights):
    h = _ln_silu_block(_mm(x, w.w1) + w.b1, w.ln1_scale, w.ln1_bias)
    h = _ln_silu_block(_mm(h, w.w2) + w.b2, w.ln2_scale, w.ln2_bias)
    return _mm(h, w.w3) + w.b3


def test_3xtf32_model_meets_the_f32_bar_at_f256(model):
    """B4's and B6's arithmetic over K up to 4F = 1,024 (the combine) on the
    F = 256 JAX CPaiNN's first message layer and combine, update and
    readout MLPs, converted by ``params_from_flax``: within the card's f32
    bar of the JAX Pallas kernels in interpret mode."""
    _jm, jp, _jt, params, *_ = model
    rng = np.random.default_rng(7)
    x, pe = (_t(rng.standard_normal((R, c))) for c in (2 * F256, F256))
    msg = jp["params"]["message_0"]
    wts = plk.pack_layer(params, 0, F256, torch.float32, "cpu")
    ref = np.asarray(jpk.fused_edge_mlp(jnp.asarray(x.numpy()), jnp.asarray(pe.numpy()),
                                        jpk.mlp_weights_from_flax(msg["phi"]),
                                        jpk.mlp_weights_from_flax(msg["w"]), tile=32,
                                        interpret=True))
    got = (_model_mlp(x, wts.phi) * _model_mlp(pe, wts.w)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() <= BAR
    for name, flax in (("combine", ("combine",)), ("update_0.mlp", ("update_0", "mlp")),
                       ("readout.mlp", ("readout", "mlp"))):
        sub = jp["params"]
        for k in flax:
            sub = sub[k]
        w = mlp_weights(params, name)
        xr = _t(rng.standard_normal((R, w.w1.shape[0])))
        ref = np.asarray(jpk.fused_mlp(jnp.asarray(xr.numpy()), jpk.mlp_weights_from_flax(sub),
                                       tile=32, interpret=True))
        err = np.abs(_model_mlp(xr, w).numpy() - ref).max() / np.abs(ref).max()
        assert err <= BAR, (name, err)
