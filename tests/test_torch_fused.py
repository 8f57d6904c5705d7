"""The fused-MLP path of the PyTorch port against the JAX package: kernels
B4 (``fused_edge_mlp``), B5 (``fused_edge_mlp_jvp``) and B6
(``fused_mlp``) through their plain versions on the CPU, the
differentiable ``fused_edge_mlp_diff``, ``cpainn_fused.apply_fused``,
``apply_dense(fused=True)`` and the ``dense_fused`` sampler as a whole.

The JAX side runs its Pallas kernels in interpret mode, on the same flax
weights and numpy inputs. Bars: the kernels' rtol 1e-4 / atol 1e-4 of
tests/test_pallas_kernels.py; forwards rtol 1e-4 / atol 1e-5 (two BLAS
libraries sum in different orders); divergences and dlogp rtol 1e-3, as
the JAX package holds fused against unfused. The CUDA kernels run only on
the card: tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp, vmap

from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.models.cpainn_dense import apply_dense as jax_apply_dense
from ti_tpu.models.cpainn_fused import apply_fused as jax_apply_fused
from ti_tpu.models.embeddings import MLP as JaxMLP
from ti_tpu.ops import pallas_kernels as jpk
from ti_tpu.sampling.drivers import make_ode_sampler as jax_make_ode_sampler
from ti_tpu.sampling.drivers import molecular_v_fn_of as jax_v_fn_of
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.convert import params_from_flax
from ti_torch.models.cpainn import CPaiNN
from ti_torch.models.cpainn_dense import apply_dense
from ti_torch.models.cpainn_fused import apply_fused, fused_velocity_fn
from ti_torch.ops import _build
from ti_torch.ops import pallas_kernels as tpk
from ti_torch.ops.divergence import divergence_exact
from ti_torch.ops.mlp_block import MLPWeights
from ti_torch.ops.pair_layer_kernel import pack_pair_mlps
from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of

F = 16
R = 70  # not a multiple of any tile
N_ATOMS, LAYERS, B = 6, 2, 3
KERNEL_BAR = dict(rtol=1e-4, atol=1e-4)
FORWARD_BAR = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _mlp_weights(p):
    """The port's MLPWeights of a flax MLP param subtree (kernels are
    (in, out) in both)."""
    names = {"w1": ("Dense_0", "kernel"), "b1": ("Dense_0", "bias"),
             "ln1_scale": ("LayerNorm_0", "scale"), "ln1_bias": ("LayerNorm_0", "bias"),
             "w2": ("Dense_1", "kernel"), "b2": ("Dense_1", "bias"),
             "ln2_scale": ("LayerNorm_1", "scale"), "ln2_bias": ("LayerNorm_1", "bias"),
             "w3": ("Dense_2", "kernel"), "b3": ("Dense_2", "bias")}
    return MLPWeights(**{k: torch.tensor(np.array(p[a][b], np.float32))
                         for k, (a, b) in names.items()})


@pytest.fixture(scope="module")
def mlps():
    """Flax MLP weights of phi (2F -> 5F) and w (F -> 5F), numpy rows."""
    rng = np.random.default_rng(0)
    in_feat = rng.standard_normal((R, 2 * F)).astype(np.float32)
    pe = rng.standard_normal((R, F)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    phi_p = JaxMLP(F, 5 * F).init(jax.random.fold_in(key, 2), in_feat)["params"]
    w_p = JaxMLP(F, 5 * F).init(jax.random.fold_in(key, 3), pe)["params"]
    phi, w = jpk.mlp_weights_from_flax(phi_p), jpk.mlp_weights_from_flax(w_p)
    wts = pack_pair_mlps(_mlp_weights(phi_p), _mlp_weights(w_p),
                         torch.float32, "cpu")
    return in_feat, pe, phi, w, wts, rng


@pytest.fixture(scope="module")
def model():
    jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=2)
    jm = JaxCPaiNN(n_features=F, score_layers=LAYERS, conditioning="ambient")
    jp = jm.init(jax.random.PRNGKey(0), jt)
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    tm = CPaiNN(F, LAYERS, n_atoms=N_ATOMS)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2)
    rng = np.random.default_rng(1)
    x = (0.3 * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    x -= x.mean(axis=1, keepdims=True)
    t = np.array([0.2, 0.5, 0.9], np.float32)
    temps = np.tile(np.array([700.0, 300.0], np.float32), (B, 1))
    return jm, jp, jt, params, tm, template, x, t, temps


# ---- B4, B5, B6: plain versions against the Pallas kernels --------------

def test_fused_edge_mlp_plain_matches_pallas(mlps):
    in_feat, pe, phi, w, wts, _ = mlps
    ref = jpk.fused_edge_mlp(jnp.asarray(in_feat), jnp.asarray(pe), phi, w, tile=32,
                             interpret=True)
    before = dict(tpk.PLAIN_CALLS)
    out = tpk.fused_edge_mlp(_t(in_feat), _t(pe), wts)
    assert out.shape == (R, 5 * F)
    assert tpk.PLAIN_CALLS["fused_edge_mlp"] == before["fused_edge_mlp"] + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_BAR)


def test_fused_edge_mlp_jvp_plain_matches_pallas(mlps):
    in_feat, pe, phi, w, wts, rng = mlps
    din = rng.standard_normal((2, R, 2 * F)).astype(np.float32)
    dpe = rng.standard_normal((2, R, F)).astype(np.float32)
    out = tpk.fused_edge_mlp_jvp(_t(in_feat), _t(pe), _t(din), _t(dpe), wts)
    assert out.shape == (2, R, 5 * F)
    for k in range(2):
        ref = jpk.fused_edge_mlp_jvp(jnp.asarray(in_feat), jnp.asarray(pe), jnp.asarray(din[k]),
                                     jnp.asarray(dpe[k]), phi, w, tile=32, interpret=True)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref), **KERNEL_BAR)


@pytest.mark.parametrize("f_in,f_out", [(2 * F, 5 * F), (4 * F, F), (F, 2)])
def test_fused_mlp_plain_matches_pallas(f_in, f_out):
    """The combine (4F -> F) and readout (F -> 2, a masked store on the
    card) widths too."""
    x = np.random.default_rng(f_in + f_out).standard_normal((R, f_in)).astype(np.float32)
    p = JaxMLP(F, f_out).init(jax.random.PRNGKey(f_out), x)["params"]
    ref = jpk.fused_mlp(jnp.asarray(x), jpk.mlp_weights_from_flax(p), tile=32, interpret=True)
    pack = tpk.pack_mlp(_mlp_weights(p), "cpu")
    assert pack.mats.numel() == (f_in + F + -(-f_out // F) * F) * F
    out = tpk.fused_mlp(_t(x), pack)
    assert out.shape == (R, f_out)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_BAR)


# ---- fused_edge_mlp_diff: the tangent comes from its own rule -----------

def test_fused_edge_mlp_diff_jvp_rule(mlps):
    """jvp and vmap(jvp) against the JAX tangent reference; the vmapped
    lanes reach B5's plain version in ONE call, and a lane with no pe
    tangent (as in layer 0 of the dense divergence) is exact too."""
    in_feat, pe, phi, w, wts, rng = mlps
    din = rng.standard_normal((3, R, 2 * F)).astype(np.float32)
    dpe = rng.standard_normal((3, R, F)).astype(np.float32)
    ji, jq = jnp.asarray(in_feat), jnp.asarray(pe)

    def f(a, q):
        return tpk.fused_edge_mlp_diff(a, q, wts)

    out, tan = jvp(f, (_t(in_feat), _t(pe)), (_t(din[0]), _t(dpe[0])))
    np.testing.assert_allclose(out.numpy(), np.asarray(jpk.fused_edge_mlp_reference(ji, jq, phi, w)),
                               **KERNEL_BAR)
    ref0 = jpk.edge_mlp_jvp_reference(ji, jq, jnp.asarray(din[0]), jnp.asarray(dpe[0]), phi, w)
    np.testing.assert_allclose(tan.numpy(), np.asarray(ref0), **KERNEL_BAR)

    before = dict(tpk.PLAIN_CALLS)
    lanes = vmap(lambda a, q: jvp(f, (_t(in_feat), _t(pe)), (a, q))[1])(_t(din), _t(dpe))
    assert tpk.PLAIN_CALLS["fused_edge_mlp_jvp"] == before["fused_edge_mlp_jvp"] + 1
    for k in range(3):
        ref = jpk.edge_mlp_jvp_reference(ji, jq, jnp.asarray(din[k]), jnp.asarray(dpe[k]), phi, w)
        np.testing.assert_allclose(lanes[k].numpy(), np.asarray(ref), **KERNEL_BAR)

    _, one_sided = jvp(lambda a: tpk.fused_edge_mlp_diff(a, _t(pe), wts), (_t(in_feat),),
                       (_t(din[1]),))
    _, ref1 = jax.jvp(lambda a: jpk.fused_edge_mlp_reference(a, jq, phi, w), (ji,),
                      (jnp.asarray(din[1]),))
    np.testing.assert_allclose(one_sided.numpy(), np.asarray(ref1), **KERNEL_BAR)


def test_fused_edge_mlp_diff_weight_tangent_and_no_reverse_mode(mlps):
    """A tangent on the weights (all ones on phi's) goes through the plain
    version's own JVP, as the JAX fallback; B5 is not called. Reverse mode
    raises, as in JAX."""
    in_feat, pe, phi, w, wts, _ = mlps
    dphi = jax.tree.map(jnp.ones_like, phi)
    _, ref = jax.jvp(lambda ph: jpk.fused_edge_mlp_reference(jnp.asarray(in_feat),
                                                             jnp.asarray(pe), ph, w),
                     (phi,), (dphi,))
    n_phi_mats, n_phi_vecs = 8 * F * F, 11 * F
    dmats = torch.zeros_like(wts.mats)
    dmats[:n_phi_mats] = 1.0
    dvecs = torch.zeros_like(wts.vecs)
    dvecs[:n_phi_vecs] = 1.0
    before = dict(tpk.PLAIN_CALLS)
    _, got = jvp(lambda m, v: tpk._FusedEdgeMLP.apply(_t(in_feat), _t(pe), m, v),
                 (wts.mats, wts.vecs), (dmats, dvecs))
    assert tpk.PLAIN_CALLS["fused_edge_mlp_jvp"] == before["fused_edge_mlp_jvp"]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **KERNEL_BAR)

    a = _t(in_feat).requires_grad_()
    with pytest.raises(NotImplementedError, match="forward-mode only"):
        tpk.fused_edge_mlp_diff(a, _t(pe), wts).sum().backward()


# ---- the fused forwards ---------------------------------------------------

def test_apply_fused_matches_jax_and_apply_dense(model):
    jm, jp, jt, params, tm, template, x, t, temps = model
    ref = np.asarray(jax_apply_fused(jm, jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps),
                                     jt.atom_ids, jt.edges, interpret=True, tile=32))
    _build.reset_launches()
    before = dict(tpk.PLAIN_CALLS)
    out = apply_fused(tm, params, _t(x), _t(t), _t(temps), template.atom_ids, template.edges)
    calls = {k: tpk.PLAIN_CALLS[k] - before[k] for k in before}
    assert calls == {"fused_edge_mlp": LAYERS, "fused_edge_mlp_jvp": 0, "fused_mlp": LAYERS + 2}
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors launch nothing
    np.testing.assert_allclose(out.numpy(), ref, **FORWARD_BAR)
    dense = apply_dense(tm, params, _t(x), _t(t), _t(temps), template.atom_ids, template.edges)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), **FORWARD_BAR)
    drift = fused_velocity_fn(tm, params, template, device="cpu")
    torch.testing.assert_close(drift(_t(x), 0.5, _t(temps)),
                               apply_fused(tm, params, _t(x), torch.full((B,), 0.5), _t(temps),
                                           template.atom_ids, template.edges))


def test_apply_dense_fused_matches_jax_and_unfused(model):
    jm, jp, jt, params, tm, template, x, t, temps = model
    ref = np.asarray(jax_apply_dense(jm, jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps),
                                     jt.atom_ids, jt.edges, fused=True, tile=32, interpret=True))
    args = (tm, params, _t(x), _t(t), _t(temps), template.atom_ids, template.edges)
    out = apply_dense(*args, fused=True).numpy()
    np.testing.assert_allclose(out, ref, **FORWARD_BAR)
    np.testing.assert_allclose(out, apply_dense(*args).numpy(), **FORWARD_BAR)
    with pytest.raises(ValueError, match="incompatible"):
        apply_dense(*args, fused=True, compute_dtype=torch.bfloat16)


def test_apply_dense_fused_exact_divergence(model):
    """The exact divergence through B5's rule equals the unfused one
    (torch.func JVPs of the plain composition), one B5 call per layer."""
    _jm, _jp, _jt, params, tm, template, x, t, temps = model

    def v(fused):
        return lambda y: apply_dense(tm, params, y, _t(t[:2]), _t(temps[:2]),
                                     template.atom_ids, template.edges, fused=fused)

    before = dict(tpk.PLAIN_CALLS)
    vel_f, div_f = divergence_exact(v(True), _t(x[:2]))
    assert tpk.PLAIN_CALLS["fused_edge_mlp_jvp"] == before["fused_edge_mlp_jvp"] + LAYERS
    vel, div = divergence_exact(v(False), _t(x[:2]))
    np.testing.assert_allclose(vel_f.numpy(), vel.numpy(), **FORWARD_BAR)
    np.testing.assert_allclose(div_f.numpy(), div.numpy(), rtol=1e-3)


def test_dense_fused_sampler_matches_jax(model):
    """The fused path as a whole: the exact-dlogp Gauss sampler through
    impl="dense_fused" against the JAX sampler with impl="dense" (whose
    dense_fused route cannot lower on the CPU); one B5 call per node and
    layer."""
    jm, jp, jt, params, tm, template, x, _t0, temps = model
    kw = dict(solver="rk4", n_steps=8, dlogp_quad="gauss", dlogp_quad_points=8,
              steps_per_dispatch=25, divergence="exact")
    ref = jax_make_ode_sampler(jax_v_fn_of(jm, jp, jt, impl="dense"), **kw)(
        jnp.asarray(x), jnp.asarray(temps), jax.random.PRNGKey(0))
    before = dict(tpk.PLAIN_CALLS)
    out = make_ode_sampler(molecular_v_fn_of(tm, params, template, impl="dense_fused",
                                             device="cpu"), device="cpu", **kw)(
        x, temps, torch.Generator().manual_seed(0))
    assert tpk.PLAIN_CALLS["fused_edge_mlp_jvp"] - before["fused_edge_mlp_jvp"] == 8 * LAYERS
    np.testing.assert_allclose(out.xs.numpy(), np.asarray(ref.xs), **FORWARD_BAR)
    np.testing.assert_allclose(out.dlogp.numpy(), np.asarray(ref.dlogp), rtol=1e-3, atol=1e-6)


def test_v_fn_of_impl_guards(model):
    _jm, _jp, _jt, params, tm, template, x, _t0, temps = model
    # the edge form runs now: the dense form's velocity at the bar of
    # tests/test_pallas_kernels.py::test_dense_forward_matches_model_apply
    edge = molecular_v_fn_of(tm, params, template, impl="edge", device="cpu")(_t(temps))
    dense = molecular_v_fn_of(tm, params, template, device="cpu")(_t(temps))
    np.testing.assert_allclose(edge(_t(x), 0.5).numpy(), dense(_t(x), 0.5).numpy(),
                               rtol=2e-3, atol=2e-4)
    with pytest.raises(ValueError, match="unknown impl"):
        molecular_v_fn_of(tm, params, template, impl="fused", device="cpu")
    with pytest.raises(ValueError, match="f32 only"):
        molecular_v_fn_of(tm, params, template, impl="dense_fused", compute_dtype="bf16_agg",
                          device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tpk.fused_mlp(torch.zeros(2, F, device="meta"), tpk.pack_mlp(
            _mlp_weights(JaxMLP(F, 2).init(jax.random.PRNGKey(0),
                                                        np.zeros((1, F), np.float32))["params"]),
            "cpu"))
