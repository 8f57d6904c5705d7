"""The hand-propagated exact divergence (ops/dense_divergence.py) and the
divergence estimators of the PyTorch port against the JAX package.

Same flax weights and numpy inputs on both sides, N = 6, F = 16, 2 layers,
3 chains. Bars: ``dense_divergence`` velocity rtol 1e-4 / atol 1e-5 and
divergence rtol 2e-4 (tests/test_pallas_kernels.py::
test_hand_jvp_divergence_matches_linearize); the chunked exact divergence
against the unchunked one rtol 1e-5 (the same JVPs summed in blocks);
Hutch++ against JAX's on the same probes rtol 2e-4 (the trace term is
invariant to the QR's sign convention; what differs is f32 rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.models.cpainn_dense import apply_dense as jax_apply_dense
from ti_tpu.ops.dense_divergence import dense_divergence as jax_dense_divergence
from ti_tpu.ops.divergence import divergence_hutchpp as jax_hutchpp
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.convert import params_from_flax
from ti_torch.models.cpainn import CPaiNN
from ti_torch.models.cpainn_dense import dense_velocity_fn
from ti_torch.ops.dense_divergence import dense_divergence, dense_divergence_fn
from ti_torch.ops.divergence import (
    divergence_exact,
    divergence_hutchinson,
    divergence_hutchpp,
    value_and_divergence,
)

N_ATOMS, F, LAYERS, B, T = 6, 16, 2, 3, 0.5
D = 3 * N_ATOMS


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def setup():
    jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=2)
    jm = JaxCPaiNN(n_features=F, score_layers=LAYERS, conditioning="ambient")
    jp = jm.init(jax.random.PRNGKey(0), jt)
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    model = CPaiNN(F, LAYERS, n_atoms=N_ATOMS)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2)
    rng = np.random.default_rng(2)
    xs = (0.3 * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    temps = np.tile(np.array([700.0, 300.0], np.float32), (B, 1))
    return jm, jp, jt, params, model, template, xs, temps


@pytest.fixture(scope="module")
def exact(setup):
    """The port's divergence_exact over apply_dense: (velocity, div)."""
    _jm, _jp, _jt, params, model, template, xs, temps = setup
    drift = dense_velocity_fn(model, params, template)
    vel, div = divergence_exact(lambda y: drift(y, T, _t(temps)), _t(xs))
    return vel.detach(), div.detach()


@pytest.mark.parametrize("lane_chunk", [None, 5])
def test_dense_divergence_matches_jax(setup, exact, lane_chunk):
    jm, jp, jt, params, model, template, xs, temps = setup
    jax_fn = jax.jit(lambda x, tp: jax_dense_divergence(
        jm, jp, x, jnp.asarray(T), tp, jt.atom_ids, jt.edges, lane_chunk=lane_chunk))
    fn = dense_divergence_fn(model, params, template, lane_chunk=lane_chunk)
    for i in range(B):
        vel_j, div_j = jax_fn(jnp.asarray(xs[i]), jnp.asarray(temps[i]))
        vel, div = fn(_t(xs[i]), T, _t(temps[i]))
        np.testing.assert_allclose(vel.detach().numpy(), np.asarray(vel_j), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(div.item(), float(div_j), rtol=2e-4)
        # and against the port's torch.func exact divergence over apply_dense
        np.testing.assert_allclose(vel.detach().numpy(), exact[0][i].numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(div.item(), exact[1][i].item(), rtol=2e-4)


def test_exact_divergence_matches_jax_linearize(setup, exact):
    """The torch.func exact divergence against the JAX package's
    linearize-based one over its own dense forward (rtol 2e-4)."""
    jm, jp, jt, *_rest, xs, temps = setup
    from ti_tpu.ops.divergence import divergence_exact as jax_exact

    @jax.jit
    def ref(x, tp):
        return jax_exact(lambda y: jax_apply_dense(jm, jp, y[None], jnp.array([T]), tp[None],
                                                   jt.atom_ids, jt.edges)[0], x)[1]

    for i in range(B):
        np.testing.assert_allclose(exact[1][i].item(),
                                   float(ref(jnp.asarray(xs[i]), jnp.asarray(temps[i]))), rtol=2e-4)


@pytest.mark.parametrize("chunk", [1, 4, 7, 18, 40])
def test_chunked_exact_equals_unchunked(setup, exact, chunk):
    _jm, _jp, _jt, params, model, template, xs, temps = setup
    drift = dense_velocity_fn(model, params, template)
    vel, div = divergence_exact(lambda y: drift(y, T, _t(temps)), _t(xs), chunk=chunk)
    torch.testing.assert_close(vel.detach(), exact[0], rtol=0, atol=0)
    np.testing.assert_allclose(div.detach().numpy(), exact[1].numpy(), rtol=1e-5, atol=1e-6)


def test_value_and_divergence_modes(setup, exact):
    _jm, _jp, _jt, params, model, template, xs, temps = setup
    drift = dense_velocity_fn(model, params, template)
    f = lambda y: drift(y, T, _t(temps))
    x = _t(xs)
    _, d_ex = value_and_divergence(f, x, mode="exact", chunk=5)
    np.testing.assert_allclose(d_ex.detach().numpy(), exact[1].numpy(), rtol=1e-5, atol=1e-6)
    for mode, fn, kw in (("hutchinson", divergence_hutchinson, dict(num_probes=6,
                                                                      probe_mode="orthogonal")),
                         ("hutchpp", divergence_hutchpp, dict(num_queries=6))):
        _, got = value_and_divergence(f, x, mode=mode, generator=torch.Generator().manual_seed(4),
                                      num_probes=6, probe_mode="orthogonal")
        _, ref = fn(f, x, torch.Generator().manual_seed(4), **kw)
        torch.testing.assert_close(got, ref)
        assert got.shape == (B,) and torch.isfinite(got).all()
    with pytest.raises(ValueError, match="Generator"):
        value_and_divergence(f, x, mode="hutchinson")
    with pytest.raises(ValueError, match="unknown"):
        value_and_divergence(f, x, mode="nope")
    # lane sharding: a mesh dimension's name resolves only inside
    # lane_parallel_sampler's mesh; Hutch++ refuses it, as in ti_tpu
    for mode in ("exact", "hutchinson"):
        with pytest.raises(ValueError, match="no mesh is in use"):
            value_and_divergence(f, x, mode=mode, generator=torch.Generator(), axis_name="lanes")
    with pytest.raises(NotImplementedError, match="hutchpp"):
        value_and_divergence(f, x, mode="hutchpp", generator=torch.Generator(),
                             axis_name="lanes")


def test_value_and_divergence_on_linear_fields():
    """The JAX package's closed-form cases (tests/test_ops.py): 2x has
    divergence 6 exactly under exact and Rademacher Hutchinson; a rank-1
    diagonal field is exact under Hutch++ (the sketch spans range(J))."""
    x = torch.ones(2, 3)
    gen = torch.Generator().manual_seed(0)
    assert torch.allclose(value_and_divergence(lambda y: 2.0 * y, x)[1], torch.full((2,), 6.0))
    _, d2 = value_and_divergence(lambda y: 2.0 * y, x, mode="hutchinson", generator=gen)
    assert torch.allclose(d2, torch.full((2,), 6.0))
    mask = torch.tensor([2.0, 0.0, 0.0])
    _, d3 = value_and_divergence(lambda y: y * mask, x, mode="hutchpp", generator=gen, num_probes=4)
    assert torch.allclose(d3, torch.full((2,), 2.0), rtol=1e-4)


def test_hutchpp_low_rank_exact_and_too_few_queries():
    rng = np.random.default_rng(0)
    w = np.zeros((6, 6), np.float32)
    w[:2] = rng.standard_normal((2, 6))
    wt = _t(w)
    _, d = divergence_hutchpp(lambda y: y @ wt.T, torch.ones(4, 6), torch.Generator().manual_seed(1),
                              num_queries=5, sketch=2)
    np.testing.assert_allclose(d.numpy(), np.full(4, np.trace(w)), rtol=5e-3, atol=1e-5)
    with pytest.raises(ValueError, match="too small"):
        divergence_hutchpp(lambda y: y, torch.ones(1, 6), torch.Generator(), num_queries=4, sketch=2)


def test_hutchpp_explicit_probes_are_checked():
    """S and g come together; their row counts set s and m, and must agree
    with ``sketch`` and ``num_queries`` where those are passed too."""
    x, gen = torch.ones(2, 6), torch.Generator().manual_seed(0)
    S = torch.tensor([[1.0, 1, 1, 0, 0, 0], [0, 0, 0, 1, 1, 1]]).expand(2, 2, 6)
    g = torch.tensor([[1.0, -1, 0, 0, 0, 0]]).expand(2, 1, 6)
    f = lambda y: 3.0 * y
    for kw in (dict(S=S), dict(g=g)):
        with pytest.raises(ValueError, match="both S and g"):
            divergence_hutchpp(f, x, gen, **kw)
    with pytest.raises(ValueError, match="sketch=3"):
        divergence_hutchpp(f, x, S=S, g=g, sketch=3)
    with pytest.raises(ValueError, match="num_queries=12"):
        divergence_hutchpp(f, x, S=S, g=g, num_queries=12)
    with pytest.raises(ValueError, match="too small"):
        divergence_hutchpp(f, x, S=S, g=g[:, :0])
    with pytest.raises(ValueError, match="rows"):
        divergence_hutchpp(f, x, S=S[:1], g=g)
    # the probes given are the ones used: on J = 3I the sketch spans two
    # directions (3 + 3) and g, orthogonal to both, adds 3 |g|² = 6
    _, d = divergence_hutchpp(f, x, S=S, g=g, sketch=2, num_queries=5)
    np.testing.assert_allclose(d.numpy(), 12.0, rtol=1e-5)


def test_hutchpp_matches_jax_on_the_same_probes(setup):
    """JAX's probes come from its key (split into sketch and residual keys,
    Rademacher draws); the port takes the same rows as explicit S and g."""
    jm, jp, jt, params, model, template, xs, temps = setup
    nq = 12
    s = nq // 3
    m = nq - 2 * s

    @jax.jit
    def ref(x, tp, key):
        f = lambda y: jax_apply_dense(jm, jp, y.reshape(1, N_ATOMS, 3), jnp.array([T]), tp[None],
                                      jt.atom_ids, jt.edges)[0].reshape(D)
        return jax_hutchpp(f, x.reshape(D), key, num_queries=nq)[1]

    S, G, refs = [], [], []
    for i in range(B):
        key = jax.random.PRNGKey(10 + i)
        k_s, k_g = jax.random.split(key)
        S.append(np.asarray(jax.random.rademacher(k_s, (s, D), dtype=jnp.float32)))
        G.append(np.asarray(jax.random.rademacher(k_g, (m, D), dtype=jnp.float32)))
        refs.append(float(ref(jnp.asarray(xs[i]), jnp.asarray(temps[i]), key)))
    drift = dense_velocity_fn(model, params, template)
    _, div = divergence_hutchpp(lambda y: drift(y, T, _t(temps)), _t(xs), num_queries=nq,
                                S=_t(np.stack(S)), g=_t(np.stack(G)))
    np.testing.assert_allclose(div.detach().numpy(), refs, rtol=2e-4, atol=1e-5)
