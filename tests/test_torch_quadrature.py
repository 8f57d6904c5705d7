"""The port's quadrature-dlogp samplers against ti_tpu's on the same fields:
``sample_ode_times``, ``gauss_dlogp_schedule``, ``sample_ode_gauss_dlogp``
and ``sample_ode_quad_dlogp`` (Simpson), and ``make_ode_sampler``'s
routes to them (the unsegmented Gauss sampler, Simpson in one pass and in
segments), with ``node_batch``.

The port runs a chain batch at once where ti_tpu vmaps one chain; the
Hutchinson probes of node i are JAX's draws (fold_in(key, i)) fed through
``probes=``. Bars, those of tests/test_torch_integrators.py: states rtol
1e-5 / atol 1e-6, dlogp rtol 1e-4 / atol 1e-5 (f32 summation orders); the
schedule exactly; ``node_batch`` against one node at a time to the bit
(exact) or at rtol 1e-6 (the same probes contracted in another batch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu.ops.divergence import _probe_block as jax_probe_block
from ti_tpu.sampling import integrators as jax_integrators
from ti_tpu.sampling.drivers import make_ode_sampler as jax_make_ode_sampler
from ti_torch.sampling.drivers import make_ode_sampler
from ti_torch.sampling.integrators import (
    gauss_dlogp_schedule,
    sample_ode_gauss_dlogp,
    sample_ode_quad_dlogp,
    sample_ode_times,
)

XS = dict(rtol=1e-5, atol=1e-6)
LP = dict(rtol=1e-4, atol=1e-5)
B, D = 3, 4
_RNG = np.random.default_rng(0)
W = (0.5 * _RNG.standard_normal((D, D))).astype(np.float32)
X0 = _RNG.standard_normal((B, D)).astype(np.float32)
CONDS = np.linspace(0.5, 1.5, B, dtype=np.float32)


def _tf(x, t):
    """A nonlinear field on a chain batch; t a float or per-chain times."""
    t = torch.as_tensor(t, dtype=x.dtype).reshape(-1, 1)
    return torch.tanh(x @ torch.from_numpy(W).T) + t * x


def _jf(x, t):
    return jnp.tanh(jnp.asarray(W) @ x) + t * x


def _tf_of(conds):
    return lambda x, t: conds[:, None] * _tf(x, t)


def _jf_of(cond):
    return lambda x, t: cond * _jf(x, t)


def _jax_probes(keys, k, mode):
    """Node i of chain c draws from fold_in(keys[c], i), as ti_tpu's
    quadrature samplers do."""
    def probes(idx):
        zs, ws = zip(*(jax_probe_block(jax.random.fold_in(key, idx), k, D, jnp.float32, mode)
                       for key in keys))
        return torch.from_numpy(np.stack(zs)), torch.from_numpy(np.stack(ws))

    return probes


def test_sample_ode_times_matches_jax():
    ts = np.array([0.0, 0.1, 0.35, 0.4, 0.9, 1.0])
    for method in ("euler", "heun", "rk4"):
        out = sample_ode_times(_tf, torch.from_numpy(X0), ts, method=method)
        assert out.shape == (B, len(ts), D)
        for c in range(B):
            ref = jax_integrators.sample_ode_times(_jf, jnp.asarray(X0[c]), ts, method=method)
            np.testing.assert_allclose(out[c].numpy(), np.asarray(ref), **XS)


@pytest.mark.parametrize("args", [(0.0, 1.0, 64, 8, 2), (0.1, 0.9, 20, 4, 3), (1.0, 0.0, 10, 3, 2),
                                  (0.0, 1.0, 4, 8, 5)])
def test_gauss_dlogp_schedule_is_ti_tpus(args):
    for a, r in zip(gauss_dlogp_schedule(*args), jax_integrators.gauss_dlogp_schedule(*args)):
        np.testing.assert_array_equal(a, np.asarray(r))
    with pytest.raises(ValueError, match="n_save"):
        gauss_dlogp_schedule(0.0, 1.0, 8, 4, 1)


QUAD_CASES = [("exact", None), ("hutchinson", "rademacher"), ("hutchinson", "orthogonal"),
              ("hutchpp", None)]


@pytest.mark.parametrize("rule", ["gauss", "simpson"])
@pytest.mark.parametrize("divergence,mode", QUAD_CASES)
def test_quadrature_integrators_match_jax(rule, divergence, mode):
    keys = [jax.random.PRNGKey(20 + c) for c in range(B)]
    extra = {}
    if divergence == "hutchinson":
        extra = dict(divergence=divergence, probe_mode=mode, num_probes=3)
    elif divergence == "hutchpp":
        extra = dict(divergence=divergence, num_probes=3)
    if rule == "gauss":
        kw = dict(t0=0.1, t1=0.9, n_steps=20, gl_points=4, n_save=3, method="rk4")
        port, ref_fn = sample_ode_gauss_dlogp, jax_integrators.sample_ode_gauss_dlogp
    else:
        kw = dict(t0=0.1, t1=0.9, n_steps=16, div_points=9, n_save=3, method="rk4")
        port, ref_fn = sample_ode_quad_dlogp, jax_integrators.sample_ode_quad_dlogp
    if divergence == "hutchpp":
        # JAX's Hutch++ draws inside its estimator: hold the port to the exact
        # dlogp instead, with a sketch as wide as the state (exact for any J)
        out = port(_tf, torch.from_numpy(X0), generator=torch.Generator().manual_seed(0),
                   divergence="hutchpp", num_probes=3 * D, **kw)
        exact = port(_tf, torch.from_numpy(X0), **kw)
        np.testing.assert_allclose(out.dlogp.numpy(), exact.dlogp.numpy(), rtol=1e-4, atol=1e-5)
        return
    probes = None if mode is None else _jax_probes(keys, 3, mode)
    out = port(_tf, torch.from_numpy(X0), probes=probes, **extra, **kw)
    assert out.xs.shape == (B, 3, D) and out.dlogp.shape == (B, 3)
    for c in range(B):
        ref = ref_fn(_jf, jnp.asarray(X0[c]), key=keys[c], **extra, **kw)
        np.testing.assert_allclose(out.xs[c].numpy(), np.asarray(ref.xs), **XS)
        np.testing.assert_allclose(out.dlogp[c].numpy(), np.asarray(ref.dlogp), **LP)
        assert out.nfe == int(ref.nfe)


@pytest.mark.parametrize("rule", ["gauss", "simpson"])
@pytest.mark.parametrize("node_batch", [2, 4, 100])
def test_node_batch_equals_one_node_at_a_time(rule, node_batch):
    """Nodes in groups give the per-node results: exact to the bit, and
    Hutchinson on the same generator draws."""
    if rule == "gauss":
        fn, kw = sample_ode_gauss_dlogp, dict(n_steps=16, gl_points=5, n_save=3)
    else:
        fn, kw = sample_ode_quad_dlogp, dict(n_steps=16, div_points=9, n_save=3)
    x = torch.from_numpy(X0)
    seq = fn(_tf, x, **kw)
    grp = fn(_tf, x, node_batch=node_batch, **kw)
    torch.testing.assert_close(grp.xs, seq.xs, rtol=0, atol=0)
    torch.testing.assert_close(grp.dlogp, seq.dlogp, rtol=1e-6, atol=1e-7)
    hk = dict(divergence="hutchinson", num_probes=2, **kw)
    a = fn(_tf, x, generator=torch.Generator().manual_seed(1), **hk)
    b = fn(_tf, x, generator=torch.Generator().manual_seed(1), node_batch=node_batch, **hk)
    torch.testing.assert_close(b.dlogp, a.dlogp, rtol=1e-6, atol=1e-6)


def _run(kw, jax_side=False):
    if jax_side:
        sol = jax_make_ode_sampler(_jf_of, **kw)(jnp.asarray(X0), jnp.asarray(CONDS),
                                                jax.random.PRNGKey(0))
        return np.asarray(sol.xs), np.asarray(sol.dlogp), int(np.max(np.asarray(sol.nfe)))
    sol = make_ode_sampler(_tf_of, device="cpu", **kw)(X0, CONDS,
                                                       torch.Generator().manual_seed(0))
    return sol.xs.numpy(), sol.dlogp.numpy(), int(sol.nfe)


@pytest.mark.parametrize("kw", [
    dict(solver="rk4", n_steps=16, n_save=3, dlogp_quad="gauss", dlogp_quad_points=4),
    dict(solver="heun", n_steps=12, n_save=2, dlogp_quad="gauss", dlogp_quad_points=3,
         node_batch=2),
    dict(solver="rk4", n_steps=16, n_save=3, dlogp_quad="simpson", dlogp_quad_points=9),
    dict(solver="rk4", n_steps=16, n_save=3, dlogp_quad="simpson", dlogp_quad_points=9,
         steps_per_dispatch=2),
    dict(solver="euler", n_steps=24, n_save=2, dlogp_quad="simpson", dlogp_quad_points=5,
         steps_per_dispatch=4, node_batch=3),
], ids=["gauss", "gauss-node-batch", "simpson", "simpson-segmented", "simpson-seg-node-batch"])
def test_sampler_routes_match_jax(kw):
    """make_ode_sampler's unsegmented Gauss and Simpson routes (one pass and
    segmented) with the exact divergence, against ti_tpu's samplers."""
    xs, lp, nfe = _run(kw)
    jxs, jlp, jnfe = _run(kw, jax_side=True)
    np.testing.assert_allclose(xs, jxs, **XS)
    np.testing.assert_allclose(lp, jlp, **LP)
    assert nfe == jnfe
    if kw["dlogp_quad"] == "simpson" and "steps_per_dispatch" in kw:
        one = _run({k: v for k, v in kw.items() if k != "steps_per_dispatch"})
        np.testing.assert_allclose(xs, one[0], **XS)
        np.testing.assert_allclose(lp, one[1], **LP)


def test_quadrature_dlogp_close_to_stage_coupled():
    """On a smooth field both rules land on the stage-coupled RK4 dlogp:
    Simpson-17 and GL-8 within 1e-4 of RK4-64 (the JAX package's own
    quadrature checks, tests/test_integrators.py, hold the same)."""
    kw = dict(solver="rk4", n_steps=64, n_save=2)
    _, ref, _ = _run(kw)
    _, simpson, _ = _run(dict(kw, dlogp_quad="simpson", dlogp_quad_points=17))
    _, gauss, _ = _run(dict(kw, dlogp_quad="gauss", dlogp_quad_points=8))
    np.testing.assert_allclose(simpson, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gauss, ref, rtol=1e-4, atol=1e-4)


def test_quadrature_guards():
    with pytest.raises(ValueError, match="odd"):
        make_ode_sampler(_tf_of, solver="rk4", n_steps=16, dlogp_quad_points=8, device="cpu")
    with pytest.raises(ValueError, match="divide n_steps"):
        make_ode_sampler(_tf_of, solver="rk4", n_steps=10, dlogp_quad_points=5, device="cpu")
    with pytest.raises(ValueError, match="even quotient"):
        make_ode_sampler(_tf_of, solver="rk4", n_steps=16, n_save=5, dlogp_quad_points=5,
                         device="cpu")
    with pytest.raises(ValueError, match="fixed-step"):
        make_ode_sampler(_tf_of, solver="dopri5", dlogp_quad_points=5, device="cpu")
    with pytest.raises(ValueError, match="unknown dlogp_quad"):
        make_ode_sampler(_tf_of, solver="rk4", n_steps=8, dlogp_quad="trapezoid",
                         dlogp_quad_points=5, device="cpu")
    # the variance of the probe noise is kept on the segmented Gauss path
    # only (ti_tpu drops it silently on the unsegmented one)
    with pytest.raises(ValueError, match="segmented gauss"):
        make_ode_sampler(_tf_of, solver="rk4", n_steps=8, dlogp_quad="gauss",
                         dlogp_quad_points=4, divergence="hutchinson", return_dlogp_var=True,
                         device="cpu")
    # lane sharding: the axis name resolves only inside lane_parallel_sampler's
    # mesh; Hutch++ refuses it, as in ti_tpu
    lanes = make_ode_sampler(_tf_of, solver="rk4", n_steps=8, dlogp_quad="gauss",
                             dlogp_quad_points=4, div_axis="lanes", device="cpu")
    with pytest.raises(ValueError, match="no mesh is in use"):
        lanes(X0, CONDS)
    with pytest.raises(NotImplementedError, match="hutchpp"):
        make_ode_sampler(_tf_of, solver="rk4", n_steps=8, dlogp_quad="gauss",
                         dlogp_quad_points=4, divergence="hutchpp", num_probes=6,
                         div_axis="lanes", device="cpu")
