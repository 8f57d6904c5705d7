"""The port's segmented samplers with stage-coupled dlogp: the analogues of
tests/test_segmented.py (segments of ``steps_per_dispatch`` steps match one
pass) and both against ti_tpu's samplers on the same field. Bars are those
of tests/test_segmented.py: states rtol 1e-5 / atol 1e-6 for fixed steps,
rtol 1e-4 / atol 1e-5 for dopri5, dlogp rtol 1e-4 / atol 1e-5 and rtol
1e-3 / atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu.sampling.drivers import make_ode_sampler as jax_make_ode_sampler
from ti_torch.sampling.drivers import make_ode_sampler


def _jax_v_fn_of(cond):
    def v(x, t):
        return -cond * x + 0.3 * jnp.sin(3.0 * x) * t

    return v


def _v_fn_of(conds):
    def v(x, t):
        t = torch.as_tensor(t, dtype=x.dtype).reshape(-1, 1)
        return -conds[:, None] * x + 0.3 * torch.sin(3.0 * x) * t

    return v


def _inputs(b, d, seed):
    x0 = np.random.default_rng(seed).standard_normal((b, d)).astype(np.float32)
    return x0, np.linspace(0.5, 1.5, b, dtype=np.float32)


def _run(sampler_kw, x0, conds, jax_side=False):
    if jax_side:
        sol = jax_make_ode_sampler(_jax_v_fn_of, **sampler_kw)(
            jnp.asarray(x0), jnp.asarray(conds), jax.random.PRNGKey(0))
        return np.asarray(sol.xs), np.asarray(sol.dlogp), np.asarray(sol.nfe)
    sol = make_ode_sampler(_v_fn_of, device="cpu", **sampler_kw)(x0, conds)
    return sol.xs.numpy(), sol.dlogp.numpy(), np.asarray(sol.nfe)


def test_segmented_fixed_step_matches_single_dispatch_and_jax():
    x0, conds = _inputs(6, 4, 0)
    kw = dict(solver="rk4", n_steps=32, n_save=5, return_dlogp=True)
    xs, lp, nfe = _run(kw, x0, conds)
    sxs, slp, snfe = _run(dict(kw, steps_per_dispatch=4), x0, conds)
    assert sxs.shape == xs.shape == (6, 5, 4)
    np.testing.assert_allclose(sxs, xs, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(slp, lp, rtol=1e-4, atol=1e-5)
    assert int(snfe) == int(nfe) == 32 * 4
    jxs, jlp, _ = _run(dict(kw, steps_per_dispatch=4), x0, conds, jax_side=True)
    np.testing.assert_allclose(sxs, jxs, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(slp, jlp, rtol=1e-4, atol=1e-5)


def test_segmented_dopri5_matches_single_dispatch_and_jax():
    x0, conds = _inputs(4, 3, 1)
    kw = dict(solver="dopri5", n_save=3, atol=1e-6, rtol=1e-6, return_dlogp=True)
    xs, lp, nfe = _run(kw, x0, conds)
    sxs, slp, snfe = _run(dict(kw, steps_per_dispatch=8), x0, conds)
    np.testing.assert_allclose(sxs, xs, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(slp, lp, rtol=1e-3, atol=1e-4)
    assert nfe.shape == (4,) and int(snfe) == int(nfe.max())  # ti_tpu's: the batch's max
    jxs, jlp, jnfe = _run(dict(kw, steps_per_dispatch=8), x0, conds, jax_side=True)
    np.testing.assert_allclose(sxs, jxs, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(slp, jlp, rtol=1e-3, atol=1e-4)
    with pytest.raises(NotImplementedError, match="exact divergence only"):
        make_ode_sampler(_v_fn_of, solver="dopri5", divergence="hutchinson",
                         steps_per_dispatch=8, device="cpu")


def test_segmented_uneven_dispatch_size():
    # steps_per_dispatch not dividing per_save: rounds to the nearest divisor
    x0, _ = _inputs(3, 2, 2)
    conds = np.ones(3, np.float32)
    for dlogp in (False, True):
        kw = dict(solver="heun", n_steps=30, n_save=2, return_dlogp=dlogp)
        xs, lp, _ = _run(kw, x0, conds)
        sxs, slp, _ = _run(dict(kw, steps_per_dispatch=7), x0, conds)
        np.testing.assert_allclose(sxs, xs, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(slp, lp, rtol=1e-4, atol=1e-5)


def test_segmented_dopri5_backstop_raises_where_ti_tpu_returns_silently():
    """A fast rotation (angular speed 2000) needs far more than 64 rounds of
    one step: ti_tpu's segmented sampler gives up after its 64-round
    backstop and returns the state short of the save time as the state at
    t = 1, far from the exact rotation; the port raises."""
    k = 2000.0
    x0 = np.array([[1.0, -0.5], [0.3, 0.2]], np.float32)
    kw = dict(solver="dopri5", n_save=2, return_dlogp=False, steps_per_dispatch=1)
    sol = jax_make_ode_sampler(lambda c: (lambda x, t: k * jnp.stack([-x[1], x[0]])), **kw)(
        jnp.asarray(x0), jnp.zeros(2), jax.random.PRNGKey(0))
    assert int(sol.nfe) == 64 * 7
    c, s = np.cos(k), np.sin(k)
    exact = x0 @ np.array([[c, s], [-s, c]], np.float32)
    assert np.abs(np.asarray(sol.xs[:, -1]) - exact).max() > 0.1
    with pytest.raises(RuntimeError, match="2 of 2 chains stopped short.*64 rounds"):
        make_ode_sampler(lambda c: (lambda x, t: k * torch.stack([-x[:, 1], x[:, 0]], 1)),
                         device="cpu", **kw)(x0, np.zeros(2, np.float32))
