"""The port's interpolants (ti_torch/interpolants.py) against ti_tpu's, and
the laws of the loss's time draws (ti_torch/losses.py::_sample_t).

The same numpy inputs go through both packages; JAX's noise draw is fed to
the port as ``z=``. Bar: rtol 1e-6 elementwise. The t laws are held
against scipy by a Kolmogorov–Smirnov test at n = 10^5 draws.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import jax
from ti_tpu import interpolants as jax_interp
from ti_torch import interpolants
from ti_torch.losses import _sample_t

BAR = dict(rtol=1e-6, atol=1e-7)
SCHEDULES = [("linear", 0.1, "brownian"), ("linear", 1.0, "brownian"), ("linear", 1.0, "sin2"),
             ("linear", 8.0, "sig_sum"), ("one_sided", 1.0, "brownian")]
FIELDS = ("alpha", "alpha_dot", "beta", "beta_dot", "gamma", "gamma_dot", "gg_dot")


def _inputs(seed=0, b=6, n=5):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.02, 0.98, size=b).astype(np.float32)
    x0 = rng.standard_normal((b, n, 3)).astype(np.float32)
    x1 = rng.standard_normal((b, n, 3)).astype(np.float32)
    return t, x0, x1


def _both(kind, a, gamma):
    return (jax_interp.make_interpolant(kind, a=a, gamma=gamma),
            interpolants.make_interpolant(kind, a=a, gamma=gamma))


@pytest.mark.parametrize("kind,a,gamma", SCHEDULES)
def test_schedule_functions_match_jax(kind, a, gamma):
    ji, ti = _both(kind, a, gamma)
    t, _, _ = _inputs()
    assert ti.one_sided == ji.one_sided and ti.name == ji.name
    for name in FIELDS:
        ref = np.asarray(getattr(ji, name)(jnp.asarray(t)))
        out = getattr(ti, name)(torch.from_numpy(t)).numpy()
        assert out.shape == ref.shape and out.dtype == np.float32, name
        np.testing.assert_allclose(out, ref, **BAR, err_msg=name)
    # a python float t, as the samplers pass it
    np.testing.assert_allclose(ti.gamma(0.3).numpy(), np.asarray(ji.gamma(0.3)), **BAR)


@pytest.mark.parametrize("kind,a,gamma", SCHEDULES)
def test_interpolant_states_match_jax(kind, a, gamma):
    ji, ti = _both(kind, a, gamma)
    t, x0, x1 = _inputs(1)
    t3 = t[:, None, None]
    jt, jx0, jx1 = jnp.asarray(t3), jnp.asarray(x0), jnp.asarray(x1)
    pt, px0, px1 = torch.from_numpy(t3), torch.from_numpy(x0), torch.from_numpy(x1)
    np.testing.assert_allclose(ti.It(pt, px0, px1).numpy(), np.asarray(ji.It(jt, jx0, jx1)), **BAR)
    np.testing.assert_allclose(ti.dtIt(pt, px0, px1).numpy(), np.asarray(ji.dtIt(jt, jx0, jx1)),
                               **BAR)
    # a per-sample t of shape (B,) broadcasts over the trailing axes
    np.testing.assert_allclose(ti.It(torch.from_numpy(t), px0, px1).numpy(),
                               np.asarray(ji.It(jnp.asarray(t), jx0, jx1)), **BAR)

    jp, jm, jz = ji.antithetic_xts(jax.random.PRNGKey(3), jt, jx0, jx1)
    z = torch.from_numpy(np.array(jz))
    pp, pm, pz = ti.antithetic_xts(pt, px0, px1, z=z)
    for out, ref in ((pp, jp), (pm, jm), (pz, jz)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BAR)

    jr, jrz = ji.regular_xt(jax.random.PRNGKey(4), jt, jx0, jx1)
    pr, prz = ti.regular_xt(pt, px0, px1, z=torch.from_numpy(np.array(jrz)))
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), **BAR)
    np.testing.assert_allclose(prz.numpy(), np.asarray(jrz), **BAR)


def test_antithetic_noise_comes_from_the_generator():
    ti = interpolants.linear(a=1.0, gamma="sin2")
    t, x0, x1 = _inputs(2)
    args = (torch.from_numpy(t[:, None, None]), torch.from_numpy(x0), torch.from_numpy(x1))
    a = ti.antithetic_xts(*args, generator=torch.Generator().manual_seed(7))
    b = ti.antithetic_xts(*args, generator=torch.Generator().manual_seed(7))
    c = ti.antithetic_xts(*args, generator=torch.Generator().manual_seed(8))
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[2], c[2])
    plus, minus, z = a
    assert z.shape == x0.shape and z.dtype == torch.float32
    # the pair shares one z: its mean is It, its half-difference gamma·z
    it = ti.It(args[0], args[1], args[2])
    torch.testing.assert_close(0.5 * (plus + minus), it)
    torch.testing.assert_close(0.5 * (plus - minus), ti.gamma(args[0]) * z)


def test_one_sided_reflects_x0():
    ti = interpolants.one_sided_linear()
    t, x0, x1 = _inputs(3)
    pt, px0, px1 = torch.from_numpy(t[:, None, None]), torch.from_numpy(x0), torch.from_numpy(x1)
    plus, minus, z = ti.antithetic_xts(pt, px0, px1, z=torch.ones_like(px0))
    assert torch.equal(z, px0)  # z := x0, the noise endpoint; a given z is unused
    torch.testing.assert_close(plus, pt * px1 + (1 - pt) * px0)
    torch.testing.assert_close(minus, pt * px1 - (1 - pt) * px0)


def test_make_interpolant_rejects_unknown_names():
    with pytest.raises(ValueError):
        interpolants.make_interpolant("cubic")
    with pytest.raises(ValueError):
        interpolants.linear(gamma="cosine")


@pytest.mark.parametrize("t_distr,law", [
    ("uniform", scipy.stats.uniform()),
    ("beta", scipy.stats.beta(0.5, 0.5)),
    ("beta21", scipy.stats.beta(2.0, 1.0)),
])
def test_sample_t_laws(t_distr, law):
    n = 100_000
    t = _sample_t(torch.Generator().manual_seed(0), (n,), t_distr, torch.float64, "cpu")
    assert t.shape == (n,) and t.dtype == torch.float64
    assert float(t.min()) >= 0.0 and float(t.max()) <= 1.0
    res = scipy.stats.kstest(t.numpy(), law.cdf)
    assert res.pvalue > 1e-3, (t_distr, res)


def test_sample_t_rejects_unknown_law():
    with pytest.raises(ValueError):
        _sample_t(None, (3,), "gamma", torch.float32, "cpu")
