"""The port's integrators with stage-coupled dlogp and its dopri5: the
analogues of tests/test_integrators.py and tests/test_dopri5_parity.py on
chain batches, and the port against ti_tpu on the same fields.

Fields take a batch x (B, d) and a time t that is a float on the
fixed-step solvers and per-chain times (B,) in dopri5 (``_col`` broadcasts
either). Bars are those of the JAX package's tests unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp
from scipy.linalg import expm

from ti_tpu.ops.divergence import _probe_block as jax_probe_block
from ti_tpu.sampling.integrators import sample_ode as jax_sample_ode
from ti_tpu.sampling.integrators import sample_ode_dopri5 as jax_sample_ode_dopri5
from ti_torch.sampling.drivers import make_ode_sampler
from ti_torch.sampling.integrators import sample_ode, sample_ode_dopri5

A = np.array([[0.3, 0.1], [-0.2, -0.5]], np.float32)
A4 = np.array([[0.3, 0.05, 0.0, 0.0], [0.0, -0.2, 0.1, 0.0], [0.0, 0.0, 0.1, 0.02],
               [0.01, 0.0, 0.0, -0.4]], np.float32)


def _col(t, x):
    """t (float, or per-chain (B,)) shaped to broadcast against x (B, ...)."""
    return torch.as_tensor(t, dtype=x.dtype).reshape(-1, *([1] * (x.dim() - 1)))


def _linear(a):
    m = torch.from_numpy(a)
    return lambda x, t: x @ m.T


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_rk4_matches_matrix_exponential():
    x0 = _t([[1.0, -2.0], [0.5, 0.25]])
    sol = sample_ode(_linear(A), x0, n_steps=64, method="rk4")
    np.testing.assert_allclose(sol.xs[:, -1].numpy(), x0.numpy() @ expm(A).T, rtol=1e-5)
    assert sol.nfe == 64 * 4
    assert float(sol.dlogp.abs().max()) == 0.0  # velocity only


def test_dlogp_equals_minus_trace_for_linear_flow():
    sol = sample_ode(_linear(A), _t([[0.7, 0.3], [-1.0, 2.0]]), n_steps=32, method="rk4",
                     return_dlogp=True)
    np.testing.assert_allclose(sol.dlogp[:, -1].numpy(), -np.trace(A), rtol=1e-5)


def test_gaussian_affine_flow_density_identity():
    # x1 = e^A x0, x0 ~ N(0, I): log p1(x1) = log p0(x0) + dlogp
    x0 = np.random.default_rng(0).standard_normal((64, 2)).astype(np.float32)
    sol = sample_ode(_linear(A), _t(x0), n_steps=64, method="rk4", return_dlogp=True)
    x1, dlogp = sol.xs[:, -1].double().numpy(), sol.dlogp[:, -1].double().numpy()
    cov1 = expm(A.astype(np.float64)) @ expm(A.astype(np.float64)).T
    logp0 = -0.5 * (x0.astype(np.float64) ** 2).sum(1) - np.log(2 * np.pi)
    logp1 = (-0.5 * np.einsum("bi,ij,bj->b", x1, np.linalg.inv(cov1), x1)
             - 0.5 * (2 * np.log(2 * np.pi) + np.linalg.slogdet(cov1)[1]))
    np.testing.assert_allclose(logp1, logp0 + dlogp, rtol=1e-4, atol=1e-4)


def test_round_trip_inverts_flow_and_dlogp():
    def field(x, t):
        return torch.sin(x) + 0.3 * t * x

    x0 = _t([[0.4, -1.2, 2.0]])
    fwd = sample_ode(field, x0, n_steps=256, return_dlogp=True)
    back = sample_ode(field, fwd.xs[:, -1], t0=1.0, t1=0.0, n_steps=256, return_dlogp=True)
    np.testing.assert_allclose(back.xs[:, -1].numpy(), x0.numpy(), atol=1e-5)
    assert abs(float(fwd.dlogp[0, -1] + back.dlogp[0, -1])) < 1e-5


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_fixed_step_convergence_order(method):
    x0 = _t([[1.0, 0.5]])
    exact = x0.numpy() @ expm(A).T

    def err(n):
        s = sample_ode(_linear(A), x0, n_steps=n, method=method)
        return float(np.linalg.norm(s.xs[:, -1].numpy() - exact))

    e1, e2 = err(2), err(4)  # small step counts keep errors above the f32 floor
    order = {"euler": 1, "heun": 2, "rk4": 4}[method]
    assert e2 < e1 / (2 ** (order - 0.5))


def _tanh_field(x, t):
    return torch.tanh(x) * (1.0 + _col(t, x))


def test_dopri5_matches_fixed_step_high_accuracy():
    x0 = _t([[0.2, -0.7, 1.5], [1.0, 0.1, -0.3]])
    ref = sample_ode(_tanh_field, x0, n_steps=2048, return_dlogp=True)
    ada = sample_ode_dopri5(_tanh_field, x0, atol=1e-7, rtol=1e-7)
    # f32 accumulation floor ~1e-5
    np.testing.assert_allclose(ada.xs[:, -1].numpy(), ref.xs[:, -1].numpy(), atol=2e-5)
    np.testing.assert_allclose(ada.dlogp[:, -1].numpy(), ref.dlogp[:, -1].numpy(), atol=2e-5)
    assert ada.nfe.shape == (2,) and bool((ada.nfe > 0).all())


def test_dopri5_reverse_round_trip():
    def field(x, t):
        return torch.cos(3 * x) + _col(t, x)

    x0 = _t([[0.1, 0.9]])
    fwd = sample_ode_dopri5(field, x0, atol=1e-8, rtol=1e-8)
    back = sample_ode_dopri5(field, fwd.xs[:, -1], t0=1.0, t1=0.0, atol=1e-8, rtol=1e-8)
    np.testing.assert_allclose(back.xs[:, -1].numpy(), x0.numpy(), atol=1e-5)
    assert abs(float(fwd.dlogp[0, -1] + back.dlogp[0, -1])) < 1e-5


def test_dopri5_save_points():
    x0 = _t([[1.0, 1.0], [0.5, -2.0]])
    sol = sample_ode_dopri5(_linear(A), x0, n_save=5)
    assert sol.xs.shape == (2, 5, 2) and sol.dlogp.shape == (2, 5)
    np.testing.assert_array_equal(sol.xs[:, 0].numpy(), x0.numpy())
    # the save times are uniform: dlogp = -tr(A)·t there
    np.testing.assert_allclose(sol.dlogp.numpy(), -np.trace(A) * np.linspace(0, 1, 5)[None]
                               .repeat(2, 0), atol=1e-5)


def test_hutchinson_dlogp_close_to_exact():
    x0 = _t([[0.5, -0.5, 1.0, 2.0]])
    exact = sample_ode(_linear(A4), x0, n_steps=64, return_dlogp=True)
    hutch = sample_ode(_linear(A4), x0, n_steps=64, return_dlogp=True,
                       divergence="hutchinson", num_probes=128,
                       generator=torch.Generator().manual_seed(3))
    # linear field: Rademacher Hutchinson has variance only from off-diagonals
    assert abs(float(exact.dlogp[0, -1] - hutch.dlogp[0, -1])) < 0.05
    np.testing.assert_allclose(hutch.xs.numpy(), exact.xs.numpy(), rtol=1e-6)
    # Hutch++ with a sketch as wide as the state (s = 4 of 12 queries) is exact
    hpp = sample_ode(_linear(A4), x0, n_steps=64, return_dlogp=True, divergence="hutchpp",
                     num_probes=12, generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(hpp.dlogp.numpy(), exact.dlogp.numpy(), rtol=1e-4, atol=1e-5)
    # the exact divergence in blocks of lanes gives the unblocked one
    chunked = sample_ode(_linear(A4), x0, n_steps=64, return_dlogp=True, div_chunk=3)
    np.testing.assert_allclose(chunked.dlogp.numpy(), exact.dlogp.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="generator"):
        sample_ode(_linear(A4), x0, return_dlogp=True, divergence="hutchinson")
    # a mesh dimension's name resolves only inside lane_parallel_sampler's
    # mesh; Hutch++ refuses lane sharding, as in ti_tpu
    with pytest.raises(ValueError, match="no mesh is in use"):
        sample_ode(_linear(A4), x0, return_dlogp=True, div_axis="lanes")
    with pytest.raises(NotImplementedError, match="hutchpp"):
        sample_ode(_linear(A4), x0, return_dlogp=True, divergence="hutchpp", num_probes=12,
                   generator=torch.Generator().manual_seed(3), div_axis="lanes")


@pytest.mark.parametrize("steps_per_dispatch", [None, 2])
def test_probe_crn_shares_noise_across_chains(steps_per_dispatch):
    """probe_crn=True gives identical chains identical stochastic-divergence
    draws, unsegmented and in segments; independent draws differ."""
    a = (0.3 * np.random.RandomState(0).randn(3, 3)).astype(np.float32)
    m = torch.from_numpy(a)

    def f_of(c):
        return lambda x, t: c[:, None] * (x @ m.T)

    def dlogps(crn):
        s = make_ode_sampler(f_of, solver="rk4", n_steps=4, divergence="hutchinson",
                             num_probes=2, steps_per_dispatch=steps_per_dispatch,
                             probe_crn=crn, device="cpu")
        return s(torch.ones(3, 3), torch.ones(3), torch.Generator().manual_seed(0)).dlogp[:, -1]

    ind, crn = dlogps(False).numpy(), dlogps(True).numpy()
    assert np.allclose(crn, crn[0])
    assert not np.allclose(ind, ind[0])


def _jax_probes(keys, d, k, mode):
    """The probe blocks ti_tpu's sample_ode draws for chain keys ``keys``:
    evaluation i of chain c uses fold_in(keys[c], i)."""
    def probes(idx):
        zs, ws = zip(*(jax_probe_block(jax.random.fold_in(key, idx), k, d, jnp.float32, mode)
                       for key in keys))
        return _t(np.stack(zs)), _t(np.stack(ws))

    return probes


@pytest.mark.parametrize("divergence,mode", [("exact", None), ("hutchinson", "rademacher"),
                                             ("hutchinson", "orthogonal")])
def test_sample_ode_with_dlogp_matches_jax(divergence, mode):
    """Stage-coupled RK4 on a nonlinear field, batched here and per chain in
    ti_tpu; the Hutchinson probes of every evaluation are JAX's draws, fed
    through ``probes=``. Bars: states rtol 1e-5 / atol 1e-6, dlogp rtol
    1e-4 / atol 1e-5 (f32 summation orders)."""
    rng = np.random.default_rng(0)
    w = (0.5 * rng.standard_normal((4, 4))).astype(np.float32)
    x0 = rng.standard_normal((3, 4)).astype(np.float32)
    wt = torch.from_numpy(w)

    def tf(x, t):
        return torch.tanh(x @ wt.T) + t * x

    def jf(x, t):
        return jnp.tanh(jnp.asarray(w) @ x) + t * x

    keys = [jax.random.PRNGKey(10 + c) for c in range(3)]
    kw = dict(t0=0.1, t1=0.9, n_steps=8, n_save=3, method="rk4")
    extra = {} if mode is None else dict(divergence=divergence, probe_mode=mode, num_probes=4)
    probes = None if mode is None else _jax_probes(keys, 4, 4, mode)
    out = sample_ode(tf, _t(x0), return_dlogp=True, probes=probes, **extra, **kw)
    for c in range(3):
        ref = jax_sample_ode(jf, jnp.asarray(x0[c]), key=keys[c], **extra, **kw)
        np.testing.assert_allclose(out.xs[c].numpy(), np.asarray(ref.xs), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out.dlogp[c].numpy(), np.asarray(ref.dlogp), rtol=1e-4,
                                   atol=1e-5)
        assert out.nfe == int(ref.nfe)


def test_sample_ode_dopri5_matches_jax():
    """dopri5 with exact dlogp at the reference's atol = rtol = 1e-5, per
    chain in ti_tpu: the same states and dlogp at every save point, and the
    same evaluation count per chain (on this field ti_tpu's f32 rounding of
    the first steps' error leaves their step sizes where the exact error
    puts them)."""
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((4, 3)).astype(np.float32)

    def tf(x, t):
        return torch.tanh(x) * (1.0 + _col(t, x)) + 0.3 * torch.sin(2 * x.flip(-1))

    def jf(x, t):
        return jnp.tanh(x) * (1.0 + t) + 0.3 * jnp.sin(2 * x[::-1])

    out = sample_ode_dopri5(tf, _t(x0), n_save=5)
    for c in range(4):
        ref = jax_sample_ode_dopri5(jf, jnp.asarray(x0[c]), n_save=5)
        np.testing.assert_allclose(out.xs[c].numpy(), np.asarray(ref.xs), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out.dlogp[c].numpy(), np.asarray(ref.dlogp), rtol=1e-5,
                                   atol=1e-6)
        assert int(out.nfe[c]) == int(ref.nfe)


def test_dopri5_nfe_matches_jax_in_f64():
    """In f64, where no error norm sits at the rounding floor, every chain
    takes the same steps in both packages at every tolerance: the same
    evaluation count per chain. (In f32 ti_tpu's error norms of the first
    steps, far below atol, are the rounding of two f32 solutions, where the
    port forms the error directly, so the counts can differ there while
    both stay within the tolerance; test_torch_sample_ambient.py holds that
    case.)"""
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((4, 3))

    def tf(x, t):
        t = _col(t, x)
        return (torch.tanh(x) * (1.0 + t) + 0.3 * torch.sin(2 * x.flip(-1))
                + 0.5 * (x ** 2).sum(1, keepdim=True) * torch.cos(5 * t))

    def jf(x, t):
        return (jnp.tanh(x) * (1.0 + t) + 0.3 * jnp.sin(2 * x[::-1])
                + 0.5 * jnp.sum(x ** 2) * jnp.cos(5 * t))

    for tol in (1e-5, 1e-9):
        out = sample_ode_dopri5(tf, torch.from_numpy(x0), atol=tol, rtol=tol, n_save=7)
        with jax.enable_x64(True):
            ref = [jax_sample_ode_dopri5(jf, jnp.asarray(x0[c]), atol=tol, rtol=tol, n_save=7)
                   for c in range(4)]
            assert [int(r.nfe) for r in ref] == out.nfe.tolist()
            for c in range(4):
                np.testing.assert_allclose(out.xs[c].numpy(), np.asarray(ref[c].xs), rtol=1e-10,
                                           atol=1e-12)
                np.testing.assert_allclose(out.dlogp[c].numpy(), np.asarray(ref[c].dlogp),
                                           rtol=1e-10, atol=1e-12)


def test_stopped_short_raises_where_ti_tpu_returns_silently():
    """A stiff field and max_steps = 3: ti_tpu's dopri5 leaves its loop
    with tau short of the save time and returns that state as the state at
    t = 1 (far from the true x0·e^-200 ≈ 0); the port raises, naming the
    chains and the save time."""
    def jf(x, t):
        return -200.0 * x

    x0 = np.array([[1.0, -0.5], [0.3, 0.2]], np.float32)
    ref = jax_sample_ode_dopri5(jf, jnp.asarray(x0[0]), max_steps=3, return_dlogp=False)
    assert int(ref.nfe) == 7 * 3
    assert np.abs(np.asarray(ref.xs[-1])).max() > 1e-3  # not the state at t = 1
    with pytest.raises(RuntimeError, match=r"2 of 2 chains stopped short of the save time t = 1"):
        sample_ode_dopri5(lambda x, t: -200.0 * x, _t(x0), max_steps=3, return_dlogp=False)
    ok = sample_ode_dopri5(lambda x, t: -200.0 * x, _t(x0), return_dlogp=False)
    assert float(ok.xs[:, -1].abs().max()) < 1e-3


# ---- the analogues of tests/test_dopri5_parity.py: scipy's RK45 ----------

def _pendulum(t, y):
    x, v = y
    return [v, -np.sin(x) * (1.0 + 0.3 * np.sin(2 * np.pi * t))]


@pytest.mark.parametrize("tol", [1e-5, 1e-7])
def test_dopri5_matches_scipy_rk45(tol):
    y0 = np.array([1.2, -0.3])
    ref = solve_ivp(_pendulum, (0.0, 1.0), y0, method="RK45", atol=tol / 100, rtol=tol / 100)
    sp = solve_ivp(_pendulum, (0.0, 1.0), y0, method="RK45", atol=tol, rtol=tol)

    def v_fn(x, t):
        t = _col(t, x)[:, 0]
        return torch.stack([x[:, 1], -torch.sin(x[:, 0]) * (1.0 + 0.3 * torch.sin(2 * np.pi * t))],
                           dim=1)

    sol = sample_ode_dopri5(v_fn, _t(y0[None]), atol=tol, rtol=tol, return_dlogp=False)
    err_ours = np.max(np.abs(sol.xs[0, -1].numpy() - ref.y[:, -1]))
    err_scipy = np.max(np.abs(sp.y[:, -1] - ref.y[:, -1]))
    assert err_ours < 50 * tol, (err_ours, tol)
    assert err_ours < max(10 * err_scipy, 5 * tol)
    nfe = int(sol.nfe[0])  # same DP5(4) pair: within ~2x of scipy's count
    assert 0.5 * sp.nfev - 50 <= nfe <= 2.0 * sp.nfev + 50, (nfe, sp.nfev)


def test_dopri5_stiffening_field_step_adaptation():
    counts = {}
    for k in (1.0, 30.0):
        sp = solve_ivp(lambda t, y, k=k: [-k * (y[0] - np.cos(8 * t))], (0.0, 1.0), [0.0],
                       method="RK45", atol=1e-5, rtol=1e-5)
        sol = sample_ode_dopri5(lambda x, t, k=k: -k * (x - torch.cos(8 * _col(t, x))),
                                torch.zeros(1, 1), atol=1e-5, rtol=1e-5, return_dlogp=False)
        counts[k] = (int(sol.nfe[0]), sp.nfev)
    ratio_ours = counts[30.0][0] / counts[1.0][0]
    ratio_scipy = counts[30.0][1] / counts[1.0][1]
    assert ratio_ours > 1.3
    assert 0.4 < ratio_ours / ratio_scipy < 2.5


def test_dopri5_per_state_tolerances():
    """(atol, rtol) as (x, dlogp) pairs: loosening only the dlogp tolerance
    cuts the cost without moving x, and matches scipy's RK45 on the joint
    (x, dlogp) system with the same vector atol."""
    def v_fn(x, t):
        return -x * (1.0 + 0.9 * torch.sin(20 * np.pi * _col(t, x)))

    x0 = _t([[1.5]])
    tight = sample_ode_dopri5(v_fn, x0, atol=1e-7, rtol=1e-7)
    loose = sample_ode_dopri5(v_fn, x0, atol=(1e-7, 1e-2), rtol=(1e-7, 1e-2))
    np.testing.assert_allclose(loose.xs[:, -1].numpy(), tight.xs[:, -1].numpy(), atol=1e-4)
    np.testing.assert_allclose(loose.dlogp[:, -1].numpy(), tight.dlogp[:, -1].numpy(), atol=5e-2)
    assert int(loose.nfe[0]) < int(tight.nfe[0])

    def joint(t, y):
        c = 1.0 + 0.9 * np.sin(20 * np.pi * t)
        return [-y[0] * c, c]  # -div = +c in 1-D

    sp = solve_ivp(joint, (0.0, 1.0), [1.5, 0.0], method="RK45", atol=np.array([1e-7, 1e-2]),
                   rtol=1e-7)
    ours = sample_ode_dopri5(v_fn, x0, atol=(1e-7, 1e-2), rtol=1e-7)
    np.testing.assert_allclose(float(ours.xs[0, -1, 0]), sp.y[0, -1], atol=1e-4)
    np.testing.assert_allclose(float(ours.dlogp[0, -1]), sp.y[1, -1], atol=5e-2)
    assert int(ours.nfe[0]) <= 2.0 * sp.nfev + 50


def test_dopri5_rejects_bad_tolerance_shape():
    with pytest.raises(ValueError, match="pair"):
        sample_ode_dopri5(lambda x, t: -x, torch.ones(1, 2), atol=(1e-5, 1e-5, 1e-5), rtol=1e-5)
