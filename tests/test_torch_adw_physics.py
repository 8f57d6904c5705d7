"""ADW end-to-end physics of the port, on the CPU (the counterpart of
tests/test_adw_physics.py, at its configuration and bars).

``train_adw(device="cpu")`` trains the velocity field on exact Boltzmann
samples at beta0 = 1.0 and beta1 = 1.25; the port's integrators transport
fresh beta0 samples with dlogp, and the physics is held to quadrature
oracles:

- the transported marginal matches the beta1 Boltzmann density (KS < 0.06);
- the TFEP free-energy difference matches -(logZ1 - logZ0) by quadrature
  (|err| < 0.05) with ESS above 20%;
- round-trip transport returns to the start with dlogp cancelling (1e-3);
- Simpson-33 and GL-10 quadrature dlogp match the stage-coupled dlogp
  (p99 < 5e-3 and < 1e-2).

Also the harmonic gEDMD oracle of tests/test_analysis.py on
``ti_torch.analysis.reweight``. Marked slow: about a minute on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ti_torch.analysis.potentials import (
    AsymmetricDoubleWell,
    BoltzmannDensity1D,
    delta_f_quadrature,
)
from ti_torch.analysis.weights import calc_ess
from ti_torch.config import ADWConfig
from ti_torch.data.adw import make_synthetic_adw_csv
from ti_torch.sampling.drivers import adw_v_fn_of
from ti_torch.sampling.integrators import sample_ode, sample_ode_gauss_dlogp, sample_ode_quad_dlogp
from ti_torch.train import train_adw

BETA0, BETA1 = 1.0, 1.25
POT = AsymmetricDoubleWell()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("adw_physics")
    make_synthetic_adw_csv(str(tmp / "samples.csv"), betas=[BETA0, BETA1], n_samples=40_000)
    cfg = ADWConfig(
        n_samples=40_000, hidden_size=64, num_layers=3, epochs=50, lr=1e-3, wd=0.0,
        batch_size=1024, a=0.9, traj_path=str(tmp),
        model_save_path=str(tmp / "models"), data_save_path=str(tmp / "out"),
    )
    result = train_adw(cfg, device="cpu")
    # fresh exact test samples at beta0
    x0 = BoltzmannDensity1D(BETA0, POT).sample(123, 4000).astype(np.float32)
    return result, x0


def _v(result, n):
    conds = torch.tensor([[BETA0, BETA1]]).expand(n, 2)
    return adw_v_fn_of(result["model"], result["params"])(conds)


@pytest.fixture(scope="module")
def transported(trained):
    result, x0 = trained
    with torch.no_grad():
        sol = sample_ode(_v(result, len(x0)), torch.from_numpy(x0)[:, None], n_steps=128,
                         method="rk4", return_dlogp=True, divergence="exact")
    return x0, sol.xs[:, -1, 0].numpy(), sol.dlogp[:, -1].numpy()


@pytest.mark.slow
def test_marginal_matches_target_boltzmann(transported):
    x0, x1, dlogp = transported
    dens1 = BoltzmannDensity1D(BETA1, POT)
    grid = np.linspace(-2.0, 2.0, 201)
    xs = np.linspace(-4, 4, 4000)
    cdf_target = np.cumsum(dens1.pdf(xs))
    cdf_target /= cdf_target[-1]
    cdf_emp = np.searchsorted(np.sort(x1), grid) / len(x1)
    ks = np.max(np.abs(cdf_emp - np.interp(grid, xs, cdf_target)))
    assert ks < 0.06, f"KS distance {ks:.3f} too large"


@pytest.mark.slow
def test_tfep_delta_f_matches_quadrature(transported):
    x0, x1, dlogp = transported
    log_w = BETA0 * np.asarray(POT(x0)) - BETA1 * np.asarray(POT(x1)) - dlogp
    mx = log_w.max()
    dF_est = -(mx + np.log(np.mean(np.exp(log_w - mx))))
    dF_exact = delta_f_quadrature(BETA0, BETA1, POT)
    assert dF_est == pytest.approx(dF_exact, abs=0.05), (dF_est, dF_exact)
    assert calc_ess(np.exp(log_w - mx)) > 0.2 * len(x0)


@pytest.mark.slow
def test_round_trip_transport(trained, transported):
    result, _ = trained
    x0, x1, dlogp = transported
    with torch.no_grad():
        sol = sample_ode(_v(result, 500), torch.from_numpy(x1[:500])[:, None], t0=1.0, t1=0.0,
                         n_steps=128, method="rk4", return_dlogp=True)
    np.testing.assert_allclose(sol.xs[:, -1, 0].numpy(), x0[:500], atol=1e-3)
    np.testing.assert_allclose(dlogp[:500] + sol.dlogp[:, -1].numpy(), 0.0, atol=1e-3)


@pytest.mark.slow
@pytest.mark.parametrize("rule,points,p99", [("simpson", (17, 33), 5e-3),
                                             ("gauss", (6, 10), 1e-2)])
def test_quadrature_dlogp_matches_stage_coupled(trained, transported, rule, points, p99):
    """The quadrature-decoupled dlogp (the production routes) against the
    stage-coupled dlogp on the trained field: it converges with the node
    count, and at 33 Simpson or 10 Gauss-Legendre nodes its p99 error is
    below 5e-3 or 1e-2, its largest below 5e-2."""
    result, x0 = trained
    _, _, dlogp_full = transported
    x = torch.from_numpy(x0[:1000])[:, None]
    errs = {}
    for pts in points:
        with torch.no_grad():
            if rule == "simpson":
                sol = sample_ode_quad_dlogp(_v(result, 1000), x, n_steps=128, div_points=pts,
                                            method="rk4")
            else:
                sol = sample_ode_gauss_dlogp(_v(result, 1000), x, n_steps=128, gl_points=pts,
                                             method="rk4")
        errs[pts] = np.abs(sol.dlogp[:, -1].numpy() - dlogp_full[:1000])
    lo, hi = points
    assert np.percentile(errs[hi], 99) <= np.percentile(errs[lo], 99) + 1e-5
    assert np.percentile(errs[hi], 99) < p99, np.percentile(errs[hi], 99)
    assert float(np.max(errs[hi])) < 5e-2


@pytest.mark.slow
def test_reweighted_generator_spectrum_harmonic_oracle():
    """For V = x^2/2 the Langevin generator spectrum is -n at any beta, so
    both reweighting routes must recover it at the target beta: the exact
    affine transport x1 = s x0 (s = sqrt(beta0/beta1)) with its exact dlogp
    gives constant TI weights, and direct Boltzmann reweighting of the beta0
    samples gives the same spectrum."""
    from ti_torch.analysis.reweight import calculate_weights, direct_weights
    from ti_torch.analysis.weights import resample_with_weights
    from ti_torch.gedmd.rff import bootstrap_generator_eigenvalues, sample_rff_gaussian

    @dataclasses.dataclass
    class Harmonic:
        def __call__(self, x):
            return 0.5 * np.asarray(x) ** 2

    beta0, beta1 = 0.5, 1.25
    rng = np.random.default_rng(3)
    m = 6000
    x0 = rng.normal(0.0, np.sqrt(1.0 / beta0), m)
    s = np.sqrt(beta0 / beta1)
    x1 = s * x0
    dlogps = np.full(m, -np.log(s))  # log q(x1) - log p0(x0) for x1 = s x0

    x1_out, w = calculate_weights(x0, x1[None], dlogps[None], beta1, beta0=beta0,
                                  potential=Harmonic())
    np.testing.assert_allclose(x1_out, x1)
    assert np.std(np.log(w)) < 1e-6  # perfect transport => constant weights

    Omega = sample_rff_gaussian(0, 1, 64, 0.5)
    for samples, weights in ((x1_out, w),
                             (x0, direct_weights(x0, beta0, beta1, potential=Harmonic()))):
        res = resample_with_weights(samples, weights, seed=0)
        mean, lo, hi = bootstrap_generator_eigenvalues(
            res.reshape(1, -1), Omega, nev=4, a=2.0 / beta1, tol=1e-4, n_bootstrap=50, seed=0)
        # negated eigenvalues (decay rates), as the reference's pipeline returns
        np.testing.assert_allclose(np.real(mean), [3.0, 2.0, 1.0, 0.0], atol=0.35)
