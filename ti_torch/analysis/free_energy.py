"""TFEP / Boltzmann-generator free-energy estimators with vectorized
bootstrap confidence intervals.

Counterparts of the reference estimators (mdqm9/analysis/utils/
free_energy.py:9-52) and the per-script bootstrap loops
(mdqm9/analysis/results_00031.py:30-100), which re-ran the estimator in a
1000-iteration python loop; here the bootstrap is one vectorized resample.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from ti_torch.analysis.weights import filter_iqr


def calc_phis_tfep(E0s, E1s, neg_dlogps_ti, k: float | None = None):
    """phi = E1 - E0 + (-dlogp); optional IQR filter on exp(-phi)
    (reference free_energy.py:9-18). Returns (phis, keep_mask)."""
    phis = np.asarray(E1s) - np.asarray(E0s) + np.asarray(neg_dlogps_ti)
    if k is not None:
        keep = filter_iqr(np.exp(-phis), k=k)
        return phis[keep], keep
    return phis, np.ones_like(phis, dtype=bool)


def calc_phis_bg(Es, neg_dlogps_bg, k: float | None = None):
    """phi = E + (-dlogp_bg); optional IQR filter on phi itself
    (reference free_energy.py:21-28)."""
    phis = np.asarray(Es) + np.asarray(neg_dlogps_bg)
    if k is not None:
        phis = phis[filter_iqr(phis, k=k)]
    return phis


def calc_phis_bg_tfep(E0s, neg_dlogps_bg_T0, E1s, neg_dlogps_bg_T1, k: float | None = None):
    """Two-sided BG-TFEP phi = (E1 + (-dlogp1)) - (E0 + (-dlogp0))
    (reference free_energy.py:31-38)."""
    phis = (
        np.asarray(E1s) + np.asarray(neg_dlogps_bg_T1)
        - np.asarray(E0s) - np.asarray(neg_dlogps_bg_T0)
    )
    if k is not None:
        keep = filter_iqr(np.exp(-phis), k=k)
        phis = -np.log(np.exp(-phis)[keep])
    return phis


def debias_phis(phis, dlogp_var):
    """Log-normal debias of stochastic-divergence (Hutchinson) dlogp noise.

    With phi_obs = phi_true + eps, eps ~ N(0, var) independent of the
    sample (the probe noise of a hutchinson dlogp; variance recorded by
    the sampler as ``dlogp_vars_*`` when ``return_dlogp_var`` is set),
    E[e^{-phi_obs}] = E[e^{-phi_true}] e^{var/2} — the documented ~var/2
    bias of -log E[w] at large probe variance (BASELINE.md 10506 probe
    rows). ``phi + var/2`` makes the exponential-mean estimators
    (calc_tfep_dF, ESS weights) unbiased again. No reference counterpart
    (the reference only has the exact autograd divergence)."""
    return np.asarray(phis) + 0.5 * np.asarray(dlogp_var)


def calc_tfep_dF(phis, weights=None) -> float:
    """dF = -log( Σ e^{-phi} w / Σ w ) (reference free_energy.py:41-46),
    evaluated with a log-sum-exp for stability (same value)."""
    phis = np.asarray(phis, dtype=np.float64)
    logw = np.zeros_like(phis) if weights is None else np.log(np.asarray(weights, np.float64))
    a = -phis + logw
    mx = a.max()
    log_num = mx + np.log(np.sum(np.exp(a - mx)))
    mw = logw.max()
    log_den = mw + np.log(np.sum(np.exp(logw - mw)))
    return float(-(log_num - log_den))


def calc_bg_dF(phis) -> float:
    """BG free energy: mean of phis (reference free_energy.py:49-50)."""
    return float(np.mean(phis))


def bootstrap_ci(
    estimator: Callable[..., float],
    arrays: Tuple[np.ndarray, ...],
    n_bootstrap: int = 1000,
    seed=0,
    ci: float = 95.0,
) -> Tuple[float, Tuple[float, float]]:
    """(point_estimate, (lo, hi)) with a percentile bootstrap over rows,
    resampling all arrays jointly (the pattern of every gen_* function in
    mdqm9/analysis/results_00031.py:30-150)."""
    arrays = tuple(np.asarray(a) for a in arrays)
    n = len(arrays[0])
    rng = np.random.default_rng(seed)
    est = estimator(*arrays)
    boots = np.empty(n_bootstrap)
    for i in range(n_bootstrap):
        idx = rng.integers(0, n, n)
        boots[i] = estimator(*(a[idx] for a in arrays))
    alpha = (100.0 - ci) / 2.0
    return est, (float(np.percentile(boots, alpha)), float(np.percentile(boots, 100 - alpha)))
