"""Importance weights, ESS, and outlier filters.

Vectorized counterparts of the reference utilities
(mdqm9/analysis/utils/ess.py, mdqm9/analysis/utils/sensititvity.py,
adw/analysis/reweight_gedmd.py:61-76). Sign conventions follow the
reference exactly: ``neg_dlogps`` is the reference's (misleading) name for
the dlogp arrays the samplers save — the analysis scripts load them
UNCHANGED (results_00031.py:180-190), and phi = E1 - E0 + dlogp_saved.
"""

from __future__ import annotations

import numpy as np


def calc_ti_weights(E0s, E1s, neg_dlogps_ti) -> np.ndarray:
    """TI reweighting: w = exp(-(E1 - E0 + (-dlogp)))
    (reference ess.py:8-10). Energies are reduced (E/kBT)."""
    phis = np.asarray(E1s) - np.asarray(E0s) + np.asarray(neg_dlogps_ti)
    return np.exp(-phis)


def calc_log_mvnormal_pzs(z0s: np.ndarray) -> np.ndarray:
    """log N(z; 0, I) for flattened latent draws (reference ess.py:26-29).
    Closed form instead of scipy.stats (same value)."""
    z = np.asarray(z0s).reshape(len(z0s), -1)
    d = z.shape[1]
    return -0.5 * np.sum(z**2, axis=1) - 0.5 * d * np.log(2.0 * np.pi)


def calc_importance_weights(z0s, E1s, neg_dlogps_bg, neg_dlogps_ti) -> np.ndarray:
    """Boltzmann-generator importance weights
    w = exp(-E1 - log N(z;0,I) - ((-dlogp_bg) + (-dlogp_ti)))
    (reference ess.py:13-23). neg_dlogps_ti may be zeros for the pure-BG
    route."""
    log_pzs = calc_log_mvnormal_pzs(z0s)
    return np.exp(
        -np.asarray(E1s) - log_pzs - (np.asarray(neg_dlogps_bg) + np.asarray(neg_dlogps_ti))
    )


def calc_ess(weights) -> float:
    """Kish effective sample size (Σw)²/Σw² (reference ess.py:32-35)."""
    w = np.asarray(weights)
    return float(np.square(w.sum()) / np.sum(np.square(w)))


# alias with the reference's capitalization for drop-in familiarity
calc_ESS = calc_ess


def filter_iqr(x, k: float | None = 10) -> np.ndarray:
    """Boolean mask keeping x within [q25 - k·IQR, q75 + k·IQR]
    (reference sensititvity.py:4-12). k=None keeps everything."""
    x = np.asarray(x)
    if k is None:
        return np.ones(x.shape, dtype=bool)
    q75, q25 = np.percentile(x, [75, 25])
    iqr = q75 - q25
    return (x > q25 - k * iqr) & (x < q75 + k * iqr)


def weights_filter_iqr(weights) -> np.ndarray:
    """The ADW variant: 2%/98% percentiles ± 10·IQR
    (reference adw/analysis/reweight_gedmd.py:69-76). Bounds are inclusive
    here — the reference's strict inequalities drop EVERYTHING when all
    weights are equal (IQR = 0), which crashes its own resampling step."""
    w = np.asarray(weights)
    q1, q3 = np.percentile(w, [2, 98])
    iqr = q3 - q1
    return (w >= q1 - 10 * iqr) & (w <= q3 + 10 * iqr)


def resample_with_weights(samples, weights, n_samples: int | None = None, seed=0) -> np.ndarray:
    """Multinomial resampling proportional to weights
    (reference adw/analysis/reweight_gedmd.py:61-67)."""
    samples = np.asarray(samples)
    if n_samples is None:
        n_samples = len(samples)
    # inverse-CDF draw: immune to the strict sum-to-1 check of rng.choice
    cdf = np.cumsum(np.asarray(weights, dtype=np.float64))
    u = np.random.default_rng(seed).random(n_samples) * cdf[-1]
    idx = np.searchsorted(cdf, u, side="right")
    return samples[np.clip(idx, 0, len(samples) - 1)]
