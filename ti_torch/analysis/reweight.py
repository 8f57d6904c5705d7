"""ADW reweighted-gEDMD kinetics pipelines (a copy of
ti_tpu/analysis/reweight.py over the port's own modules).

Counterpart of the reference analysis scripts
(adw/analysis/reweight_gedmd.py, adw/analysis/dir_reweight_gedmd.py):
transport-based reweighting of generated samples followed by bootstrap
gEDMD generator spectra. The 1000x bootstrap runs as one batched
weighted-Gram computation (gedmd.rff.bootstrap_generator_eigenvalues)
instead of the reference's python re-run loop.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ti_torch.analysis.potentials import AsymmetricDoubleWell
from ti_torch.analysis.weights import resample_with_weights, weights_filter_iqr
from ti_torch.gedmd.rff import bootstrap_generator_eigenvalues, sample_rff_gaussian


def calculate_weights(
    initial_samples: np.ndarray,
    target_samples: np.ndarray,
    dlogps: np.ndarray,
    beta: float,
    beta0: float = 1.0,
    potential: Optional[AsymmetricDoubleWell] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(final samples, importance weights) for transport beta0 -> beta.

    log w = beta0 E(x0) - beta E(x1) - dlogp, with the ADW potential
    (reference adw/analysis/reweight_gedmd.py:26-36; the reference hardcodes
    beta0=1.0 at :33)."""
    pot = potential or AsymmetricDoubleWell()
    dlogp_t = np.asarray(dlogps)[-1]
    x1 = np.asarray(target_samples)[-1]
    log_w = beta0 * np.asarray(pot(np.asarray(initial_samples))) - beta * np.asarray(pot(x1)) - dlogp_t
    return x1, np.exp(log_w)


def direct_weights(samples: np.ndarray, initial_beta: float, target_beta: float,
                   potential: Optional[AsymmetricDoubleWell] = None) -> np.ndarray:
    """Direct Boltzmann reweighting baseline w = exp((beta0-beta1) E)
    (reference adw/analysis/dir_reweight_gedmd.py:27-30)."""
    pot = potential or AsymmetricDoubleWell()
    return np.exp((initial_beta - target_beta) * np.asarray(pot(np.asarray(samples))))


def reweighted_gedmd_spectrum(
    initial_samples: np.ndarray,
    target_samples: np.ndarray,
    dlogps: np.ndarray,
    beta: float,
    *,
    p: int = 50,
    sigma: float = 0.6,
    nev: int = 4,
    cut_svd: float = 1e-4,
    n_bootstrap: int = 1000,
    seed: int = 0,
    Omega: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Full reference pipeline (adw/analysis/reweight_gedmd.py:79-123):
    TI weights -> IQR filter -> multinomial resampling -> bootstrap gEDMD
    generator eigenvalues (negated), with a = 2/beta."""
    if Omega is None:
        Omega = sample_rff_gaussian(seed, 1, p, sigma)
    x1, w = calculate_weights(initial_samples, target_samples, dlogps, beta)
    keep = weights_filter_iqr(w)
    x1f, wf = x1[keep], w[keep]
    resampled = resample_with_weights(x1f, wf, seed=seed)
    mean, lo, hi = bootstrap_generator_eigenvalues(
        resampled.reshape(1, -1), Omega, nev=nev, a=2.0 / beta, tol=cut_svd,
        n_bootstrap=n_bootstrap, seed=seed,
    )
    return {
        "eigenvalues_mean": mean,
        "lower_bound": lo,
        "upper_bound": hi,
        "weights": w,
        "n_filtered": int(len(w) - keep.sum()),
    }


def direct_reweighted_gedmd_spectrum(
    md_samples: np.ndarray,
    initial_beta: float,
    target_beta: float,
    *,
    p: int = 50,
    sigma: float = 0.6,
    nev: int = 4,
    cut_svd: float = 1e-4,
    n_bootstrap: int = 1000,
    seed: int = 0,
    Omega: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Direct-reweighting baseline pipeline
    (reference adw/analysis/dir_reweight_gedmd.py:63-103)."""
    if Omega is None:
        Omega = sample_rff_gaussian(seed, 1, p, sigma)
    w = direct_weights(md_samples, initial_beta, target_beta)
    resampled = resample_with_weights(np.asarray(md_samples), w, seed=seed)
    mean, lo, hi = bootstrap_generator_eigenvalues(
        resampled.reshape(1, -1), Omega, nev=nev, a=2.0 / target_beta, tol=cut_svd,
        n_bootstrap=n_bootstrap, seed=seed,
    )
    return {"eigenvalues_mean": mean, "lower_bound": lo, "upper_bound": hi, "weights": w}
