"""MDQM9 torsion-space kinetics: gEDMD spectra + RFF model selection (a copy
of ti_tpu/analysis/kinetics.py, which is numpy only; it runs over the
port's copy of gedmd/rff.py).

Counterparts of the reference scripts mdqm9/analysis/gedmd.py (generator
spectra on the 6 torsion coordinates across temperatures, beta in kJ/mol
units, bootstrap CIs) and mdqm9/analysis/model_selection.py +
adw/analysis/model_selection.py (VAMP cross-validation grids over the RFF
bandwidth sigma and feature count p).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ti_torch.gedmd.rff import (
    bootstrap_generator_eigenvalues,
    cv_generator_rff,
    sample_rff_gaussian,
)

KB_KJ_PER_MOL_K = 0.008314462618  # Boltzmann constant in kJ/(mol K)


def subsample_columns(X: np.ndarray, max_samples: Optional[int], seed: int = 0) -> np.ndarray:
    """Uniformly subsample the sample axis of a (d, m) matrix to at most
    ``max_samples`` columns (bounds the bootstrap cost). Shared by
    load_torsions and the kinetics CLIs (scripts/mdqm9_gedmd.py subsamples
    AFTER weight-resampling, so it cannot do it at load)."""
    if max_samples is not None and X.shape[1] > max_samples:
        rng = np.random.default_rng(seed)
        X = X[:, rng.choice(X.shape[1], max_samples, replace=False)]
    return X


def load_torsions(path: str, max_samples: Optional[int] = None, seed: int = 0) -> np.ndarray:
    """Load a torsions .npy as (d, m): the on-disk arrays are (m, d) or
    (d, m) (the results layer saves sample-major, the reference's kinetics
    scripts consume feature-major) — disambiguated by m >> d; optional
    uniform subsample to bound the bootstrap cost. Shared by
    scripts/mdqm9_gedmd.py and scripts/model_selection.py."""
    t = np.load(path)
    X = t.T if t.ndim == 2 and t.shape[0] > t.shape[1] else np.atleast_2d(t)
    return subsample_columns(X, max_samples, seed)


def beta_kj_per_mol(T: float) -> float:
    """Inverse temperature 1/(kB T) in (kJ/mol)^-1 — the unit convention of
    the reference torsion-kinetics script (mdqm9/analysis/gedmd.py:22-34)."""
    return 1.0 / (KB_KJ_PER_MOL_K * T)


def torsion_generator_spectrum(
    torsions: np.ndarray,
    T: float,
    *,
    p: int = 300,
    sigma: float = 5.0,
    nev: int = 4,
    cut_svd: float = 1e-4,
    n_bootstrap: int = 1000,
    seed: int = 0,
    Omega: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Bootstrap generator eigenvalues on torsion coordinates at
    temperature T (reference mdqm9/analysis/gedmd.py:36-56; p=300,
    sigma=5.0 at :13-16). torsions: (d, m) with d the number of torsions.

    Diffusion convention: the molecular scripts use a = 1/beta
    (mdqm9/analysis/gedmd.py:12, model_selection.py:46) — NOTE this
    differs from the ADW pipeline's a = 2/beta
    (adw/analysis/reweight_gedmd.py:41); eigenvalues scale linearly
    with a, so mixing the two is a clean 2x scale error."""
    torsions = np.asarray(torsions, dtype=np.float64)
    d = torsions.shape[0]
    if Omega is None:
        Omega = sample_rff_gaussian(seed, d, p, sigma)
    beta = beta_kj_per_mol(T)
    mean, lo, hi = bootstrap_generator_eigenvalues(
        torsions, Omega, nev=nev, a=1.0 / beta, tol=cut_svd,
        n_bootstrap=n_bootstrap, seed=seed,
    )
    return {"eigenvalues_mean": mean, "lower_bound": lo, "upper_bound": hi, "beta": beta}


def model_selection_scan(
    X: np.ndarray,
    a: float,
    *,
    sigma_list: Sequence[float] = (1e-2, 5e-2, 1e-1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.8, 1.0, 2.0),
    p_list: Sequence[int] = (50, 100, 200, 300, 400, 500),
    ntest: int = 20,
    rtrain: float = 0.75,
    nev: int = 4,
    cut_svd: float = 1e-4,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """VAMP-score grid over (sigma, p) for the reversible generator
    (reference adw/analysis/model_selection.py:17-51,
    mdqm9/analysis/model_selection.py). Returns EV (S, P, ntest, nev) and
    VAMP = -test score (S, P, ntest), matching the reference's sign
    convention at model_selection.py:44."""
    X = np.asarray(X, dtype=np.float64)
    d = X.shape[0]
    S, P = len(sigma_list), len(p_list)
    ev = np.zeros((S, P, ntest, nev))
    vamp = np.zeros((S, P, ntest))
    for i, sigma in enumerate(sigma_list):
        for j, p in enumerate(p_list):
            Omega = sample_rff_gaussian(seed, d, p, sigma)
            d_ij, scores = cv_generator_rff(
                X, Omega, a=a, rtrain=rtrain, ntest=ntest, nev=nev, tol=cut_svd, seed=seed
            )
            ev[i, j] = d_ij
            vamp[i, j] = -scores
    return {
        "EV": ev,
        "VAMP": vamp,
        "sigma_list": np.asarray(sigma_list),
        "p_list": np.asarray(p_list),
    }


def best_hyperparameters(scan: Dict[str, np.ndarray]):
    """(sigma, p) maximizing the mean VAMP score."""
    mean_vamp = scan["VAMP"].mean(axis=-1)
    i, j = np.unravel_index(np.argmax(mean_vamp), mean_vamp.shape)
    return float(scan["sigma_list"][i]), int(scan["p_list"][j])
