"""The closed forms of the harmonic-well physics oracles (host numpy).

Synthetic frames are exact Boltzmann samples of an isotropic harmonic well
of width sigma_T = jitter * sqrt(T / 300), COM-centred: around a molecule's
equilibrium geometry for the ambient (TFEP) oracle, around the origin for
the latent (Boltzmann-generator) and composed BG→TI oracles. With 3(N - 1)
degrees of freedom after the COM projection, the free-energy difference
and the partition function are closed-form:

- dF(T0 → T1) = -3(N - 1) ln(sigma_T1 / sigma_T0), the TFEP estimate
  -log mean exp(-phi) with phi = u_T1(x1) - u_T0(x0) + dlogp;
- -log Z_T = -3(N - 1)/2 ln(2 pi sigma_T^2), the BG estimate -log mean w
  with log w = -u_T(x) - log p(z) - dlogp, whatever the generator.

Shared by the validation CLIs (``ti_torch/cli/validate_*_physics.py``) and
the card oracles (``tools/torch_{ambient,latent}_oracle.py``).
"""

from __future__ import annotations

import numpy as np


def well_sigma(T: float, jitter: float) -> float:
    """The well's width at temperature ``T``: jitter * sqrt(T / 300)."""
    return jitter * np.sqrt(T / 300.0)


def well_energy(x: np.ndarray, sigma: float, p_eq=None) -> np.ndarray:
    """Reduced energy |center(x) - p_eq|^2 / (2 sigma^2) of frames x (..., N,
    3) (``p_eq`` None: a well at the origin)."""
    xc = x - x.mean(axis=-2, keepdims=True)
    if p_eq is not None:
        xc = xc - p_eq
    return np.sum(xc ** 2, axis=(-2, -1)) / (2.0 * sigma ** 2)


def rms_width(x: np.ndarray, d_eff: int, p_eq=None) -> float:
    """sqrt(mean |center(x) - p_eq|^2 / d_eff): sigma for well samples."""
    xc = x - x.mean(axis=-2, keepdims=True)
    if p_eq is not None:
        xc = xc - p_eq
    return float(np.sqrt(np.sum(xc ** 2, axis=(-2, -1)).mean() / d_eff))


def neg_log_mean_exp(log_w: np.ndarray) -> float:
    """-log mean exp(log_w), shifted by the maximum: the TFEP dF of
    log_w = -phi, or -log Z of BG log-weights."""
    mx = log_w.max()
    return float(-(mx + np.log(np.mean(np.exp(log_w - mx)))))


def ess_of_log_w(log_w: np.ndarray) -> float:
    """Kish effective sample size (sum w)^2 / sum w^2 of w = exp(log_w)."""
    w = np.exp(log_w - log_w.max())
    return float(np.square(w.sum()) / np.sum(np.square(w)))


def tfep_dF_exact(n_atoms: int, sigma0: float, sigma1: float) -> float:
    """dF(T0 → T1) = -3(N - 1) ln(sigma1 / sigma0)."""
    return float(-3 * (n_atoms - 1) * np.log(sigma1 / sigma0))


def gaussian_log_pz(z: np.ndarray, d_eff: int) -> np.ndarray:
    """log N(z; 0, I) of COM-free noise z (n, N, 3) in its d_eff dimensions."""
    return -0.5 * np.sum(z ** 2, axis=(1, 2)) - 0.5 * d_eff * np.log(2 * np.pi)


def neg_log_z_exact(sigma: float, d_eff: int) -> float:
    """-log Z = -d_eff/2 ln(2 pi sigma^2) of the origin-centred well."""
    return float(-0.5 * d_eff * np.log(2 * np.pi * sigma ** 2))


def zero_com_coords(z: np.ndarray) -> np.ndarray:
    """COM-free noise z (n, N, 3) in an orthonormal basis of the zero-COM
    subspace, (n, N - 1, 3): |result| = |z|, so a N(0, I) density over its
    3(N - 1) numbers is the noise's own."""
    n_atoms = z.shape[1]
    q, _ = np.linalg.qr(np.eye(n_atoms) - 1.0 / n_atoms)  # columns span it
    return np.einsum("ij,njc->nic", q[:, : n_atoms - 1].T, z)
