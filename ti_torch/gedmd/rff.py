"""gEDMD with random Fourier features, restructured around Gram reductions
(a copy of ti_tpu/gedmd/rff.py, which is numpy only; here the bootstrap forms its
weighted Grams as BLAS products).

Rebuild of the reference gEDMD package (gedmd/rff.py, gedmd/rff_tools.py,
gedmd/util.py — itself derived from the public KoopmanLib). Same math,
restructured:

- All data-sized contractions collapse to p×p Gram matrices FIRST
  (G = M†M, G_xy = M†Mt), so the whitened eigenproblem
  R = L† (M†AM) L never forms the m×r right-singular-vector matrix:
  V = M L exactly, hence V† Mt L = L† (M†Mt) L.
- The 1000× bootstrap (reference adw/analysis/reweight_gedmd.py:45-59 — a
  Python loop re-running the full pipeline per resample) becomes a batched
  weighted-Gram computation: resampling a dataset only reweights its Gram,
  G_w = M† diag(w) M, followed by one batched Hermitian eigensolve.
- Rank truncation is done by masking + a -inf diagonal pad so the batched
  eigensolves keep static shapes.

Precision note: the Gram squares the condition number of M, and the
reference's svd cutoff tol=1e-4 corresponds to an eigenvalue ratio of 1e-8 —
below float32 resolution. The eigensolves and Grams therefore run in
float64 on the host (numpy/BLAS), exactly where the reference runs them
(scipy.linalg); these are p ≤ ~300 problems, far from card-sized. The
card's piece — producing the samples the spectra are estimated from —
lives in ti_torch.sampling.

Conventions match the reference: eigenvalues ascending by real part, top
``nev`` retained, generator reversible with constant diffusion a
(ML = -a/2 (ΩᵀΩ) ∘ (M†M), gedmd/rff.py:115).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

ArrayLike = Union[np.ndarray, Sequence]

_NEG_PAD = -1e30  # masked (rank-truncated) modes sort to the bottom


def _rng(seed) -> np.random.Generator:
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# RFF frequency sampling (reference gedmd/rff_tools.py)
# ---------------------------------------------------------------------------

def sample_rff_gaussian(seed, d: int, p: int, sigma: float) -> np.ndarray:
    """Spectral-measure sample for the Gaussian kernel: Ω = σ⁻¹ randn(d, p)."""
    return (1.0 / sigma) * _rng(seed).standard_normal((d, p))


def sample_rff_gauss_periodic(
    seed, d: int, p: int, L: float, sigma: float, kmax: int
) -> np.ndarray:
    """Spectral-measure sample for the periodic Gaussian kernel via the
    Bessel-weighted wavenumber grid (reference rff_tools.py:35-66)."""
    from scipy.special import iv

    omega0 = np.pi / L
    kvec = np.arange(-kmax, kmax + 1)
    pvec = iv(kvec, sigma ** (-2)) / np.exp(sigma ** (-2))
    pvec = pvec / pvec.sum()
    return omega0 * _rng(seed).choice(kvec, size=(d, p), replace=True, p=pvec)


# ---------------------------------------------------------------------------
# Feature matrices and Grams
# ---------------------------------------------------------------------------

def _concat_trajs(X) -> np.ndarray:
    if isinstance(X, (list, tuple)):
        return np.concatenate([np.asarray(x, dtype=np.float64) for x in X], axis=1)
    return np.asarray(X, dtype=np.float64)


def _features(X: np.ndarray, Omega: np.ndarray) -> np.ndarray:
    """M = exp(-i XᵀΩ), (m, p) complex128. X: (d, m), Ω: (d, p)."""
    return np.exp(-1j * (X.T @ np.asarray(Omega, dtype=np.float64)))


def rff_matrices_koopman(X, Y, Omega) -> Tuple[np.ndarray, np.ndarray]:
    """(M, Mt) feature matrices at the data and time-shifted data
    (reference M_RFF_Koopman, gedmd/rff.py:48-68)."""
    return _features(_concat_trajs(X), Omega), _features(_concat_trajs(Y), Omega)


def rff_gram_generator(
    X, Omega, a: float, weights: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """(G, ML) for the reversible constant-diffusion generator.

    G = M†WM, ML = -a/2 (ΩᵀΩ) ∘ G (reference M_RFF_Generator reversible
    branch, gedmd/rff.py:115). ``weights``: optional per-sample counts
    (bootstrap reweighting)."""
    M = _features(_concat_trajs(X), Omega)
    Mw = M if weights is None else M * np.asarray(weights)[:, None]
    G = M.conj().T @ Mw
    Omega = np.asarray(Omega, dtype=np.float64)
    ML = -0.5 * a * (Omega.T @ Omega) * G
    return G, ML


def _concat_diffusion(a):
    """Diffusion given per-trajectory as a list of (d, d, m_i) → (d, d, m)
    (reference spectral_analysis_rff_generator, gedmd/rff.py:310-313)."""
    if isinstance(a, float):
        return a
    if isinstance(a, (list, tuple)):
        return np.concatenate([np.asarray(ia, dtype=np.float64) for ia in a], axis=2)
    return np.asarray(a, dtype=np.float64)


def _concat_drift(b):
    if b is None:
        return None
    if isinstance(b, (list, tuple)):
        return np.concatenate([np.asarray(ib, dtype=np.float64) for ib in b], axis=1)
    return np.asarray(b, dtype=np.float64)


def rff_ml_nonreversible(
    M: np.ndarray, Omega: np.ndarray, a, b: Optional[np.ndarray] = None
) -> np.ndarray:
    """ML (m, p): generator applied to all features at all data points,
    non-reversible formulation (reference M_RFF_Generator non-reversible
    branch, gedmd/rff.py:100-110).

    a: float (constant scalar diffusion) or (d, d, m) tensor at each data
    site; b: optional (d, m) drift field."""
    Omega = np.asarray(Omega, dtype=np.float64)
    if isinstance(a, float):
        ML = -0.5 * a * M * (np.linalg.norm(Omega, axis=0) ** 2)[None, :]
    else:
        a = np.asarray(a, dtype=np.float64)
        # quad[m, p] = Σ_ij a[i,j,m] Ω[i,p] Ω[j,p]
        quad = np.einsum("ijm,ip,jp->mp", a, Omega, Omega, optimize=True)
        ML = -0.5 * quad * M
    if b is not None:
        ML = ML + (-1j) * (np.asarray(b, dtype=np.float64).T @ Omega) * M
    return ML


def rff_ml_reversible(
    M: np.ndarray,
    Omega: np.ndarray,
    a,
    weights: Optional[np.ndarray] = None,
    chunk: int = 2048,
) -> np.ndarray:
    """p×p contraction of feature gradients with the diffusion field,
    reversible formulation (reference M_RFF_Generator reversible branch,
    gedmd/rff.py:113-121): ML_uv = -½ Σ_l conj(M)_lu (Ω_u† a_l Ω_v) M_lv.

    a: float or (d, d, m). The general case is evaluated in data chunks so
    only (d, p, chunk) intermediates are materialized (the reference forms
    the full p×p×m tensors, :118-119)."""
    Omega = np.asarray(Omega, dtype=np.float64)
    if isinstance(a, float):
        Mw = M if weights is None else M * np.asarray(weights)[:, None]
        return -0.5 * a * (Omega.T @ Omega) * (M.conj().T @ Mw)
    a = np.asarray(a, dtype=np.float64)
    m, p = M.shape
    ML = np.zeros((p, p), dtype=np.complex128)
    for lo in range(0, m, chunk):
        sl = slice(lo, min(lo + chunk, m))
        Mc = M[sl]  # (c, p)
        P = np.einsum("ijl,jv->ivl", a[:, :, sl], Omega, optimize=True)  # (d,p,c)
        C = P * Mc.T[None, :, :]
        if weights is not None:
            C = C * np.asarray(weights)[sl][None, None, :]
        D = Omega[:, :, None] * Mc.conj().T[None, :, :]
        ML += np.einsum("iul,ivl->uv", D, C, optimize=True)
    return -0.5 * ML


# ---------------------------------------------------------------------------
# Whitening + eigen-filtering (reference gedmd/util.py)
# ---------------------------------------------------------------------------

def whitening_transform(G: np.ndarray, tol: float, rmin: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Masked whitening L (p, p) from the Hermitian Gram G = M†M.

    Equivalent to the reference's truncated SVD of PhiX = M†
    (gedmd/util.py:34-69): singular values s_i = sqrt(eigh(G)) descending,
    keep s/s_max >= tol with a floor of ``rmin`` modes. Truncated columns of
    L are zeroed (static shape); returns (L, keep_mask)."""
    lam, U = np.linalg.eigh(G)
    lam, U = lam[::-1], U[:, ::-1]
    s = np.sqrt(np.maximum(lam, 0.0))
    keep = s / s[0] >= tol
    if rmin > 0:
        keep |= np.arange(s.shape[0]) < rmin
    # Gram eigenvalues below machine noise (eps*lam_max) can round to <= 0,
    # i.e. s = 0 exactly — the SVD route's singulars bottom out at
    # ~sqrt(eps)*s_max instead (gedmd/util.py:54). Clamp to that same noise
    # floor so tol=0 (keep everything) cannot overflow L into inf/NaN.
    floor = s[0] * np.sqrt(np.finfo(s.dtype).eps)
    inv_s = np.where(keep, 1.0 / np.maximum(s, floor), 0.0)
    return U * inv_s[None, :], keep


def filter_ev(d: np.ndarray, W: np.ndarray, eps1: float = -np.inf, eps2: float = np.inf):
    """Sort ascending by real part; drop eigenvalues outside (eps1, eps2)
    (reference gedmd/util.py:72-98)."""
    d, W = np.asarray(d), np.asarray(W)
    ind = np.argsort(np.real(d))
    d, W = d[ind], W[:, ind]
    ind = np.where((np.real(d) > eps1) & (np.real(d) < eps2))[0]
    return d[ind], W[:, ind]


def split_by_lag(Xfull, lag: int):
    """Time-shifted (X, Y) pairs from one trajectory or a list of them
    (reference gedmd/util.py:101-124)."""
    if isinstance(Xfull, (list, tuple)):
        X = np.concatenate([np.asarray(x)[:, :-lag] for x in Xfull], axis=1)
        Y = np.concatenate([np.asarray(x)[:, lag:] for x in Xfull], axis=1)
        return X, Y
    Xfull = np.asarray(Xfull)
    return Xfull[:, :-lag], Xfull[:, lag:]


# ---------------------------------------------------------------------------
# Spectral analysis (reference gedmd/rff.py:244-342)
# ---------------------------------------------------------------------------

def spectral_analysis_rff_generator(
    X, Omega, nev: int, a, b=None, tol: float = 0.0, reversible: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-``nev`` (ascending) eigenpairs of the Koopman generator
    (reference spectral_analysis_rff_generator, gedmd/rff.py:283-342).

    a: float (constant scalar diffusion) or (d, d, m) tensor (or list per
    trajectory); b: optional (d, m) drift, used only when
    reversible=False (the reference also ignores b in the reversible
    formulation, :317-319). The reversible constant-a branch is the one
    every reference pipeline uses (adw/analysis/reweight_gedmd.py:39-43,
    mdqm9/analysis/gedmd.py:36-56). Returns (d (nev,), W (p, nev))."""
    Xc = _concat_trajs(X)
    a = _concat_diffusion(a)
    b = None if reversible else _concat_drift(b)
    M = _features(Xc, Omega)
    G = M.conj().T @ M
    L, keep = whitening_transform(G, tol, rmin=nev)
    if reversible:
        ML = rff_ml_reversible(M, Omega, a)
        R = L.conj().T @ ML @ L + np.diag(np.where(keep, 0.0, _NEG_PAD))
        d, Wi = np.linalg.eigh(R)
        return d[-nev:], L @ Wi[:, -nev:]
    # non-reversible: R = V† ML L with V = M L, i.e. L† (M† ML) L — the
    # Gram restructure of the reference's svd-V path (gedmd/rff.py:323-329)
    ML = rff_ml_nonreversible(M, Omega, a, b)
    A = M.conj().T @ ML
    R = L.conj().T @ A @ L + np.diag(np.where(keep, 0.0, _NEG_PAD))
    d, Wi = np.linalg.eig(R)
    d, Wi = filter_ev(d, Wi, eps1=_NEG_PAD / 2)
    return d[-nev:], L @ Wi[:, -nev:]


def spectral_analysis_rff_koopman(
    X, Omega, lag: int, nev: int, tol: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-``nev`` eigenpairs of the finite-lag Koopman operator:
    R = L† (M†Mt) L (reference gedmd/rff.py:244-280)."""
    Xs, Ys = split_by_lag(X, lag)
    M = _features(np.asarray(Xs, dtype=np.float64), Omega)
    Mt = _features(np.asarray(Ys, dtype=np.float64), Omega)
    G = M.conj().T @ M
    Gxy = M.conj().T @ Mt
    L, keep = whitening_transform(G, tol, rmin=nev)
    R = L.conj().T @ Gxy @ L + np.diag(np.where(keep, 0.0, _NEG_PAD))
    d, Wi = np.linalg.eig(R)
    d, Wi = filter_ev(d, Wi, eps1=_NEG_PAD / 2)
    return d[-nev:], L @ Wi[:, -nev:]


# ---------------------------------------------------------------------------
# Bootstrap: batched weighted-Gram eigensolves instead of a python re-run loop
# ---------------------------------------------------------------------------

def bootstrap_generator_eigenvalues(
    X,
    Omega,
    nev: int,
    a: float,
    tol: float = 0.0,
    n_bootstrap: int = 1000,
    seed=0,
    chunk: int = 128,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mean, lo95, hi95) of the NEGATED top-``nev`` generator eigenvalues
    over multinomial bootstrap resamples (reference
    adw/analysis/reweight_gedmd.py:45-59; eigenvalues negated at :53).

    The features M are computed once; each resample reweights the Gram
    (G_w = M† diag(w) M) — a batched BLAS contraction plus a batched p×p
    eigensolve, instead of 1000 full pipeline re-runs."""
    rng = _rng(seed)
    Xc = _concat_trajs(X)
    m = Xc.shape[1]
    M = _features(Xc, Omega)  # (m, p)
    Mh = M.conj().T
    Omega = np.asarray(Omega, dtype=np.float64)
    OtO = Omega.T @ Omega
    p = M.shape[1]

    eigs = np.empty((n_bootstrap, nev))
    done = 0
    while done < n_bootstrap:
        b = min(chunk, n_bootstrap - done)
        idx = rng.integers(0, m, size=(b, m))
        counts = np.stack([np.bincount(row, minlength=m) for row in idx]).astype(np.float64)
        # weighted Grams G_w = M† diag(w) M, one BLAS product a resample
        # (numpy's einsum of the three operands takes no BLAS path: 27x
        # slower at m = 30,000, p = 50)
        Gw = np.stack([(Mh * c) @ M for c in counts])
        MLw = -0.5 * a * OtO[None] * Gw

        lam, U = np.linalg.eigh(Gw)  # batched, ascending
        lam, U = lam[:, ::-1], U[:, :, ::-1]
        s = np.sqrt(np.maximum(lam, 0.0))
        keep = s / s[:, :1] >= tol
        keep |= np.arange(p)[None, :] < nev
        # same sqrt(eps)*s_max noise floor as whitening_transform: at tol=0
        # a machine-noise mode would otherwise get a ~1e9 whitening column
        # and garbage eigenvalues (the guard paths must agree)
        floor = s[:, :1] * np.sqrt(np.finfo(s.dtype).eps)
        inv_s = np.where(keep, 1.0 / np.maximum(s, floor), 0.0)
        L = U * inv_s[:, None, :]
        R = L.conj().transpose(0, 2, 1) @ MLw @ L
        R = R + np.where(keep, 0.0, _NEG_PAD)[:, :, None] * np.eye(p)[None]
        d = np.linalg.eigvalsh(R)
        eigs[done : done + b] = -d[:, -nev:]  # negate like the reference
        done += b

    return (
        eigs.mean(axis=0),
        np.percentile(eigs, 2.5, axis=0),
        np.percentile(eigs, 97.5, axis=0),
    )


# ---------------------------------------------------------------------------
# VAMP cross-validation (reference gedmd/rff.py:126-240, 347-406)
# ---------------------------------------------------------------------------

def _vamp_score_generator(M_test: np.ndarray, Omega: np.ndarray, a, W: np.ndarray) -> float:
    """VAMP score of subspace W on held-out features: orthonormalize
    M_test W, sum eigenvalues of the reduced generator (reference
    _score_test_data_generator, gedmd/rff.py:347-377). a: float or the
    (d, d, m_test) diffusion at the held-out sites."""
    G = M_test.conj().T @ M_test
    ML = rff_ml_reversible(M_test, Omega, a)
    B = W.conj().T @ G @ W
    lam, U = np.linalg.eigh(B)
    ok = lam > lam[-1] * 1e-12
    L0 = W @ (U[:, ok] * lam[ok] ** -0.5)
    return float(np.sum(np.linalg.eigvalsh(L0.conj().T @ ML @ L0)))


def cv_generator_rff(
    X, Omega, a, rtrain: float, ntest: int, nev: int, tol: float = 0.0, seed=0
) -> Tuple[np.ndarray, np.ndarray]:
    """Repeated random-split VAMP scoring for the reversible generator
    (reference cv_generator_rff, gedmd/rff.py:180-240). a: float, or a
    (d, d, m) tensor (or list per trajectory) shuffled alongside the data
    (reference :214-222). Returns (eigenvalues (ntest, nev),
    scores (ntest,))."""
    rng = _rng(seed)
    Xc = _concat_trajs(X)
    a = _concat_diffusion(a)
    m = Xc.shape[1]
    M = _features(Xc, Omega)
    Omega = np.asarray(Omega, dtype=np.float64)
    ntrain = int(rtrain * m)
    general_a = not isinstance(a, float)

    d_out = np.zeros((ntest, nev))
    scores = np.zeros(ntest)
    for ii in range(ntest):
        perm = rng.permutation(m)
        Mtr, Mte = M[perm[:ntrain]], M[perm[ntrain:]]
        atr = a[:, :, perm[:ntrain]] if general_a else a
        ate = a[:, :, perm[ntrain:]] if general_a else a
        G = Mtr.conj().T @ Mtr
        ML = rff_ml_reversible(Mtr, Omega, atr)
        L, keep = whitening_transform(G, tol, rmin=nev)
        R = L.conj().T @ ML @ L + np.diag(np.where(keep, 0.0, _NEG_PAD))
        d, Wi = np.linalg.eigh(R)
        d_out[ii] = d[-nev:]
        scores[ii] = _vamp_score_generator(Mte, Omega, ate, L @ Wi[:, -nev:])
    return d_out, scores


def cv_koopman_rff(
    X, Omega, lag: int, rtrain: float, ntest: int, nev: int,
    tol: float = 0.0, eps: float = 1e-4, seed=0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Repeated random-split VAMP scoring for the finite-lag Koopman
    operator (reference cv_koopman_rff, gedmd/rff.py:126-178)."""
    rng = _rng(seed)
    Xs, Ys = split_by_lag(X, lag)
    M = _features(np.asarray(Xs, dtype=np.float64), Omega)
    Mt = _features(np.asarray(Ys, dtype=np.float64), Omega)
    m = M.shape[0]
    ntrain = int(rtrain * m)

    d_out = np.zeros((ntest, nev), dtype=complex)
    scores = np.zeros(ntest)
    for ii in range(ntest):
        perm = rng.permutation(m)
        Mtr, Mte = M[perm[:ntrain]], M[perm[ntrain:]]
        Mttr, Mtte = Mt[perm[:ntrain]], Mt[perm[ntrain:]]
        G = Mtr.conj().T @ Mtr
        Gxy = Mtr.conj().T @ Mttr
        L, keep = whitening_transform(G, tol, rmin=nev)
        R = L.conj().T @ Gxy @ L + np.diag(np.where(keep, 0.0, _NEG_PAD))
        d, Wi = np.linalg.eig(R)
        d, Wi = filter_ev(d, Wi, eps1=_NEG_PAD / 2, eps2=1.0 + eps)
        Wsub = L @ Wi[:, -nev:]
        d_out[ii] = d[-nev:]
        # test score: orthonormalize M_test Wsub, sum real parts of reduced eig
        Gt = Mte.conj().T @ Mte
        Gt_xy = Mte.conj().T @ Mtte
        B = Wsub.conj().T @ Gt @ Wsub
        lam, U = np.linalg.eigh(B)
        ok = lam > lam[-1] * 1e-12
        L0 = Wsub @ (U[:, ok] * lam[ok] ** -0.5)
        scores[ii] = float(np.sum(np.real(np.linalg.eigvals(L0.conj().T @ Gt_xy @ L0))))
    return d_out, scores
