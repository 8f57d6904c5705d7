"""Paper-figure plotting: internal-coordinate marginals and 2-D projections
(a copy of ti_tpu/analysis/plots.py; matplotlib is imported inside each
``plot_*`` function, so the module imports where it is absent).

Counterpart of the reference's figure notebooks (mdqm9/plots/*.ipynb —
marginal torsion/angle/length histograms with reweighting, TICA
projections via deeptime, molecule renders). Here they are importable
functions writing files, so the figures are reproducible from the artifact
pipeline without notebooks. The slow-feature projection uses an in-repo
TICA (time-lagged canonical correlation via generalized symmetric
eigensolve) instead of the deeptime dependency.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def reweighted_hist(values, weights=None, bins=60, range=None):
    """(centers, density) histogram with optional importance weights."""
    h, edges = np.histogram(values, bins=bins, range=range, weights=weights, density=True)
    return 0.5 * (edges[:-1] + edges[1:]), h


def plot_marginals(
    generated: np.ndarray,
    reference: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    names: Optional[Sequence[str]] = None,
    kind: str = "torsion",
    out_path: Optional[str] = None,
):
    """Grid of per-coordinate marginal histograms: generated (raw +
    reweighted) vs reference MD (the 10506_marginals.ipynb figures).

    generated/reference: (n_samples, n_coords).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    gen = np.asarray(generated)
    n_coords = gen.shape[1]
    ncols = min(4, n_coords)
    nrows = -(-n_coords // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3.2 * ncols, 2.6 * nrows), squeeze=False)
    rng = (-np.pi, np.pi) if kind == "torsion" else None
    for i in range(n_coords):
        ax = axes[i // ncols][i % ncols]
        c, h = reweighted_hist(gen[:, i], bins=60, range=rng)
        ax.plot(c, h, label="generated", lw=1.2)
        if weights is not None:
            c, h = reweighted_hist(gen[:, i], weights=weights, bins=60, range=rng)
            ax.plot(c, h, label="reweighted", lw=1.2)
        if reference is not None:
            c, h = reweighted_hist(np.asarray(reference)[:, i], bins=60, range=rng)
            ax.plot(c, h, label="MD", lw=1.2, ls="--", color="k")
        ax.set_title(names[i] if names else f"{kind} {i}", fontsize=9)
    for j in range(n_coords, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    axes[0][0].legend(fontsize=8)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
    return fig


# CPK-ish element colors/radii for the frame renders (H C N O F)
_ELEM_COLOR = {1: "#e8e8e8", 6: "#404040", 7: "#2e5fd0", 8: "#d02e2e", 9: "#2ed06e"}
_ELEM_SIZE = {1: 60, 6: 160, 7: 170, 8: 170, 9: 150}


def frames_from_artifact(x: np.ndarray) -> np.ndarray:
    """(frames, atoms, 3) conformations to render from a samples .npy.

    Sampler artifacts are batch-major ``(n, n_save, atoms, 3)``
    (sampling/drivers.py incremental saves; scripts/mdqm9_results.py
    consumes ``s[:, -1]`` the same way) — take each sample's FINAL
    conformation. A 3-dim array is already a frame stack and passes
    through. Single home for the artifact axis convention, shared by the
    plots and results CLIs."""
    return x[:, -1] if x.ndim == 4 else x


def plot_molecule_frames(
    frames: np.ndarray,
    atomic_numbers: np.ndarray,
    bond_index: Optional[np.ndarray] = None,
    out_path: Optional[str] = None,
    max_frames: int = 12,
):
    """Grid of 3-D molecule renders (the reference's
    mdqm9/plots/frames/*.png figure assets consumed by 00031_main.ipynb's
    plot_image cells — rendered in-repo with matplotlib instead of an
    external tool).

    frames: (n_frames, n_atoms, 3); bond_index: (2, n_edges) directed
    bond table (each bond may appear twice; drawn once).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    frames = np.asarray(frames)[:max_frames]
    z = np.asarray(atomic_numbers)
    n = len(frames)
    ncols = min(4, n)
    nrows = -(-n // ncols)
    fig = plt.figure(figsize=(3.0 * ncols, 3.0 * nrows))
    bonds = []
    if bond_index is not None:
        bonds = sorted({tuple(sorted((int(s), int(d)))) for s, d in zip(*np.asarray(bond_index))})
    for k, x in enumerate(frames):
        ax = fig.add_subplot(nrows, ncols, k + 1, projection="3d")
        x = x - x.mean(axis=0)
        for s, d in bonds:
            ax.plot(*np.stack([x[s], x[d]]).T, color="#909090", lw=1.5, zorder=1)
        ax.scatter(
            x[:, 0], x[:, 1], x[:, 2],
            c=[_ELEM_COLOR.get(int(zi), "#b070d0") for zi in z],
            s=[_ELEM_SIZE.get(int(zi), 180) for zi in z],
            edgecolors="k", linewidths=0.4, depthshade=True, zorder=2,
        )
        r = float(np.abs(x).max()) * 1.1 + 1e-6
        ax.set_xlim(-r, r), ax.set_ylim(-r, r), ax.set_zlim(-r, r)
        ax.set_axis_off()
        ax.set_title(f"frame {k}", fontsize=9)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
    return fig


def plot_marginals_overlay(
    series: dict,
    reference: Optional[np.ndarray] = None,
    names: Optional[Sequence[str]] = None,
    kind: str = "torsion",
    out_path: Optional[str] = None,
):
    """Multi-source reweighted marginals on shared panels — the central
    00031_main.ipynb figure (per torsion: MD target vs md_ti / bg_ti /
    bg_ref ensembles, each reweighted with its own saved weight array).

    series: {label: (values (n, d), weights (n,) or None)};
    reference: MD target ensemble (n_ref, d), drawn dashed black.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_coords = next(iter(series.values()))[0].shape[1]
    ncols = min(4, n_coords)
    nrows = -(-n_coords // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3.2 * ncols, 2.6 * nrows), squeeze=False)
    rng = (-np.pi, np.pi) if kind == "torsion" else None
    for i in range(n_coords):
        ax = axes[i // ncols][i % ncols]
        for label, (vals, w) in series.items():
            c, h = reweighted_hist(np.asarray(vals)[:, i], weights=w, bins=60, range=rng)
            ax.plot(c, h, label=label, lw=1.2)
        if reference is not None:
            c, h = reweighted_hist(np.asarray(reference)[:, i], bins=60, range=rng)
            ax.plot(c, h, label="MD", lw=1.2, ls="--", color="k")
        ax.set_title(names[i] if names else f"{kind} {i}", fontsize=9)
    for j in range(n_coords, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    axes[0][0].legend(fontsize=8)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
    return fig


def plot_eigenvalues_vs_T(
    curves: dict,
    out_path: Optional[str] = None,
    drop_stationary: bool = True,
):
    """Generator eigenvalues (relaxation rates) vs temperature with 95%
    bootstrap bands per sample source — the kinetics panel of the
    reference's 10506_main.ipynb (it loads
    ``{src}_eigenvalues_{mean,lower_bound,upper_bound}.npy`` per source
    and overlays md / md_ti / bg / bg_ti).

    curves: {label: (temps, mean, lower, upper)} with temps (n_T,) per
    source (sources may cover different temperature subsets) and each
    eigenvalue array shaped (n_T, nev) — the stacked output of
    ``ti_torch.analysis.kinetics.torsion_generator_spectrum`` over temps.
    The stationary eigenvalue (~0, last index in the descending-negated
    layout) is dropped from the panels unless ``drop_stationary=False``.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nev = next(iter(curves.values()))[1].shape[1]
    # descending-negated layout (gedmd filter_ev convention): column nev-1
    # is the stationary lambda_1 ~ 0, column nev-2 the slowest relaxation
    # lambda_2, ... — panels run lambda_2, lambda_3, ... left to right.
    idx = list(range(nev - 2 if drop_stationary else nev - 1, -1, -1))
    fig, axes = plt.subplots(
        1, len(idx), figsize=(3.4 * len(idx), 3.0), squeeze=False, sharex=True
    )
    for k, i in enumerate(idx):
        ax = axes[0][k]
        for label, (temps, mean, lo, hi) in curves.items():
            temps = np.asarray(temps)
            (line,) = ax.plot(temps, np.asarray(mean)[:, i], marker="o", ms=3,
                              lw=1.2, label=label)
            ax.fill_between(temps, np.asarray(lo)[:, i], np.asarray(hi)[:, i],
                            alpha=0.2, color=line.get_color())
        ax.set_xlabel("T (K)")
        ax.set_title(f"$\\lambda_{{{nev - i}}}$", fontsize=10)
    axes[0][0].set_ylabel("eigenvalue (1/time)")
    axes[0][0].legend(fontsize=8)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
    return fig


def tica(
    X: np.ndarray, lag: int, dim: int = 2, eps: float = 1e-6
) -> Tuple[np.ndarray, np.ndarray]:
    """Time-lagged independent component analysis (the projection the
    reference notebooks compute with deeptime).

    X: (n_frames, d) features (e.g. cos/sin of torsions). Returns
    (eigenvalues (dim,), projection (n_frames, dim)). Symmetrized
    covariances, generalized eigensolve C_tau v = lambda C_0 v.
    """
    X = np.asarray(X, dtype=np.float64)
    X = X - X.mean(axis=0)
    a, b = X[:-lag], X[lag:]
    c0 = 0.5 * (a.T @ a + b.T @ b) / len(a)
    ctau = 0.5 * (a.T @ b + b.T @ a) / len(a)
    # whiten C0
    lam, U = np.linalg.eigh(c0)
    keep = lam > eps * lam.max()
    L = U[:, keep] * lam[keep] ** -0.5
    m = L.T @ ctau @ L
    ev, W = np.linalg.eigh(m)
    order = np.argsort(ev)[::-1][:dim]
    comps = L @ W[:, order]
    return ev[order], X @ comps


def torsion_features(torsions: np.ndarray) -> np.ndarray:
    """cos/sin featurization of periodic torsions for TICA."""
    t = np.asarray(torsions)
    return np.concatenate([np.cos(t), np.sin(t)], axis=1)


def plot_tica(
    md_torsions: np.ndarray,
    generated_torsions: np.ndarray,
    lag: int = 10,
    out_path: Optional[str] = None,
):
    """TICA plane fitted on MD torsions, generated ensemble scattered on it
    (the 10506 TICA figure)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # fit the TICA plane on MD features, project both ensembles with it
    X = torsion_features(md_torsions)
    mean = X.mean(0)
    Xc = X - mean
    a, b = Xc[:-lag], Xc[lag:]
    c0 = 0.5 * (a.T @ a + b.T @ b) / len(a)
    ctau = 0.5 * (a.T @ b + b.T @ a) / len(a)
    lam, U = np.linalg.eigh(c0)
    keep = lam > 1e-6 * lam.max()
    L = U[:, keep] * lam[keep] ** -0.5
    ev, W = np.linalg.eigh(L.T @ ctau @ L)
    comps = (L @ W)[:, np.argsort(ev)[::-1][:2]]
    md_proj = Xc @ comps
    gen_proj = (torsion_features(generated_torsions) - mean) @ comps

    fig, axes = plt.subplots(1, 2, figsize=(8, 3.4), sharex=True, sharey=True)
    axes[0].hist2d(md_proj[:, 0], md_proj[:, 1], bins=80, cmap="Blues")
    axes[0].set_title("MD")
    axes[1].hist2d(gen_proj[:, 0], gen_proj[:, 1], bins=80, cmap="Oranges")
    axes[1].set_title("generated")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
    return fig
