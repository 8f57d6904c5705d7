"""Results pipelines: ESS, free energies, internal-coordinate marginals.

Counterpart of the reference orchestration scripts
(mdqm9/analysis/results_00031.py, results_10506.py): given the sampling
artifacts (samples/dlogps/latent_* .npy) and the energy-stage artifacts
(E0s/E1s .npy), compute every number the paper reports — Kish ESS with
bootstrap CIs for the MD/TI, BG/TI and BG routes, TFEP / BG / BG-TFEP
free-energy differences with bootstrap CIs, and z-matrix marginals
(torsions, bond angles, bond lengths).

The per-metric 1000-iteration python bootstrap loops of the reference
(results_00031.py:30-150) are replaced by the shared vectorized
``bootstrap_ci``; the z-matrix construction is one vectorized torch call,
on the card unless the caller passes ``device="cpu"``.

The port of ti_tpu/analysis/results.py: the statistics are the same host
numpy over the port's copies of free_energy.py and weights.py; the
z-matrices come from the port's torch zmatrix.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

import torch

from ti_torch import resolve_device
from ti_torch.analysis.free_energy import (
    bootstrap_ci,
    calc_bg_dF,
    calc_phis_bg,
    calc_phis_bg_tfep,
    calc_phis_tfep,
    calc_tfep_dF,
)
from ti_torch.analysis.sort_atoms import compute_atom_order_and_references_groups
from ti_torch.analysis.weights import calc_ess, calc_importance_weights, calc_ti_weights, filter_iqr
from ti_torch.analysis.zmatrix import construct_z_matrix


def gen_z_matrix(adjacency: np.ndarray, samples: np.ndarray, device=None) -> np.ndarray:
    """(n, N-1, 3) z-matrices from (n, N, 3) cartesians using the
    BFS placement order (reference results_00031.py:16-19), as a numpy
    array.

    Computed in float32, as ti_tpu computes them: its ``jnp.asarray`` of
    the float64 samples gives float32 with x64 off, so its z-matrices are
    float32 too. Runs on ``cuda`` unless ``device`` says otherwise."""
    dev = resolve_device(device)
    atom_order, _, ref_atoms = compute_atom_order_and_references_groups(adjacency)
    sorted_samples = np.asarray(samples)[:, np.asarray(atom_order), :]
    x = torch.as_tensor(np.asarray(sorted_samples, dtype=np.float32), device=dev)
    return construct_z_matrix(x, ref_atoms).cpu().numpy()


def gen_torsions(z_matrices: np.ndarray) -> np.ndarray:
    """Torsion marginals: column 2, rows 2.. (defined for atoms 3..)."""
    return np.asarray(z_matrices)[:, 2:, 2]


def gen_bond_angles(z_matrices: np.ndarray) -> np.ndarray:
    return np.asarray(z_matrices)[:, 1:, 1]


def gen_bond_lengths(z_matrices: np.ndarray) -> np.ndarray:
    return np.asarray(z_matrices)[:, :, 0]


# ---------------------------------------------------------------------------
# free energies with bootstrap CIs (reference results_00031.py:30-100)
# ---------------------------------------------------------------------------

def gen_free_energy_tfep_md_ti(E0s, E1s, neg_dlogps_ti, n_bootstrap=1000, k=None, seed=0):
    def est(e0, e1, nd):
        phis, _ = calc_phis_tfep(e0, e1, nd, k=k)
        return calc_tfep_dF(phis)

    return bootstrap_ci(est, (np.asarray(E0s), np.asarray(E1s), np.asarray(neg_dlogps_ti)),
                        n_bootstrap=n_bootstrap, seed=seed)


def gen_free_energy_bg(Es_T0, neg_dlogps_bg_T0, Es_T1, neg_dlogps_bg_T1,
                       n_bootstrap=1000, k=None, seed=0):
    """BG route: dF = mean(phi1) - mean(phi0), independent resampling of the
    two ends (reference results_00031.py:50-76)."""
    e0, nd0 = np.asarray(Es_T0), np.asarray(neg_dlogps_bg_T0)
    e1, nd1 = np.asarray(Es_T1), np.asarray(neg_dlogps_bg_T1)

    def est0(e, nd):
        return calc_bg_dF(calc_phis_bg(e, nd, k=k))

    rng = np.random.default_rng(seed)
    point = est0(e1, nd1) - est0(e0, nd0)
    boots = np.empty(n_bootstrap)
    for i in range(n_bootstrap):
        i0 = rng.integers(0, len(e0), len(e0))
        i1 = rng.integers(0, len(e1), len(e1))
        boots[i] = est0(e1[i1], nd1[i1]) - est0(e0[i0], nd0[i0])
    return point, (float(np.percentile(boots, 2.5)), float(np.percentile(boots, 97.5)))


def gen_free_energy_bg_tfep(Es_T0, neg_dlogps_bg_T0, Es_T1, neg_dlogps_bg_T1,
                            n_bootstrap=1000, k=None, seed=0):
    def est(e0, nd0, e1, nd1):
        phis = calc_phis_bg_tfep(e0, nd0, e1, nd1, k=k)
        return calc_tfep_dF(phis)

    return bootstrap_ci(
        est,
        (np.asarray(Es_T0), np.asarray(neg_dlogps_bg_T0), np.asarray(Es_T1), np.asarray(neg_dlogps_bg_T1)),
        n_bootstrap=n_bootstrap, seed=seed,
    )


# ---------------------------------------------------------------------------
# ESS with bootstrap CIs (reference results_00031.py:103-150)
# ---------------------------------------------------------------------------

def gen_ess_ti(E0s, E1s, neg_dlogps_ti, k=None, n_bootstrap=1000, seed=0):
    w = calc_ti_weights(E0s, E1s, neg_dlogps_ti)
    if k is not None:
        w = w[filter_iqr(w, k=k)]
    return bootstrap_ci(lambda ww: calc_ess(ww), (w,), n_bootstrap=n_bootstrap, seed=seed)


def gen_ess_bg(z0s, E1s, neg_dlogps_bg, neg_dlogps_ti, k=None, n_bootstrap=1000, seed=0):
    w = calc_importance_weights(z0s, E1s, neg_dlogps_bg, neg_dlogps_ti)
    if k is not None:
        w = w[filter_iqr(w, k=k)]
    return bootstrap_ci(lambda ww: calc_ess(ww), (w,), n_bootstrap=n_bootstrap, seed=seed)


# ---------------------------------------------------------------------------
# end-to-end report (the shape of results_00031.py:152-343)
# ---------------------------------------------------------------------------

def generate_report(
    adjacency: np.ndarray,
    samples: np.ndarray,
    neg_dlogps_ti: Optional[np.ndarray] = None,
    E0s: Optional[np.ndarray] = None,
    E1s: Optional[np.ndarray] = None,
    latent_z: Optional[np.ndarray] = None,
    neg_dlogps_bg: Optional[np.ndarray] = None,
    k: Optional[float] = 100.0,
    n_bootstrap: int = 1000,
    seed: int = 0,
    save_path: Optional[str] = None,
    tag: str = "results",
    device=None,
) -> Dict:
    """Compute every metric the artifacts allow; optionally np.save each
    array like the reference scripts (~40 arrays, results_00031.py:173-343).

    samples: (n, N, 3) FINAL conformations. neg_dlogps_*: pass the sampler's
    saved dlogp arrays UNCHANGED — "neg_dlogps" is the reference's name for
    exactly that quantity (loaded without a sign flip,
    results_00031.py:180-190). The z-matrices are formed on ``device``
    (``cuda`` unless it says otherwise), the statistics on the host.
    """
    out: Dict = {}
    z = gen_z_matrix(adjacency, samples, device)
    out["z_matrices"] = z
    out["torsions"] = gen_torsions(z)
    out["bond_angles"] = gen_bond_angles(z)
    out["bond_lengths"] = gen_bond_lengths(z)

    have_ti = E0s is not None and E1s is not None and neg_dlogps_ti is not None
    if have_ti:
        out["dF_tfep_md_ti"] = gen_free_energy_tfep_md_ti(
            E0s, E1s, neg_dlogps_ti, n_bootstrap=n_bootstrap, k=k, seed=seed
        )
        out["ess_md_ti"] = gen_ess_ti(E0s, E1s, neg_dlogps_ti, k=k, n_bootstrap=n_bootstrap, seed=seed)

    if latent_z is not None and neg_dlogps_bg is not None and E1s is not None:
        nd_ti = np.zeros(len(E1s)) if neg_dlogps_ti is None else neg_dlogps_ti
        out["ess_bg_ti"] = gen_ess_bg(
            latent_z, E1s, neg_dlogps_bg, nd_ti, k=k, n_bootstrap=n_bootstrap, seed=seed
        )

    if save_path is not None:
        import os

        os.makedirs(save_path, exist_ok=True)
        for name in ("torsions", "bond_angles", "bond_lengths"):
            np.save(os.path.join(save_path, f"{name}_{tag}.npy"), out[name])
        for name in ("dF_tfep_md_ti", "ess_md_ti", "ess_bg_ti"):
            if name in out:
                val, (lo, hi) = out[name]
                np.save(os.path.join(save_path, f"{name}_{tag}.npy"), np.array([val, lo, hi]))
    return out


# ---------------------------------------------------------------------------
# full multi-source report (results_00031.py:152-343, results_10506.py:15-122)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MDTISource:
    """Ambient MD→TI transport artifacts: initial/final conformations plus
    the energy-stage outputs (reference results_00031.py:173-179)."""

    x0s: np.ndarray  # (n, N, 3) initial conformations (physical units)
    x1s: np.ndarray  # (n, N, 3) final conformations
    E0s: Optional[np.ndarray] = None  # reduced energies at T0
    E1s: Optional[np.ndarray] = None  # reduced energies at T1
    neg_dlogps_ti: Optional[np.ndarray] = None  # sampler dlogps, unmodified


@dataclasses.dataclass
class BGTISource:
    """Composed BG→TI route: latent noises + both dlogp legs
    (reference results_00031.py:181-189)."""

    x0s: np.ndarray
    x1s: np.ndarray
    zs: np.ndarray  # latent noises that produced x0 (latent_noises_*.npy)
    neg_dlogps_bg: np.ndarray  # latent leg (latent_dlogps_*.npy)
    neg_dlogps_ti: np.ndarray  # ambient leg (dlogps_*.npy)
    E0s: Optional[np.ndarray] = None
    E1s: Optional[np.ndarray] = None


@dataclasses.dataclass
class BGRefSource:
    """Pure latent (Boltzmann-generator) reference at one temperature
    (reference results_00031.py:191-201)."""

    zs: np.ndarray  # noise draws ([:, 0] of the latent samples array)
    xs: np.ndarray  # generated conformations ([:, -1], physical units)
    neg_dlogps_bg: np.ndarray
    Es: Optional[np.ndarray] = None  # reduced energies at this temperature


def _marginals(out: Dict, adjacency, samples, suffix: str, save_z: bool = False,
               device=None):
    """Compute torsion/angle/length marginals for one cartesian array and
    store them under the reference's ``<kind>_<suffix>`` names."""
    z = gen_z_matrix(adjacency, samples, device)
    if save_z:
        out[f"z_matrix_{suffix}"] = z
    out[f"torsions_{suffix}"] = gen_torsions(z)
    out[f"bond_angles_{suffix}"] = gen_bond_angles(z)
    out[f"bond_lengths_{suffix}"] = gen_bond_lengths(z)


def _filter_target_marginals(out: Dict, weights: np.ndarray, suffix: str, k):
    """IQR-filter importance weights and the matching target-side marginals
    in lockstep (reference results_00031.py:267-279)."""
    keep = filter_iqr(weights, k=k)
    for kind in ("torsions", "bond_angles", "bond_lengths"):
        out[f"{kind}_{suffix}"] = out[f"{kind}_{suffix}"][keep]
    return weights[keep]


def generate_full_report(
    adjacency: np.ndarray,
    md_ti: Optional[MDTISource] = None,
    bg_ti: Optional[BGTISource] = None,
    bg_ref_T0: Optional[BGRefSource] = None,
    bg_ref_T1: Optional[BGRefSource] = None,
    md_T0: Optional[np.ndarray] = None,
    md_T1: Optional[np.ndarray] = None,
    h5_md: Optional[np.ndarray] = None,
    k: Optional[float] = 100.0,
    n_bootstrap: int = 1000,
    seed: int = 0,
    save_path: Optional[str] = None,
    save_z_matrices: bool = False,
    device=None,
) -> Dict:
    """The reference's complete multi-source report: marginals for up to 8
    sample sources, 3 ESS routes, 4 dF routes, and 5 saved weight arrays —
    artifact-name-level parity with results_00031.py:260-343 (plus the
    z-matrix / torsions_h5_md extras of results_10506.py:51-121).

    Every input is optional; each metric is computed whenever its inputs
    are present. Cartesian inputs must be in PHYSICAL units (the caller
    divides by the scaling factor, as the reference does at load time,
    results_00031.py:173-195). dlogp arrays are the samplers' saved
    arrays, unmodified ("neg_dlogps" convention, results_00031.py:180-190).

    Naming quirks reproduced deliberately so downstream notebooks port
    unchanged: the MD-reference arrays are saved as ``torsions_md_T0/T1``,
    ``bond_angles_md_T0/T1`` but ``bond_lengths_md_0/1``
    (results_00031.py:297-316). NOT reproduced: results_10506.py's
    copy-paste bug that saves the md_ti arrays under the bg_ti_* names
    (:101-102,108-109,115-116) — we save the actual bg_ti arrays.

    The z-matrices are formed on ``device`` (``cuda`` unless it says
    otherwise), the statistics on the host.
    """
    out: Dict = {}
    dev = resolve_device(device)

    # --- marginals per source (results_00031.py:207-245) ---
    if md_ti is not None:
        _marginals(out, adjacency, md_ti.x0s, "md_ti_0", save_z_matrices, device=dev)
        _marginals(out, adjacency, md_ti.x1s, "md_ti_1", save_z_matrices, device=dev)
    if bg_ti is not None:
        _marginals(out, adjacency, bg_ti.x0s, "bg_ti_0", save_z_matrices, device=dev)
        _marginals(out, adjacency, bg_ti.x1s, "bg_ti_1", save_z_matrices, device=dev)
    if bg_ref_T0 is not None:
        _marginals(out, adjacency, bg_ref_T0.xs, "bg_ref_T0", device=dev)
    if bg_ref_T1 is not None:
        _marginals(out, adjacency, bg_ref_T1.xs, "bg_ref_T1", device=dev)
    if md_T0 is not None:
        _marginals(out, adjacency, md_T0, "md_T0", save_z_matrices, device=dev)
    if md_T1 is not None:
        _marginals(out, adjacency, md_T1, "md_T1", save_z_matrices, device=dev)
    if h5_md is not None:
        # 10506 report: torsions only (results_10506.py:51-52,90)
        out["torsions_h5_md"] = gen_torsions(gen_z_matrix(adjacency, h5_md, dev))

    # --- ESS routes (results_00031.py:247-258) ---
    def _ess_pct(val_ci, n):
        (val, (lo, hi)) = val_ci
        return val / n * 100.0, (lo / n * 100.0, hi / n * 100.0)

    have_md_ti_energies = (
        md_ti is not None and md_ti.E0s is not None and md_ti.E1s is not None
        and md_ti.neg_dlogps_ti is not None
    )
    if have_md_ti_energies:
        n = len(md_ti.neg_dlogps_ti)
        ess, ci = _ess_pct(
            gen_ess_ti(md_ti.E0s, md_ti.E1s, md_ti.neg_dlogps_ti, k=k,
                       n_bootstrap=n_bootstrap, seed=seed), n)
        out["ess_md_ti_percentage"], out["ess_md_ti_ci_percentage"] = ess, ci
    if bg_ti is not None and bg_ti.E1s is not None:
        n = len(bg_ti.neg_dlogps_bg)
        ess, ci = _ess_pct(
            gen_ess_bg(bg_ti.zs, bg_ti.E1s, bg_ti.neg_dlogps_bg, bg_ti.neg_dlogps_ti,
                       k=k, n_bootstrap=n_bootstrap, seed=seed), n)
        out["ess_bg_ti_percentage"], out["ess_bg_ti_ci_percentage"] = ess, ci
    if bg_ref_T0 is not None and bg_ref_T0.Es is not None:
        n = len(bg_ref_T0.neg_dlogps_bg)
        ess, ci = _ess_pct(
            gen_ess_bg(bg_ref_T0.zs, bg_ref_T0.Es, bg_ref_T0.neg_dlogps_bg,
                       np.zeros(n), k=k, n_bootstrap=n_bootstrap, seed=seed), n)
        out["ess_bg_T0_percentage"], out["ess_bg_T0_ci_percentage"] = ess, ci

    # --- free-energy routes (results_00031.py:260-264) ---
    if have_md_ti_energies:
        out["df_md_ti"], out["dF_md_ti_ci"] = gen_free_energy_tfep_md_ti(
            md_ti.E0s, md_ti.E1s, md_ti.neg_dlogps_ti,
            n_bootstrap=n_bootstrap, k=k, seed=seed)
    if bg_ti is not None and bg_ti.E0s is not None and bg_ti.E1s is not None:
        # the BG→TI TFEP route treats the composed map as a two-ended BG:
        # T1 leg carries BOTH dlogp legs (results_00031.py:262)
        out["dF_bg_ti_tfep"], out["dF_bg_ti_tfep_ci"] = gen_free_energy_bg_tfep(
            bg_ti.E0s, bg_ti.neg_dlogps_bg,
            bg_ti.E1s, bg_ti.neg_dlogps_bg + bg_ti.neg_dlogps_ti,
            n_bootstrap=n_bootstrap, k=k, seed=seed)
    if (bg_ref_T0 is not None and bg_ref_T0.Es is not None
            and bg_ref_T1 is not None and bg_ref_T1.Es is not None):
        out["dF_bg_ref"], out["dF_bg_ref_ci"] = gen_free_energy_bg(
            bg_ref_T0.Es, bg_ref_T0.neg_dlogps_bg,
            bg_ref_T1.Es, bg_ref_T1.neg_dlogps_bg,
            n_bootstrap=n_bootstrap, k=k, seed=seed)
        out["dF_bg_ref_tfep"], out["dF_bg_ref_tfep_ci"] = gen_free_energy_bg_tfep(
            bg_ref_T0.Es, bg_ref_T0.neg_dlogps_bg,
            bg_ref_T1.Es, bg_ref_T1.neg_dlogps_bg,
            n_bootstrap=n_bootstrap, k=k, seed=seed)

    # --- importance weights + filtered target marginals (:266-283) ---
    if have_md_ti_energies:
        w = calc_ti_weights(md_ti.E0s, md_ti.E1s, md_ti.neg_dlogps_ti)
        out["weights_md_ti"] = _filter_target_marginals(out, w, "md_ti_1", k)
    if bg_ti is not None and bg_ti.E1s is not None:
        w1 = calc_importance_weights(bg_ti.zs, bg_ti.E1s, bg_ti.neg_dlogps_bg,
                                     bg_ti.neg_dlogps_ti)
        out["weights_bg_ti_T1"] = _filter_target_marginals(out, w1, "bg_ti_1", k)
        if bg_ti.E0s is not None:
            out["weights_bg_ti_T0"] = calc_importance_weights(
                bg_ti.zs, bg_ti.E0s, bg_ti.neg_dlogps_bg,
                np.zeros_like(bg_ti.neg_dlogps_ti))
    if bg_ref_T0 is not None and bg_ref_T0.Es is not None:
        out["weights_bg_ref_T0"] = calc_importance_weights(
            bg_ref_T0.zs, bg_ref_T0.Es, bg_ref_T0.neg_dlogps_bg,
            np.zeros_like(bg_ref_T0.neg_dlogps_bg))
    if bg_ref_T1 is not None and bg_ref_T1.Es is not None:
        out["weights_bg_ref_T1"] = calc_importance_weights(
            bg_ref_T1.zs, bg_ref_T1.Es, bg_ref_T1.neg_dlogps_bg,
            np.zeros_like(bg_ref_T1.neg_dlogps_bg))

    if save_path is not None:
        save_full_report(out, save_path)
    return out


# the reference's on-disk names, keyed by report dict key; identical except
# the four marginal quirks (results_00031.py:291-340)
_FULL_REPORT_FILENAMES = {
    "torsions_md_T0": "torsions_md_T0",
    "torsions_md_T1": "torsions_md_T1",
    "bond_angles_md_T0": "bond_angles_md_T0",
    "bond_angles_md_T1": "bond_angles_md_T1",
    "bond_lengths_md_T0": "bond_lengths_md_0",
    "bond_lengths_md_T1": "bond_lengths_md_1",
}


def save_full_report(out: Dict, save_path: str) -> list[str]:
    """np.save every array in the report under the reference's exact
    filenames (results_00031.py:290-341); returns the names written."""
    import os

    os.makedirs(save_path, exist_ok=True)
    written = []
    for key, val in out.items():
        if key.endswith("_ci") or key.endswith("_ci_percentage"):
            val = np.asarray(list(val))
        name = _FULL_REPORT_FILENAMES.get(key, key)
        np.save(os.path.join(save_path, f"{name}.npy"), np.asarray(val))
        written.append(name)
    return written
