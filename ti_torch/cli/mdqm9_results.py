"""MDQM9 results report (port of scripts/mdqm9_results.py; reference:
mdqm9/analysis/results_00031.py, results_10506.py), its z-matrices on the
card unless ``--device`` says otherwise, its statistics on the host.

Consumes the sampling artifacts (samples/dlogps/latent_*) and the
energy-stage artifacts (E0s/E1s/Es) and writes the full multi-source
report: marginals for every sample source, the three ESS routes, the four
dF routes, and the five importance-weight arrays — artifact-name parity
with results_00031.py:290-341.

Sources (all optional — each metric is computed when its inputs exist):
  --md_ti_dir   ambient MD→TI artifacts (samples/dlogps/E0s/E1s _{tag}.npy)
  --bg_ti_dir   composed BG→TI artifacts (+ latent_noises/latent_dlogps)
  --latent_dir  BG reference runs; files samples/dlogps/Es_{latent_tag}.npy
                with --latent_tag_T0/--latent_tag_T1 (default "<T>K" like
                the reference, results_00031.py:191-201)
  --traj_path   replica-exchange .npy trajectories for the MD-reference
                marginals at --T0/--T1 (train split, unscaled)
  --h5 --h5_idx mdqm9-nc.hdf5 MD trajectory (10506 report's torsions_h5_md)

Usage (full report):
  python -m ti_torch.cli.mdqm9_results --sdf data/mols/mdqm9.sdf --mol_index 31 \
      --md_ti_dir samples/ambient_md --bg_ti_dir samples/ambient_lti \
      --latent_dir samples/latent --tag 00031_no_300_1000to300K \
      --T0 1000 --T1 300 --traj_path data/trajs --out results/

Legacy single-source mode (round-1 CLI, kept working):
  python -m ti_torch.cli.mdqm9_results --sdf ... --mol_index 31 \
      --data_dir generated_data/ambient --tag ... [--energy_dir ...]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ti_torch import resolve_device
from ti_torch.analysis.plots import frames_from_artifact
from ti_torch.analysis.results import (
    BGRefSource,
    BGTISource,
    MDTISource,
    generate_full_report,
    generate_report,
)
from ti_torch.data.mdqm9 import load_trajs, scaling_factor_for
from ti_torch.data.sdf import parse_sdf_v2000


def _load(path):
    return np.load(path) if path and os.path.exists(path) else None


def _load_req(path):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return np.load(path)


def _energies(src_dir, energy_dir, name):
    """E*-array lookup: next to the samples first (reference layout,
    results_00031.py:176-185), then the separate --energy_dir."""
    for d in (src_dir, energy_dir):
        if d:
            arr = _load(os.path.join(d, name))
            if arr is not None:
                return arr
    return None


def _check_lengths(n, tag, **arrays):
    for name, arr in arrays.items():
        if arr is not None and len(arr) != n:
            raise ValueError(
                f"{tag}: {name} has {len(arr)} rows but the samples have {n} — "
                "artifacts are from different runs"
            )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sdf", required=True)
    ap.add_argument("--mol_index", type=int, required=True)
    # legacy single-source mode
    ap.add_argument("--data_dir", default=None)
    # full multi-source mode
    ap.add_argument("--md_ti_dir", default=None)
    ap.add_argument("--bg_ti_dir", default=None)
    ap.add_argument("--latent_dir", default=None)
    ap.add_argument("--latent_tag_T0", default=None, help="default '<T0>K'")
    ap.add_argument("--latent_tag_T1", default=None, help="default '<T1>K'")
    ap.add_argument("--n_latent_max", type=int, default=25_000,
                    help="cap on BG-reference rows (results_00031.py:191-201)")
    ap.add_argument("--T0", type=int, default=None)
    ap.add_argument("--T1", type=int, default=None)
    ap.add_argument("--traj_path", default=None,
                    help="replica-exchange trajs root (train/ split) for MD marginals")
    ap.add_argument("--traj_filename", default=None, help="default '<mol_index:05d>.npy'")
    ap.add_argument("--h5", default=None, help="mdqm9-nc.hdf5 for torsions_h5_md")
    ap.add_argument("--h5_idx", type=int, default=None)
    ap.add_argument("--scaling_factor", default="auto",
                    help="'auto' (per-molecule published factor), or a float; "
                    "saved samples are divided by it (results_00031.py:173-195)")
    ap.add_argument("--save_z_matrices", action="store_true",
                    help="also save z_matrix_* arrays (results_10506.py:92-97)")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--energy_dir", default=None)
    ap.add_argument("--k", type=float, default=100.0)
    ap.add_argument("--n_bootstrap", type=int, default=1000)
    ap.add_argument("--out", default="results")
    ap.add_argument("--device", default=None, help="where the z-matrices are formed "
                    "(default: the card)")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)  # no card and no --device: raise here

    mol = parse_sdf_v2000(args.sdf, args.mol_index)
    adjacency = mol.adjacency() | mol.adjacency().T

    traj_filename = args.traj_filename or f"{args.mol_index:05d}.npy"
    sf = (
        scaling_factor_for(traj_filename)
        if args.scaling_factor == "auto"
        else float(args.scaling_factor)
    )

    if args.h5 is not None and args.h5_idx is None:
        ap.error("--h5 requires --h5_idx (molecule key inside the hdf5)")

    full_mode = any([args.md_ti_dir, args.bg_ti_dir, args.latent_dir,
                     args.traj_path, args.h5])
    if not full_mode:
        _legacy(args, adjacency)
        return 0

    md_ti = bg_ti = bg_ref_T0 = bg_ref_T1 = None
    md_T0 = md_T1 = h5_md = None

    if args.md_ti_dir:
        s = _load_req(os.path.join(args.md_ti_dir, f"samples_{args.tag}.npy"))
        nd = _load_req(os.path.join(args.md_ti_dir, f"dlogps_{args.tag}.npy"))
        E0s = _energies(args.md_ti_dir, args.energy_dir, f"E0s_{args.tag}.npy")
        E1s = _energies(args.md_ti_dir, args.energy_dir, f"E1s_{args.tag}.npy")
        _check_lengths(len(s), "md_ti", dlogps=nd, E0s=E0s, E1s=E1s)
        md_ti = MDTISource(
            x0s=s[:, 0] / sf, x1s=s[:, -1] / sf,
            E0s=E0s, E1s=E1s, neg_dlogps_ti=nd,
        )

    if args.bg_ti_dir:
        s = _load_req(os.path.join(args.bg_ti_dir, f"samples_{args.tag}.npy"))
        nd = _load_req(os.path.join(args.bg_ti_dir, f"dlogps_{args.tag}.npy"))
        zs = _load_req(os.path.join(args.bg_ti_dir, f"latent_noises_{args.tag}.npy"))
        ndbg = _load_req(os.path.join(args.bg_ti_dir, f"latent_dlogps_{args.tag}.npy"))
        E0s = _energies(args.bg_ti_dir, args.energy_dir, f"E0s_{args.tag}.npy")
        E1s = _energies(args.bg_ti_dir, args.energy_dir, f"E1s_{args.tag}.npy")
        _check_lengths(len(s), "bg_ti", dlogps=nd, latent_noises=zs,
                       latent_dlogps=ndbg, E0s=E0s, E1s=E1s)
        bg_ti = BGTISource(
            x0s=s[:, 0] / sf, x1s=s[:, -1] / sf, zs=zs,
            neg_dlogps_bg=ndbg, neg_dlogps_ti=nd, E0s=E0s, E1s=E1s,
        )

    if args.latent_dir:
        if args.T0 is None or args.T1 is None:
            raise SystemExit("--latent_dir needs --T0 and --T1")

        def bg_ref(T, ltag):
            ltag = ltag or f"{T}K"
            s = _load(os.path.join(args.latent_dir, f"samples_{ltag}.npy"))
            if s is None:
                return None
            m = args.n_latent_max
            nd = _load_req(os.path.join(args.latent_dir, f"dlogps_{ltag}.npy"))[:m]
            Es = _energies(args.latent_dir, args.energy_dir, f"Es_{ltag}.npy")
            Es = Es[:m] if Es is not None else None
            s = s[:m]
            _check_lengths(len(s), f"bg_ref_{ltag}", dlogps=nd, Es=Es)
            # latent zs are raw noise (NOT divided by the scaling factor);
            # the generated x IS divided (results_00031.py:191-195)
            return BGRefSource(zs=s[:, 0], xs=s[:, -1] / sf,
                               neg_dlogps_bg=nd, Es=Es)

        bg_ref_T0 = bg_ref(args.T0, args.latent_tag_T0)
        bg_ref_T1 = bg_ref(args.T1, args.latent_tag_T1)

    if args.traj_path:
        if args.T0 is None or args.T1 is None:
            raise SystemExit("--traj_path needs --T0 and --T1")
        md_T0 = load_trajs(args.traj_path, "train", traj_filename, args.T0, scale=False)
        md_T1 = load_trajs(args.traj_path, "train", traj_filename, args.T1, scale=False)

    if args.h5:
        try:
            import h5py
        except ImportError:
            raise SystemExit(
                "--h5 needs h5py (the reference reads mdqm9-nc.hdf5 in its "
                "separate analysis env, results_10506.py:48-49)"
            )
        with h5py.File(args.h5, "r") as f:
            h5_md = f[str(args.h5_idx)]["trajectories"]["md_0"][:]

    report = generate_full_report(
        adjacency,
        md_ti=md_ti, bg_ti=bg_ti,
        bg_ref_T0=bg_ref_T0, bg_ref_T1=bg_ref_T1,
        md_T0=md_T0, md_T1=md_T1, h5_md=h5_md,
        k=args.k, n_bootstrap=args.n_bootstrap,
        save_path=args.out, save_z_matrices=args.save_z_matrices, device=args.device,
    )

    # stats printout (results_00031.py:286-288)
    def fmt(key):
        ci = report.get(f"{key}_ci_percentage") or report.get(f"{key}_ci")
        if key == "df_md_ti":  # reference's one case-mismatched CI name
            ci = report.get("dF_md_ti_ci")
        val = report.get(f"{key}_percentage", report.get(key))
        return f"{val:.4f} -+ [{ci[0]:.4f}, {ci[1]:.4f}]" if val is not None else "n/a"

    print(f"ESS (BG at T0): {fmt('ess_bg_T0')}, ESS (BG/TI): {fmt('ess_bg_ti')}, "
          f"ESS (MD/TI): {fmt('ess_md_ti')}")
    print(f"dF (BG/TI): {fmt('dF_bg_ti_tfep')}, dF (MD/TI): {fmt('df_md_ti')}")
    print(f"dF (BG Ref.): {fmt('dF_bg_ref')}, dF (BG Ref. TFEP): {fmt('dF_bg_ref_tfep')}")
    print(f"saved {len(report)} arrays under {args.out}/")
    return 0


def _legacy(args, adjacency):
    """Round-1 single-source mode: one samples/dlogps dir, tag-suffixed
    artifact names."""
    samples = np.load(os.path.join(args.data_dir, f"samples_{args.tag}.npy"))
    final = frames_from_artifact(samples)
    dlogps = np.load(os.path.join(args.data_dir, f"dlogps_{args.tag}.npy"))

    latent_z = _load(os.path.join(args.data_dir, f"latent_noises_{args.tag}.npy"))
    latent_dlogps = _load(os.path.join(args.data_dir, f"latent_dlogps_{args.tag}.npy"))

    E0s = E1s = None
    if args.energy_dir:
        E0s = np.load(os.path.join(args.energy_dir, f"E0s_{args.tag}.npy"))
        E1s = np.load(os.path.join(args.energy_dir, f"E1s_{args.tag}.npy"))

    report = generate_report(
        adjacency, final,
        # the saved dlogps array IS the analysis layer's neg_dlogps — the
        # reference loads it unmodified (results_00031.py:180-190)
        neg_dlogps_ti=dlogps,
        E0s=E0s, E1s=E1s,
        latent_z=latent_z,
        neg_dlogps_bg=latent_dlogps,
        k=args.k, n_bootstrap=args.n_bootstrap,
        save_path=args.out, tag=args.tag, device=args.device,
    )
    for name in ("dF_tfep_md_ti", "ess_md_ti", "ess_bg_ti"):
        if name in report:
            val, (lo, hi) = report[name]
            print(f"{name}: {val:.4f} [{lo:.4f}, {hi:.4f}]")
    print(f"saved arrays under {args.out}/")


if __name__ == "__main__":
    sys.exit(main())
