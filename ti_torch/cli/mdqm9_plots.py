"""Render the paper figures from results arrays (port of
scripts/mdqm9_plots.py; reference: mdqm9/plots/*.ipynb — marginal
histograms with reweighting and the TICA projection). It runs on the host
(numpy and matplotlib); without matplotlib it exits 2 and says so. The
notebooks become a CLI over the artifact pipeline:

  python -m ti_torch.cli.mdqm9_results ... --out results --tag run     # arrays
  python -m ti_torch.cli.mdqm9_plots --results_dir results --tag run \
      [--ref_tag md]            # MD-reference arrays under the same dir
      [--data_dir out --energy_dir energies]   # -> reweighting weights
      [--lag 10] [--out figures]

Full-report mode (the 10506 figure path, reference results_10506.py +
10506_marginals.ipynb): point --tag/--ref_tag at the reference-named
sources the full report saved and take the saved weights directly:

  python -m ti_torch.cli.mdqm9_plots --results_dir results --tag md_ti_1 \
      --ref_tag md_T1 --weights weights_md_ti --lag 10 --out figures

--ref_tag falls back to the report's bond_lengths_md_0/1 naming quirk,
and an h5-backed MD reference (--ref_tag h5_md) plots the torsion
marginals + TICA only, like the reference 10506 report.

Writes torsions/bond_angles/bond_lengths marginal grids (PNG) and, when a
reference ensemble is given, the MD-vs-generated TICA plane. With
--eigs_dir (artifacts from ti_torch.cli.mdqm9_gedmd) it also renders the
eigenvalue-vs-T kinetics figure with 95% bootstrap bands across sources
(reference 10506_main.ipynb); --eigs_dir alone skips the marginals.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np

from ti_torch.analysis.plots import plot_marginals, plot_tica
from ti_torch.analysis.weights import calc_ti_weights, weights_filter_iqr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--results_dir", default=None,
                    help="dir with torsions_/bond_angles_/bond_lengths_<tag>.npy")
    ap.add_argument("--tag", default=None, help="generated-ensemble tag")
    ap.add_argument("--ref_tag", default=None,
                    help="reference (MD) ensemble tag in the same results_dir")
    ap.add_argument("--data_dir", default=None,
                    help="sampling artifacts dir (dlogps_<tag>.npy) for weights")
    ap.add_argument("--energy_dir", default=None,
                    help="energy artifacts dir (E0s_/E1s_<tag>.npy) for weights")
    ap.add_argument("--weights", default=None,
                    help="name of a saved weights array in results_dir "
                    "(full-report mode, e.g. weights_md_ti)")
    ap.add_argument("--lag", type=int, default=10, help="TICA lag (frames)")
    ap.add_argument("--overlay", default=None,
                    help="comma-separated tag[:weights_array] pairs for the "
                    "multi-source reweighted-marginals overlay (the central "
                    "00031_main.ipynb figure), e.g. "
                    "'md_ti_1:weights_md_ti,bg_ti_1:weights_bg_ti_T1,"
                    "bg_ref_T1:weights_bg_ref_T1'; drawn against --ref_tag")
    ap.add_argument("--eigs_dir", default=None,
                    help="dir with <src>_eigenvalues_{mean,lower_bound,"
                    "upper_bound}.npy from ti_torch.cli.mdqm9_gedmd — renders "
                    "the eigenvalue-vs-T kinetics figure (10506_main.ipynb)")
    ap.add_argument("--eig_sources", default="md,md_ti,bg,bg_ti",
                    help="comma-separated source prefixes in --eigs_dir; "
                    "missing sources are skipped")
    ap.add_argument("--frames", default=None,
                    help="samples .npy ((n, atoms, 3) frame stack, or a "
                    "batch-major (n, n_save, atoms, 3) sampler artifact — "
                    "each sample's final conformation is rendered) as 3-D "
                    "molecule frames "
                    "(the reference's mdqm9/plots/frames/*.png assets)")
    ap.add_argument("--frames_sdf", default=None,
                    help="SDF file for element colors and bonds (--frames)")
    ap.add_argument("--frames_mol_index", type=int, default=0)
    ap.add_argument("--max_frames", type=int, default=12)
    ap.add_argument("--out", default="figures")
    args = ap.parse_args(argv)

    if (args.tag or args.overlay) and not args.results_dir:
        ap.error("--tag/--overlay require --results_dir")
    if not (args.tag or args.overlay or args.eigs_dir or args.frames):
        ap.error("need --results_dir with --tag/--overlay, --eigs_dir, "
                 "and/or --frames")

    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not available in this environment: the figures need it. "
              "The results arrays (ti_torch.cli.mdqm9_results) do not; render them where "
              "matplotlib is installed.", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)

    if args.frames:
        from ti_torch.analysis.plots import frames_from_artifact, plot_molecule_frames

        x = frames_from_artifact(np.load(args.frames))
        if args.frames_sdf:
            from ti_torch.data.sdf import parse_sdf_v2000

            mol = parse_sdf_v2000(args.frames_sdf, args.frames_mol_index)
            z, bonds = mol.atomic_numbers, mol.bond_index
        else:
            z, bonds = np.full(x.shape[1], 6), None  # all-carbon fallback
        base = os.path.splitext(os.path.basename(args.frames))[0]
        out_path = os.path.join(args.out, f"frames_{base}.png")
        plot_molecule_frames(x, z, bonds, out_path=out_path,
                             max_frames=args.max_frames)
        print(f"wrote {out_path}")
        if not (args.tag or args.overlay) and not args.eigs_dir:
            return 0

    if args.eigs_dir:
        from ti_torch.analysis.plots import plot_eigenvalues_vs_T

        curves = {}
        for src in args.eig_sources.split(","):
            src = src.strip()
            paths = [
                os.path.join(args.eigs_dir, f"{src}_{part}.npy")
                for part in ("temps", "eigenvalues_mean",
                             "eigenvalues_lower_bound",
                             "eigenvalues_upper_bound")
            ]
            if not all(os.path.exists(p) for p in paths):
                continue
            curves[src] = tuple(np.load(p) for p in paths)
        if not curves:
            raise SystemExit(
                f"no <src>_temps/eigenvalues_*.npy quadruplets for sources "
                f"{args.eig_sources!r} in {args.eigs_dir}"
            )
        out_path = os.path.join(args.out, "eigenvalues_vs_T.png")
        plot_eigenvalues_vs_T(curves, out_path=out_path)
        print(f"wrote {out_path} (sources: {', '.join(curves)})")
        if not (args.tag or args.overlay):
            return 0

    # the full report's MD-reference naming quirk (results_00031.py:315-316)
    _QUIRKS = {("bond_lengths", "md_T0"): "bond_lengths_md_0",
               ("bond_lengths", "md_T1"): "bond_lengths_md_1"}

    def arr(dirname, name, tag, required=True):
        p = os.path.join(dirname, f"{name}_{tag}.npy")
        if not os.path.exists(p) and (name, tag) in _QUIRKS:
            p = os.path.join(dirname, f"{_QUIRKS[name, tag]}.npy")
        if not os.path.exists(p):
            if required:
                raise FileNotFoundError(p)
            return None
        return np.load(p)

    if args.overlay:
        from ti_torch.analysis.plots import plot_marginals_overlay

        series = {}
        for spec in args.overlay.split(","):
            tag, _, wname = spec.strip().partition(":")
            vals = arr(args.results_dir, "torsions", tag)
            w = None
            if wname:
                w = np.load(os.path.join(args.results_dir, f"{wname}.npy"))
                if len(w) != len(vals):
                    raise SystemExit(
                        f"overlay weights/marginals length mismatch for "
                        f"{tag!r}: {len(w)} weights ({wname}) vs {len(vals)} "
                        f"samples"
                    )
            series[tag] = (vals, w)
        ref = arr(args.results_dir, "torsions", args.ref_tag) if args.ref_tag else None
        out_path = os.path.join(args.out, "torsions_overlay.png")
        plot_marginals_overlay(series, reference=ref, kind="torsion", out_path=out_path)
        print(f"wrote {out_path} (sources: {', '.join(series)})")
        if not args.tag:
            return 0

    weights = weights_path = None
    if args.weights:
        weights_path = os.path.join(args.results_dir, f"{args.weights}.npy")
        weights = np.load(weights_path)
        print(f"reweighting with the report's saved {args.weights} array")
    elif args.data_dir and args.energy_dir:
        weights_path = os.path.join(args.data_dir, f"dlogps_{args.tag}.npy")
        dlogps = arr(args.data_dir, "dlogps", args.tag)
        e0 = arr(args.energy_dir, "E0s", args.tag)
        e1 = arr(args.energy_dir, "E1s", args.tag)
        w = calc_ti_weights(e0, e1, dlogps)
        keep = weights_filter_iqr(w)  # boolean IQR mask over the weights
        weights = np.where(keep, w, 0.0)
        print(f"reweighting with {np.count_nonzero(keep)} / {len(w)} "
              "IQR-kept weights")

    written = []
    loaded = {}
    for kind in ("torsions", "bond_angles", "bond_lengths"):
        gen = loaded[kind, args.tag] = arr(args.results_dir, kind, args.tag)
        if weights is not None and len(weights) != len(gen):
            raise SystemExit(
                f"weights/marginals length mismatch: {len(weights)} weights "
                f"({weights_path}) vs {len(gen)} samples "
                f"({os.path.join(args.results_dir, f'{kind}_{args.tag}.npy')}) "
                "— artifacts are from different runs or filtering stages"
            )
        ref = loaded[kind, args.ref_tag] = (
            arr(args.results_dir, kind, args.ref_tag, required=False)
            if args.ref_tag else None
        )
        out_path = os.path.join(args.out, f"{kind}_{args.tag}.png")
        plot_marginals(
            gen, reference=ref, weights=weights,
            kind="torsion" if kind == "torsions" else kind,
            out_path=out_path,
        )
        written.append(out_path)

    md_t = loaded.get(("torsions", args.ref_tag)) if args.ref_tag else None
    if md_t is not None:
        out_path = os.path.join(args.out, f"tica_{args.tag}.png")
        plot_tica(md_t, loaded["torsions", args.tag], lag=args.lag, out_path=out_path)
        written.append(out_path)

    for p in written:
        print(f"wrote {p}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
