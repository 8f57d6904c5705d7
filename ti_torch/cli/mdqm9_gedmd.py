"""Torsion-space gEDMD kinetics across temperatures, on the host (port of
scripts/mdqm9_gedmd.py: numpy, as ti_torch/gedmd/rff.py is; reference:
mdqm9/analysis/gedmd.py — generator spectra with 1000x bootstrap CIs on
the 6 torsion coordinates, one shared RFF frequency draw across the
temperature sweep, a = 1/beta(T) in kJ/mol units).

Produces the per-source artifact triplet the reference's kinetics figure
loads (mdqm9/plots/10506_main.ipynb:
``{src}_eigenvalues_{mean,lower_bound,upper_bound}.npy``) plus
``{src}_temps.npy`` for the axis:

  python -m ti_torch.cli.mdqm9_gedmd \
      --pattern "results/torsions_{T}k.npy" --temps 300,400,500 \
      --src md_ti --out_dir results/kinetics \
      [--weights_pattern "results/weights_{T}k.npy"]  # resample first

``--pattern`` takes a ``{T}`` placeholder (the reference's
``torsions_{T}k.npy`` layout, gedmd.py:50-52); arrays may be (m, d) or
(d, m). ``--weights_pattern`` optionally multinomial-resamples each
ensemble with saved importance weights before the bootstrap (the ADW
pipeline's resample_with_weights step, adw/analysis/reweight_gedmd.py:61-67
— the reference molecular script assumes pre-reweighted torsions).

Render the cross-source figure with:
  python -m ti_torch.cli.mdqm9_plots --results_dir <ignored> --tag <ignored> \
      --eigs_dir results/kinetics --eig_sources md,md_ti,bg,bg_ti --out figures
(or pass --eigs_dir alongside a normal marginals invocation).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ti_torch.analysis.kinetics import (
    load_torsions,
    subsample_columns,
    torsion_generator_spectrum,
)
from ti_torch.analysis.weights import resample_with_weights
from ti_torch.gedmd.rff import sample_rff_gaussian


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pattern", required=True,
                    help="torsions path with a {T} placeholder")
    ap.add_argument("--temps", required=True,
                    help="comma-separated temperatures (K), e.g. 300,400,500")
    ap.add_argument("--src", default="md_ti",
                    help="artifact prefix (md / md_ti / bg / bg_ti)")
    ap.add_argument("--weights_pattern", default=None,
                    help="optional weights path with a {T} placeholder; "
                    "ensembles are multinomial-resampled before the bootstrap")
    # reference hyperparameters (mdqm9/analysis/gedmd.py:37-41)
    ap.add_argument("--p", type=int, default=300)
    ap.add_argument("--sigma", type=float, default=5.0)
    ap.add_argument("--nev", type=int, default=4)
    ap.add_argument("--cut_svd", type=float, default=1e-4)
    ap.add_argument("--n_bootstrap", type=int, default=1000)
    ap.add_argument("--max_samples", type=int, default=50_000,
                    help="subsample cap per temperature (bootstrap cost)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out_dir", default="results/kinetics")
    args = ap.parse_args(argv)

    temps = [float(t) for t in args.temps.split(",")]
    os.makedirs(args.out_dir, exist_ok=True)

    Omega = None  # one frequency draw shared across the sweep (gedmd.py:41)
    means, lowers, uppers = [], [], []
    for i, T in enumerate(temps):
        # per-T seed stream: identical draws at every temperature would
        # correlate the bootstrap bands across the whole sweep
        seed_T = args.seed + i
        path = args.pattern.format(T=f"{T:g}")
        X = load_torsions(path, seed=seed_T)
        if args.weights_pattern:
            w = np.load(args.weights_pattern.format(T=f"{T:g}"))
            if len(w) != X.shape[1]:
                raise SystemExit(
                    f"weights/torsions length mismatch at T={T:g}: "
                    f"{len(w)} weights vs {X.shape[1]} samples ({path})"
                )
            X = resample_with_weights(X.T, w, seed=seed_T).T
        X = subsample_columns(X, args.max_samples, seed=seed_T)
        if Omega is None:
            Omega = sample_rff_gaussian(args.seed, X.shape[0], args.p, args.sigma)
        out = torsion_generator_spectrum(
            X, T, nev=args.nev, cut_svd=args.cut_svd,
            n_bootstrap=args.n_bootstrap, seed=seed_T, Omega=Omega,
        )
        means.append(out["eigenvalues_mean"])
        lowers.append(out["lower_bound"])
        uppers.append(out["upper_bound"])
        print(f"T={T:g}K: lambda_2 = {out['eigenvalues_mean'][args.nev - 2]:.5f} "
              f"[{out['lower_bound'][args.nev - 2]:.5f}, "
              f"{out['upper_bound'][args.nev - 2]:.5f}] (m={X.shape[1]})")

    for name, arr in (
        ("eigenvalues_mean", means),
        ("eigenvalues_lower_bound", lowers),
        ("eigenvalues_upper_bound", uppers),
        ("temps", temps),
    ):
        p = os.path.join(args.out_dir, f"{args.src}_{name}.npy")
        np.save(p, np.asarray(arr))
        print(f"saved {p}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
