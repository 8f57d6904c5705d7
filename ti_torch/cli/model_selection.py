"""RFF hyperparameter selection by VAMP cross-validation, on the host (port
of scripts/model_selection.py: numpy, as ti_torch/gedmd/rff.py is; reference:
adw/analysis/model_selection.py and mdqm9/analysis/model_selection.py).

Scans (sigma, p) for the reversible generator on either:
- ADW samples (``--adw_dir <data_dir> --epoch E --beta B``: loads the
  ``beta_<beta0>_to_<B>`` samples artifact, a = 2/beta), or
- molecular torsions (``--torsions results/torsions_<tag>.npy --T 300``:
  (m, d) or (d, m) array, a = 1/beta(T) in kJ/mol units per the molecular
  reference convention — the ADW branch uses 2/beta like its reference).

Writes the EV/VAMP grids as npz and prints the VAMP-optimal (sigma, p).

Usage:
  python -m ti_torch.cli.model_selection --adw_dir model_outputs/adw/velocity \
      --epoch 272 --beta 1.25 [--beta0 1.0] [--out scan.npz]
  python -m ti_torch.cli.model_selection --torsions results/torsions_run.npy \
      --T 300 [--out scan.npz]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ti_torch.analysis.kinetics import (
    best_hyperparameters,
    beta_kj_per_mol,
    load_torsions,
    model_selection_scan,
    subsample_columns,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--adw_dir", help="ADW sampling artifacts dir")
    src.add_argument("--torsions", help="torsions .npy for the molecular scan")
    ap.add_argument("--epoch", type=int, default=272)
    ap.add_argument("--beta0", type=float, default=1.0)
    ap.add_argument("--beta", type=float, default=1.25, help="ADW target beta")
    ap.add_argument("--T", type=float, default=300.0, help="temperature (K), molecular")
    ap.add_argument("--sigmas", type=float, nargs="+", default=None)
    ap.add_argument("--ps", type=int, nargs="+", default=None)
    ap.add_argument("--ntest", type=int, default=20)
    ap.add_argument("--nev", type=int, default=4)
    ap.add_argument("--max_samples", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="model_selection.npz")
    args = ap.parse_args(argv)

    if args.adw_dir:
        d = os.path.join(args.adw_dir, f"beta_{args.beta0}_to_{args.beta}")
        samples = np.load(os.path.join(d, f"samples_epoch_{args.epoch}.npy"))
        X = samples[-1].reshape(1, -1)  # final-time marginal, d=1
        a = 2.0 / args.beta
        # reference adw grid (adw/analysis/model_selection.py:23-24)
        sigmas = args.sigmas or [1e-2, 5e-2, 1e-1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.8, 1.0, 2.0]
        ps = args.ps or [50, 100, 200, 300, 400, 500]
    else:
        X = load_torsions(args.torsions)  # (d, m)
        # molecular convention a = 1/beta (mdqm9/analysis/model_selection.py:46,
        # gedmd.py:12) — the ADW branch above uses 2/beta like its reference
        a = 1.0 / beta_kj_per_mol(args.T)
        # reference molecular grid (mdqm9/analysis/model_selection.py:17-21)
        sigmas = args.sigmas or [5.0, 7.0, 9.0, 10.0, 11.0, 12.0, 12.5, 13.0]
        ps = args.ps or [50, 100, 300, 500, 1000]

    X = subsample_columns(X, args.max_samples, seed=args.seed)

    scan = model_selection_scan(
        X, a, sigma_list=sigmas, p_list=ps, ntest=args.ntest, nev=args.nev,
        seed=args.seed,
    )
    sigma, p = best_hyperparameters(scan)
    np.savez(args.out, **scan)
    print(f"best by mean VAMP score: sigma={sigma}, p={p}")
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
