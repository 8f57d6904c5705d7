"""ADW reweighted-gEDMD kinetics, on the host (port of
scripts/adw_reweight_gedmd.py: numpy, as ti_torch/gedmd/rff.py is;
reference: adw/analysis/reweight_gedmd.py).

Loads samples/initial_samples/dlogps artifacts for each target beta,
reweights, and bootstraps the generator spectrum.

Usage:
  python -m ti_torch.cli.adw_reweight_gedmd --data_dir model_outputs/adw/velocity \
      --epoch 272 --beta0 1.0 --betas 1.25 1.5 1.75 2.0 [--out results.npz]

``--direct`` switches to the direct Boltzmann-reweighting baseline
(reference adw/analysis/dir_reweight_gedmd.py): MD samples at beta0 are
reweighted analytically to each target beta — no transport/dlogp artifacts
needed, only the initial samples.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ti_torch.analysis.reweight import (
    direct_reweighted_gedmd_spectrum,
    reweighted_gedmd_spectrum,
)
from ti_torch.gedmd.rff import sample_rff_gaussian


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--epoch", type=int, default=272)
    ap.add_argument("--beta0", type=float, default=1.0)
    ap.add_argument("--betas", type=float, nargs="+", default=[1.25, 1.5, 1.75, 2.0])
    ap.add_argument("--p", type=int, default=50)
    ap.add_argument("--sigma", type=float, default=0.6)
    ap.add_argument("--nev", type=int, default=4)
    ap.add_argument("--cut_svd", type=float, default=1e-4)
    ap.add_argument("--n_bootstrap", type=int, default=1000)
    ap.add_argument("--out", default="adw_reweight_gedmd.npz")
    ap.add_argument("--direct", action="store_true",
                    help="direct Boltzmann-reweighting baseline (no dlogp)")
    args = ap.parse_args(argv)

    Omega = sample_rff_gaussian(0, 1, args.p, args.sigma)
    means, los, his = [], [], []
    for beta in args.betas:
        d = os.path.join(args.data_dir, f"beta_{args.beta0}_to_{beta}")
        initial = np.load(os.path.join(d, f"initial_samples_epoch_{args.epoch}.npy"))
        if args.direct:
            out = direct_reweighted_gedmd_spectrum(
                initial, args.beta0, beta, Omega=Omega, nev=args.nev,
                cut_svd=args.cut_svd, n_bootstrap=args.n_bootstrap,
            )
        else:
            target = np.load(os.path.join(d, f"samples_epoch_{args.epoch}.npy"))
            dlogps = np.load(os.path.join(d, f"dlogps_epoch_{args.epoch}.npy"))
            out = reweighted_gedmd_spectrum(
                initial, target, dlogps, beta, Omega=Omega, nev=args.nev,
                cut_svd=args.cut_svd, n_bootstrap=args.n_bootstrap,
            )
        print(
            f"beta {beta}: lambda_2 = {out['eigenvalues_mean'][2]:.4f} "
            f"[{out['lower_bound'][2]:.4f}, {out['upper_bound'][2]:.4f}]"
            + (f" ({out['n_filtered']} filtered)" if "n_filtered" in out else "")
        )
        means.append(out["eigenvalues_mean"])
        los.append(out["lower_bound"])
        his.append(out["upper_bound"])
    np.savez(
        args.out, betas=np.asarray(args.betas), eigenvalues_mean=np.asarray(means),
        lower=np.asarray(los), upper=np.asarray(his),
    )
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
