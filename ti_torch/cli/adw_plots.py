"""ADW kinetics figure: λ₂ vs β with bootstrap CIs, TI-reweighted vs the
direct Boltzmann-reweighting baseline (port of scripts/adw_plots.py; the
reference's ADW results figure). It reads the npz that
``ti_torch.cli.adw_reweight_gedmd`` writes and runs on the host (numpy and
matplotlib); without matplotlib it exits 2 and says so.

Usage:
  python -m ti_torch.cli.adw_plots --reweighted gedmd.npz [--direct gedmd_direct.npz]
      [--ev_index 2] [--out adw_lambda2.png]

--schematic instead draws the method schematic of the reference's
toc.ipynb / 00031_main.ipynb plot_double_well cells: the ADW potential
V(x) = a(x²−1)² + bx with the quadrature Boltzmann densities at the listed
betas (the β0→β1 transport picture):

  python -m ti_torch.cli.adw_plots --schematic --betas 1.0 1.25 [--out adw_toc.png]
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reweighted", default=None, help="adw_reweight_gedmd npz")
    ap.add_argument("--direct", default=None, help="--direct baseline npz")
    ap.add_argument("--ev_index", type=int, default=2,
                    help="eigenvalue index (2 = lambda_2 in the nev=4 layout)")
    ap.add_argument("--schematic", action="store_true",
                    help="draw the double-well + Boltzmann-densities schematic")
    ap.add_argument("--betas", type=float, nargs="+", default=[1.0, 1.25])
    ap.add_argument("--a", type=float, default=0.9, help="ADW a (schematic)")
    ap.add_argument("--b", type=float, default=0.1, help="ADW b (schematic)")
    ap.add_argument("--out", default="adw_lambda2.png")
    args = ap.parse_args(argv)
    if not args.reweighted and not args.schematic:
        ap.error("need --reweighted and/or --schematic")

    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not available in this environment: the figures need it. "
              "The spectra (ti_torch.cli.adw_reweight_gedmd) do not; render them where "
              "matplotlib is installed.", file=sys.stderr)
        return 2
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if args.schematic:
        from ti_torch.analysis.potentials import AsymmetricDoubleWell, BoltzmannDensity1D

        pot = AsymmetricDoubleWell(a=args.a, b=args.b)
        xs = np.linspace(-2.2, 2.2, 600)
        fig, ax = plt.subplots(figsize=(4.6, 3.2))
        ax.plot(xs, np.asarray(pot(xs)), color="k", lw=1.6, label=r"$V(x)$")
        ax2 = ax.twinx()
        for i, beta in enumerate(args.betas):
            dens = BoltzmannDensity1D(beta=beta, potential=pot)
            ax2.fill_between(xs, np.asarray(dens.pdf(xs)), alpha=0.35,
                             color=f"C{i}", label=rf"$p_{{\beta={beta:g}}}$")
        ax.set_xlabel("x"), ax.set_ylabel("V(x)")
        ax2.set_ylabel("Boltzmann density"), ax2.set_ylim(bottom=0.0)
        h1, l1 = ax.get_legend_handles_labels()
        h2, l2 = ax2.get_legend_handles_labels()
        ax.legend(h1 + h2, l1 + l2, fontsize=8)
        fig.tight_layout()
        if not args.reweighted:
            out = args.out if args.out != "adw_lambda2.png" else "adw_schematic.png"
        else:  # both figures requested: never let lambda2 overwrite this one
            root, ext = os.path.splitext(args.out)
            out = f"{root}_schematic{ext or '.png'}"
        fig.savefig(out, dpi=150)
        print(f"wrote {out}")
        plt.close(fig)
        if not args.reweighted:
            return 0

    fig, ax = plt.subplots(figsize=(4.2, 3.2))

    def draw(path, label, color, offset):
        d = np.load(path)
        betas = d["betas"] + offset
        i = args.ev_index
        mean = d["eigenvalues_mean"][:, i]
        lo, hi = d["lower"][:, i], d["upper"][:, i]
        ax.errorbar(
            betas, mean, yerr=[mean - lo, hi - mean], fmt="o-", ms=4,
            capsize=3, lw=1.2, label=label, color=color,
        )

    draw(args.reweighted, "TI reweighted", "C0", 0.0)
    if args.direct:
        draw(args.direct, "direct Boltzmann", "C1", 0.01)
    ax.set_xlabel(r"target $\beta$")
    ax.set_ylabel(rf"$-\lambda_{args.ev_index}$ (decay rate)")
    ax.set_yscale("log")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(args.out, dpi=150)
    plt.close(fig)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
