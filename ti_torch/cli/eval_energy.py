"""Energy-evaluation stage (port of scripts/eval_energy.py; reference:
mdqm9/analysis/eval_energy.py).

Runs on the host in the DEDICATED OpenMM environment (the reference's
ti_energy_env.yml — this stage is decoupled from the card's): loads the
sampling artifacts, computes reduced GAFF-2 energies of the initial
conformations at T0 and the transported conformations at T1, and writes the
E0s_/E1s_<tag>.npy artifacts the results pipeline consumes.

Usage:
  python -m ti_torch.cli.eval_energy --sdf data/mols/mdqm9.sdf --mol_index 31 \
      --hdf5 data/mols/mdqm9_eval.hdf5 --data_dir generated_data/ambient \
      --tag 00031_no_300_1000to300K --T0 1000 --T1 300 [--out energies]

Partial charges come from the eval hdf5 (--hdf5, reference
eval_dataset.py) or a plain .npy via --charges.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ti_torch.analysis.energy import (
    eval_energy_openmm,
    openmm_available,
    save_energy_artifacts,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sdf", required=True)
    ap.add_argument("--mol_index", type=int, required=True)
    ap.add_argument("--hdf5", default=None, help="eval hdf5 with partial_charges")
    ap.add_argument("--charges", default=None, help=".npy partial charges (alternative)")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--T0", type=float, required=True)
    ap.add_argument("--T1", type=float, required=True)
    ap.add_argument("--out", default="energies")
    args = ap.parse_args(argv)

    if not openmm_available():
        print(
            "OpenMM is not available in this environment. This stage runs in "
            "the dedicated energy environment (reference ti_energy_env.yml); "
            "activate it and re-run. The sampling pipeline is unaffected — pass "
            "the E0s_/E1s_ artifacts to ti_torch.cli.mdqm9_results when ready.",
            file=sys.stderr,
        )
        return 2

    if args.charges:
        charges = np.load(args.charges)
    elif args.hdf5:
        from ti_torch.data.eval_dataset import MDQM9EvalDataset

        charges = MDQM9EvalDataset(args.hdf5, args.sdf)[args.mol_index].partial_charges
    else:
        raise SystemExit("provide --hdf5 or --charges for partial charges")

    samples = np.load(os.path.join(args.data_dir, f"samples_{args.tag}.npy"))
    final = samples[:, -1] if samples.ndim == 4 else samples
    init_path = os.path.join(args.data_dir, f"initial_samples_{args.tag}.npy")
    if samples.ndim == 4:  # (n, n_save, N, 3): the saved trajectory start
        initial = samples[:, 0]
    elif os.path.exists(init_path):
        initial = np.load(init_path)
    else:
        raise SystemExit(
            f"no initial conformations found for tag {args.tag!r} "
            "(need a 4-D samples array or initial_samples_<tag>.npy)"
        )

    E0s = eval_energy_openmm(args.sdf, args.mol_index, charges, initial, args.T0)
    E1s = eval_energy_openmm(args.sdf, args.mol_index, charges, final, args.T1)
    save_energy_artifacts(args.out, args.tag, E0s, E1s)
    print(f"wrote E0s_{args.tag}.npy / E1s_{args.tag}.npy under {args.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
