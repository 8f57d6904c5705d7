"""Step-count study: fixed-step RK4 vs adaptive dopri5@1e-5 (port of
scripts/step_count_study.py).

The reference integrates with torchdiffeq dopri5 at atol=rtol=1e-5
(mdqm9/config/ambient/00031_settings_no_300.json:34-36; adw/config). The
production path is fixed-step RK4 + quadrature dlogp. This study trains
the ADW field on the card (hidden 64 x 3, batch 1024), then measures, per
RK4 step count, the endpoint and dlogp error against dopri5 at the
reference tolerances with the exact divergence — "how many RK4 steps buy
reference-tolerance accuracy" — with NFE counts for the cost comparison.
From 16 steps up it also takes the production route's Gauss-Legendre-10
dlogp on the same trajectory.

Usage: python -m ti_torch.cli.step_count_study [--epochs 50] [--n_samples 40000]
    [--n_eval 1000] [--steps 8 16 32 64 128 256] [--device cpu]
Runs on the card unless ``--device`` names another device. Prints one JSON
line per step count and a summary line.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np

BETA0, BETA1 = 1.0, 1.25


def train(args, device):
    """The ADW field of the study: ``train_adw`` on a synthetic CSV of
    ``n_samples`` a beta; returns (model, params)."""
    from ti_torch.config import ADWConfig
    from ti_torch.data.adw import make_synthetic_adw_csv
    from ti_torch.train import adw

    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_adw_csv(f"{tmp}/samples.csv", betas=[BETA0, BETA1],
                               n_samples=args.n_samples)
        cfg = ADWConfig(
            n_samples=args.n_samples, hidden_size=64, num_layers=3, epochs=args.epochs,
            lr=1e-3, wd=0.0, batch_size=1024, a=0.9, traj_path=tmp,
            model_save_path=f"{tmp}/models", data_save_path=f"{tmp}/out",
        )
        result = adw.train_adw(cfg, device=device)
    return result["model"], result["params"]


def evaluate(field, x0, steps, device=None):
    """The study on a given field (model, params) from the starts x0 (n,),
    in the params' dtype (f32 as trained here; an f64 field runs in f64):
    dopri5 at atol = rtol = 1e-5, then RK4 at each step count, and GL-10
    from 16 steps up. Prints and returns (rows, summary, dopri5's NFE)."""
    import torch

    from ti_torch import resolve_device
    from ti_torch.sampling.drivers import adw_v_fn_of
    from ti_torch.sampling.integrators import (
        sample_ode,
        sample_ode_dopri5,
        sample_ode_gauss_dlogp,
    )

    dev = resolve_device(device)
    model, params = field
    params = {k: t.to(dev) for k, t in params.items()}
    dt = next(iter(params.values())).dtype
    x = torch.as_tensor(np.asarray(x0), dtype=dt, device=dev)[:, None]
    conds = torch.tensor([[BETA0, BETA1]], dtype=dt, device=dev).expand(len(x), 2)
    v = adw_v_fn_of(model, params)(conds)

    def host(a):
        return a.detach().cpu().numpy()

    with torch.no_grad():
        # reference-tolerance adaptive solve (the reference's solver settings)
        ref = sample_ode_dopri5(v, x, atol=1e-5, rtol=1e-5, divergence="exact")
        x_ref = host(ref.xs[:, -1, 0])
        lp_ref = host(ref.dlogp[:, -1])
        nfe_ref = int(torch.as_tensor(ref.nfe).max())
        print(f"[ref] dopri5@1e-5: nfe={nfe_ref}", file=sys.stderr)

        rows = []
        for n_steps in steps:
            sol = sample_ode(v, x, n_steps=n_steps, method="rk4", return_dlogp=True,
                             divergence="exact")
            xe = np.abs(host(sol.xs[:, -1, 0]) - x_ref)
            le = np.abs(host(sol.dlogp[:, -1]) - lp_ref)
            row = {
                "rk4_steps": n_steps,
                "nfe": int(sol.nfe),
                "x_err_p99": float(np.percentile(xe, 99)),
                "dlogp_err_p99": float(np.percentile(le, 99)),
                "dlogp_err_max": float(le.max()),
            }
            # production path: same trajectory, Gauss-10 decoupled dlogp
            if n_steps >= 16:
                g = sample_ode_gauss_dlogp(v, x, n_steps=n_steps, gl_points=10, method="rk4")
                row["gauss10_dlogp_err_p99"] = float(
                    np.percentile(np.abs(host(g.dlogp[:, -1]) - lp_ref), 99))
                row["gauss10_nfe"] = int(g.nfe)
            rows.append(row)
            print(json.dumps(row))

    # smallest step count whose p99 dlogp error is within 2x of the best
    best = min(r["dlogp_err_p99"] for r in rows)
    pick = next(r for r in rows if r["dlogp_err_p99"] <= 2 * best)
    summary = {
        "summary": "min RK4 steps at reference-tolerance dlogp accuracy",
        "rk4_steps": pick["rk4_steps"],
        "speedup_vs_dopri5_nfe": nfe_ref / pick.get("gauss10_nfe", pick["nfe"]),
    }
    print(json.dumps(summary))
    return rows, summary, nfe_ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--n_samples", type=int, default=40_000)
    ap.add_argument("--n_eval", type=int, default=1000)
    ap.add_argument("--steps", type=int, nargs="*", default=[8, 16, 32, 64, 128, 256])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ti_torch import resolve_device
    from ti_torch.analysis.potentials import AsymmetricDoubleWell, BoltzmannDensity1D

    dev = resolve_device(args.device)
    field = train(args, dev)
    x0 = BoltzmannDensity1D(BETA0, AsymmetricDoubleWell()).sample(123, args.n_eval)
    evaluate(field, x0, args.steps, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
