"""ADW f64-vs-f32 trained-field parity study (port of
scripts/adw_f64_study.py).

The reference trains ADW in float64 (adw/train.py:29). This study
quantifies what the dtype choice costs on the physics: train the same
config and seed in both dtypes on the card (the port's ``ADWConfig.dtype
= "f64"`` trains in float64 there; the JAX package runs f64 on the CPU
only), transport the same exact-Boltzmann test split with stage-coupled
exact dlogp on RK4, and report per dtype

- the quadrature-oracle TFEP dF error (|dF_est - dF_quadrature|),
- the marginal KS distance vs the beta1 Boltzmann density,
- the TFEP ESS, the final validation loss and the seconds of each stage,

plus the cross-dtype endpoint deltas (x1, dlogp) from transporting the
same x0 through both trained fields.

Usage: python -m ti_torch.cli.adw_f64_study [--epochs 120] [--n 4000] [--steps 128]
    [--out DIR] [--device cpu]
Runs on the card unless ``--device`` names another device; ``--out``
(default ``adw_f64_study`` under the temporary directory) takes the CSV and
both runs' checkpoints. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

BETA0, BETA1 = 1.0, 1.25


def train(args, dtype: str, device) -> dict:
    """``train_adw`` of the study's config in ``dtype`` ("f32" | "f64") on
    the CSV under ``args.out``; returns its model, params, history and
    seconds (``train_s``)."""
    from ti_torch.config import ADWConfig
    from ti_torch.train import adw
    from ti_torch.utils.timing import synchronize

    cfg = ADWConfig(
        n_samples=args.n_train, hidden_size=args.hidden,
        num_layers=args.layers, epochs=args.epochs, lr=1e-3, wd=0.0,
        batch_size=1024, a=0.9, dtype=dtype, traj_path=args.out,
        model_save_path=os.path.join(args.out, f"models_{dtype}"),
        data_save_path=os.path.join(args.out, f"out_{dtype}"),
    )
    t0 = time.perf_counter()
    res = adw.train_adw(cfg, device=device)
    synchronize(device)
    return dict(res, train_s=time.perf_counter() - t0)


def evaluate(fields: dict, x0, steps: int, device=None) -> dict:
    """The study's JSON object for trained ``fields`` ({"f32": ..., "f64":
    ...}, each ``train``'s dict: model, params, history, train_s) from the
    float64 starts x0 (n,), each dtype's transport on RK4-``steps`` with
    the exact divergence in every stage."""
    import torch

    from ti_torch import resolve_device
    from ti_torch.analysis.potentials import (
        AsymmetricDoubleWell,
        BoltzmannDensity1D,
        delta_f_quadrature,
    )
    from ti_torch.analysis.weights import calc_ess
    from ti_torch.models.mlp import param_dtype
    from ti_torch.sampling.drivers import adw_v_fn_of
    from ti_torch.sampling.integrators import sample_ode

    dev = resolve_device(device)
    pot = AsymmetricDoubleWell()
    n = len(x0)
    dF_exact = delta_f_quadrature(BETA0, BETA1, pot)
    xs_grid = np.linspace(-4, 4, 4000)
    cdf_target = np.cumsum(BoltzmannDensity1D(BETA1, pot).pdf(xs_grid))
    cdf_target /= cdf_target[-1]
    ks_grid = np.linspace(-2.0, 2.0, 201)
    cdf_t = np.interp(ks_grid, xs_grid, cdf_target)

    results, endpoints = {}, {}
    for dtype in ("f32", "f64"):
        res = fields[dtype]
        dt = param_dtype(dtype)
        params = {k: t.to(dev) for k, t in res["params"].items()}
        x = torch.as_tensor(np.asarray(x0), dtype=dt, device=dev)[:, None]
        conds = torch.tensor([[BETA0, BETA1]], dtype=dt, device=dev).expand(n, 2)
        t0 = time.perf_counter()
        with torch.no_grad():
            sol = sample_ode(adw_v_fn_of(res["model"], params)(conds), x, n_steps=steps,
                             method="rk4", return_dlogp=True, divergence="exact")
        x1 = sol.xs[:, -1, 0].double().cpu().numpy()
        dlogp = sol.dlogp[:, -1].double().cpu().numpy()
        t_sample = time.perf_counter() - t0
        endpoints[dtype] = (x1, dlogp)

        e0 = np.asarray(pot(x0))
        e1 = np.asarray(pot(x1))
        log_w = BETA0 * e0 - BETA1 * e1 - dlogp
        mx = log_w.max()
        dF_est = -(mx + np.log(np.mean(np.exp(log_w - mx))))
        cdf_emp = np.searchsorted(np.sort(x1), ks_grid) / len(x1)
        results[dtype] = {
            "dF_est": float(dF_est),
            "dF_err": float(abs(dF_est - dF_exact)),
            "ks": float(np.max(np.abs(cdf_emp - cdf_t))),
            "ess_frac": float(calc_ess(np.exp(log_w - mx))) / n,
            "final_val_loss": res["history"]["val_loss"][-1],
            "train_s": round(res["train_s"], 1),
            "sample_s": round(t_sample, 1),
        }
        print(f"[{dtype}] {json.dumps(results[dtype])}", file=sys.stderr, flush=True)

    x1_32, dl_32 = endpoints["f32"]
    x1_64, dl_64 = endpoints["f64"]
    cross = {
        "x1_rms_delta": float(np.sqrt(np.mean((x1_32 - x1_64) ** 2))),
        "dlogp_rms_delta": float(np.sqrt(np.mean((dl_32 - dl_64) ** 2))),
        "dlogp_mean_delta": float(np.mean(dl_32 - dl_64)),
    }
    return {"dF_exact": float(dF_exact), "f32": results["f32"], "f64": results["f64"],
            "cross": cross}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--n_train", type=int, default=40_000)
    ap.add_argument("--n", type=int, default=4000, help="test chains")
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "adw_f64_study"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ti_torch import resolve_device
    from ti_torch.analysis.potentials import AsymmetricDoubleWell, BoltzmannDensity1D
    from ti_torch.data.adw import make_synthetic_adw_csv

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    make_synthetic_adw_csv(os.path.join(args.out, "samples.csv"), betas=[BETA0, BETA1],
                           n_samples=args.n_train)
    # shared exact test draw at beta0 (f64; cast per dtype in evaluate)
    x0 = BoltzmannDensity1D(BETA0, AsymmetricDoubleWell()).sample(123, args.n)
    fields = {dtype: train(args, dtype, dev) for dtype in ("f32", "f64")}
    print(json.dumps(evaluate(fields, x0, args.steps, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
