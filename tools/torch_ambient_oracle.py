"""The harmonic TFEP oracle on a field the port trains, on one CUDA card.

The port's counterpart of scripts/validate_mdqm9_physics.py at 00031
capacity. Synthetic frames are exact Boltzmann samples of an isotropic
harmonic well (sigma_T = jitter * sqrt(T/300), COM-centred), so the free
energy difference is closed-form: dF(T0 -> T1) = -3(N-1) ln(sigma_T1 /
sigma_T0). The script

1. trains the ambient field with ``train_ambient`` on the card (19 atoms,
   F = 128, 5 layers, 2048 frames per temperature, T0s = T1s = [1000, 300],
   batch 64, 100 epochs, lr 2e-3, brownian a = 0.1, dense bf16_agg), and
   reports the trainer's seconds, ms a step and molecules/s;
2. transports 1024 fresh T0 frames 1000 -> 300 K through the exact slice
   (``fast_profile`` with ``divergence="exact", div_forward_impl=
   "pair_tangent"``: B1 f32, B3 f32 with the full K = 57 frame) and through
   the main path (``fast_profile``: B1 f32, B3 bf16_agg, orthogonal-16),
   and reports each route's |dF_est - dF_exact|, ESS and final width; the
   main path's dlogp minus the exact slice's, and the same with B3 bf16_agg
   on the full frame (the bf16_agg offset without probe noise);
3. runs the reference's own sampler (``sample_ambient(ambient_preset(
   "00031"))``: dopri5 at atol = rtol = 1e-5, exact divergence in every
   stage) on one batch of 12 chains, with its 100 save points and with the
   endpoint only, and reports the NFE per chain against bench.py's
   REF_NFE = 500.

With ``--atoms 29 --features 256`` it is the oracle of the large molecule's
profile (``ambient_preset("10506")``, the 10506 rows of BASELINE.md): the
same recipe trains a 29-atom F = 256 field, and step 2 transports through
the field's exact floor (``fast_profile`` with ``divergence="exact",
compute_dtype="f32", traj_forward_impl="default"``: the dense f32 forward
and the exact divergence, no kernel), through the kernel route
(``fast_profile`` as it stands: B1 in bf16_agg at F = 256 on the
trajectory, Hutchinson-32 at the nodes) and through the same route with
the plain dense bf16_agg forward on the trajectory (the same probes: the
kernel is all that differs), in batches of 16; step 3 is left out (no
kernel, and bench.py prices the 00031 shape). The gate is the exact
route's |dF err| < 0.6 there (``ti_tpu``'s fields read 0.386-0.404,
BASELINE.md) and ESS > 2%. On the H100 the training takes about 31
minutes and step 2 about 16.

    python3 tools/torch_ambient_oracle.py [--epochs 100] [--out chiprun_out/ambient_oracle]
    python3 tools/torch_ambient_oracle.py --atoms 29 --features 256 --out build/oracle_10506

``--reuse`` evaluates the weights a previous run saved in ``--out``
instead of training. The last line of standard output is one JSON object
with every number; it is also written to ``--out``/oracle.json.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_NFE = 500  # bench.py's price of the reference sampler, evaluations a chain


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


class EpochClock:
    """A ``MetricLogger`` stand-in that prints each epoch's metrics and
    keeps the wall clock at every epoch's end."""

    def __init__(self):
        self.stamps = [time.perf_counter()]
        self.rows = []

    def log(self, metrics, step=None):
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        self.rows.append(dict(metrics, epoch=step))
        if step is None or step % 10 == 0 or step < 3:
            print(f"[train] epoch {step}: " + " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()), flush=True)

    def finish(self):
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--atoms", type=int, default=19)
    ap.add_argument("--features", type=int, default=128)
    ap.add_argument("--layers", type=int, default=5)
    ap.add_argument("--frames", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--a", type=float, default=0.1)
    ap.add_argument("--jitter", type=float, default=0.4)
    ap.add_argument("--temp_length", type=float, default=100.0)
    ap.add_argument("--train_impl", default="dense")
    ap.add_argument("--train_compute_dtype", default="bf16_agg")
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--T0", type=int, default=1000)
    ap.add_argument("--T1", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/ambient_oracle")
    ap.add_argument("--reuse", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_ambient_oracle: no CUDA device is available", file=sys.stderr)
        return 2

    from ti_torch.analysis.free_energy import calc_phis_tfep, calc_tfep_dF
    from ti_torch.analysis.weights import calc_ess
    from ti_torch.config import MDQM9Config, ambient_preset, fast_profile
    from ti_torch.data.mdqm9 import (
        MDQM9AmbientDataset,
        make_synthetic_frames,
        make_synthetic_molecule,
    )
    from ti_torch.ops import _build
    from ti_torch.sampling.drivers import sample_ambient
    from ti_torch.train import load_checkpoint, save_checkpoint, train_ambient
    from ti_torch.train.ambient import build_ambient_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    result = {"card": card, "args": vars(args)}
    T0, T1, n = args.T0, args.T1, args.atoms
    large = args.features >= 256  # the 10506 profile (fast_profile's rule)
    mol_name = "10506" if large else "00031"
    bs = 16 if large else 128  # chains a transport batch: the profiles' own

    def sigma(T):
        return args.jitter * math.sqrt(T / 300.0)

    mol = make_synthetic_molecule(n, seed=0)
    frames = {T: make_synthetic_frames(mol, args.frames, T, seed=T, jitter=args.jitter)
              for T in (T0, T1)}
    stack = np.concatenate([frames[T0], frames[T1]])
    temps = np.concatenate([np.full(args.frames, float(T)) for T in (T0, T1)])
    ds = MDQM9AmbientDataset.from_arrays(stack, temps, mol)
    cfg = MDQM9Config(
        n_features=args.features, score_layers=args.layers, batch_size=args.batch,
        n_epochs=args.epochs, learning_rate=args.lr, gamma="brownian", a=args.a,
        temp_length=args.temp_length, train_impl=args.train_impl,
        train_compute_dtype=args.train_compute_dtype, scale_trajs=False, T0s=[T0, T1],
        T1s=[T0, T1], seed=args.seed, model_save_name="oracle", use_wandb=False)
    weights = os.path.join(args.out, "oracle_weights.npz")

    # ---- 1. training ----
    if args.reuse:
        model = build_ambient_model(cfg, n).cuda()
        params = {k: v.cuda() for k, v in load_checkpoint(weights).items()}
        print(f"[train] reusing {weights}", flush=True)
    else:
        clock = EpochClock()
        with tempfile.TemporaryDirectory() as tmp:  # the per-epoch checkpoints
            cfg.model_save_path = tmp
            t0 = time.perf_counter()
            res = train_ambient(cfg, ds, ds, logger=clock)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        model, params = res["model"], res["params"]
        save_checkpoint(weights, params)
        steps = len(ds) // args.batch
        epoch_s = np.diff(clock.stamps)[1:]  # the first epoch pays the warm-up
        ms_step = 1e3 * float(np.median(epoch_s)) / steps
        result["train"] = {
            "seconds": wall, "epochs": args.epochs, "steps_per_epoch": steps,
            "ms_per_step_median_epoch": ms_step,
            "molecules_per_s": args.batch / ms_step * 1e3,
            "epoch_seconds_min_median_max": [float(epoch_s.min()), float(np.median(epoch_s)),
                                             float(epoch_s.max())],
            "final_train_loss": res["history"]["train_loss"][-1],
            "final_last_train_loss": res["history"]["last_train_loss"][-1],
            "nan_steps": res["state"].nan_count, "final_lr": res["state"].lr,
        }
        print(f"[train] {args.epochs} epochs x {steps} steps of batch {args.batch} "
              f"({args.train_impl} {args.train_compute_dtype}) in {wall:.1f} s; "
              f"{ms_step:.3f} ms a step (median epoch, with its re-evaluation and "
              f"checkpoints), {args.batch / ms_step * 1e3:.1f} molecules/s; final loss "
              f"{result['train']['final_train_loss']:.4f} ({card})", flush=True)

    # ---- 2. transport through the exact slice and the main path ----
    x0 = make_synthetic_frames(mol, args.chains, T0, seed=999, jitter=args.jitter)
    p_eq = (mol.positions - mol.positions.mean(axis=0, keepdims=True)).astype(np.float32)

    def energy(x, T):
        xc = x - x.mean(axis=-2, keepdims=True)
        return np.sum((xc - p_eq) ** 2, axis=(-2, -1)) / (2.0 * sigma(T) ** 2)

    dF_exact = -3 * (n - 1) * math.log(sigma(T1) / sigma(T0))
    if large:  # B3 takes F = 128 only: the exact floor on the dense f32 forward
        routes = {
            "exact": dict(divergence="exact", compute_dtype="f32", traj_forward_impl="default"),
            "main": {},
            "default_trajectory": dict(traj_forward_impl="default"),
        }
    else:
        routes = {
            "exact": dict(divergence="exact", div_forward_impl="pair_tangent"),
            "main": {},
            "bf16_agg_full_frame": dict(divergence="exact"),
        }
    dlogps = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, over in routes.items():
            c = fast_profile(ambient_preset(mol_name), data_save_path=tmp, sampling_T0=T0,
                             sampling_T1=T1, **over)
            sample_ambient(c, model, params, ds.template, x0[:bs], save=False,
                           batch_size=bs, device="cuda")  # warm-up
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            out = sample_ambient(c, model, params, ds.template, x0, save=False, batch_size=bs,
                                 device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            by_lib = {f"{k}:{lib}": v for (k, lib), v in _build.ROUTE_LAUNCHES.items() if v}
            x1, dl = out["samples"][:, -1], out["dlogps"]
            dlogps[name] = dl
            phis, _ = calc_phis_tfep(energy(x0, T0), energy(x1, T1), dl)
            dF = float(calc_tfep_dF(phis))
            w = np.exp(-phis - np.max(-phis))
            x1c = x1 - x1.mean(axis=1, keepdims=True)
            width = math.sqrt(float(np.sum((x1c - p_eq) ** 2, axis=(1, 2)).mean()) / (3 * (n - 1)))
            row = {"dF_est": dF, "dF_exact": dF_exact, "dF_err": abs(dF - dF_exact),
                   "ess_fraction": float(calc_ess(w)) / len(x0), "width": width,
                   "sigma_T0": sigma(T0), "sigma_T1": sigma(T1), "seconds": secs,
                   "samples_per_s": len(x0) / secs, "launches_by_library": by_lib,
                   "finite": bool(np.isfinite(x1).all() and np.isfinite(dl).all())}
            result[name] = row
            print(f"[transport {name}] {len(x0)} chains: |dF_est - dF_exact| = "
                  f"{row['dF_err']:.4f} (dF_est {dF:.4f}, exact {dF_exact:.4f}), ESS "
                  f"{100 * row['ess_fraction']:.2f}%, width {width:.4f} (sigma T0 "
                  f"{sigma(T0):.4f}, T1 {sigma(T1):.4f}); {secs:.2f} s, "
                  f"{row['samples_per_s']:.2f} samples/s; launches {by_lib} ({card})", flush=True)
    for name in [r for r in routes if r != "exact"]:
        d = dlogps[name] - dlogps["exact"]
        result[f"{name}_minus_exact_dlogp"] = {
            "mean": float(d.mean()), "rms": float(np.sqrt((d ** 2).mean())),
            "std_error": float(d.std(ddof=1) / math.sqrt(len(d)))}
        print(f"[dlogp {name} minus exact] mean {d.mean():.5f}, rms "
              f"{np.sqrt((d ** 2).mean()):.5f}, std error {d.std(ddof=1) / math.sqrt(len(d)):.5f}",
              flush=True)

    # ---- 3. the reference sampler's NFE on the trained field (00031 only) ----
    for label, n_save in () if large else (("save_points_100", None), ("endpoint_only", 2)):
        over = {} if n_save is None else {"n_steps": n_save}
        with tempfile.TemporaryDirectory() as tmp:
            c = ambient_preset("00031", data_save_path=tmp, sampling_T0=T0, sampling_T1=T1,
                               **over)
            t0 = time.perf_counter()
            out = sample_ambient(c, model, params, ds.template, x0[:c.batch_size], save=False,
                                 device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        nfe = np.asarray(out["nfe_per_chain"])
        result[f"dopri5_{label}"] = {
            "nfe_min": int(nfe.min()), "nfe_mean": float(nfe.mean()), "nfe_max": int(nfe.max()),
            "ref_nfe": REF_NFE, "chains": int(c.batch_size), "seconds": secs,
            "save_points": int(c.n_steps),
            "finite": bool(np.isfinite(out["samples"]).all() and np.isfinite(out["dlogps"]).all())}
        print(f"[dopri5 {label}] {c.batch_size} chains, {c.n_steps} save points: NFE a chain "
              f"{nfe.min()}-{nfe.max()} (mean {nfe.mean():.1f}) against REF_NFE = {REF_NFE}; "
              f"{secs:.1f} s ({card})", flush=True)

    ok = (result["exact"]["dF_err"] < (0.6 if large else 0.2)
          and result["exact"]["ess_fraction"] > 0.02
          and all(result[k]["finite"] for k in routes))
    result["ok"] = bool(ok)
    with open(os.path.join(args.out, "oracle.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
