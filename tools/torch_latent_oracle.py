"""The latent (Boltzmann-generator) partition identity, and the composed
BG→TI identity, on fields the port trains, on one CUDA card.

The port's counterpart of scripts/validate_latent_physics.py and
scripts/validate_bg_ti_physics.py at 00031 capacity. Frames are exact
Boltzmann samples of an origin-centred isotropic well, u_T(x) =
|x - com(x)|² / (2 sigma_T²), sigma_T = jitter * sqrt(T/300). With z ~
N(0, I) COM-free (3(N-1) dimensions) carried to x by the learned flow with
dlogp, the generator's density is log q(x) = log p(z) + dlogp, and the
weight w = exp(-u_T(x)) / q(x) has E_q[w] = Z_T = (2 pi sigma_T²)^(3(N-1)/2)
exactly, whatever the generator: only the spread of w (the ESS) depends on
it. The script

1. trains the generator with ``train_latent`` on the card at T0 (19 atoms,
   F = 128, 5 layers, 4096 frames, batch 64, 100 epochs, lr 2e-3, dense
   bf16_agg), and reports the trainer's seconds, ms a step and molecules/s;
2. draws 1024 chains through ``sample_latent`` on four routes and reports
   each one's |-log Z err|, ESS and width: the exact route (stage-coupled
   RK4-64 with the exact divergence in every stage; its velocity and JVPs
   run ``impl="dense_fused"``, kernels B4 and B5), the latent kernel route
   (``fast_profile(family="latent")`` in f32 with B1's trajectory and B3's
   full orthogonal frame), and the published latent profile (bf16, dense,
   exact divergence) at GL-8 and at GL-16;
3. with ``--compose``, trains the ambient field T0 <-> T1 (60 epochs, 2048
   frames a temperature, batch 64, brownian a = 0.1, dense bf16_agg), pushes
   the exact route's samples T0 -> T1 through ``sample_ambient`` with the
   noise and the BG dlogp passed through (the exact slice: B1 f32, B3 f32
   full frame; and the main path: B3 bf16_agg, orthogonal-16), and reports
   the composed identity at T1 through ``calc_importance_weights``.

    python3 tools/torch_latent_oracle.py [--compose] [--out chiprun_out/latent_oracle]

Gates: the exact route's |-log Z err| < 0.2 and ESS > 10% of the chains;
composed (exact slice) |err| < 0.5 and ESS > 1%. ``--reuse`` takes from
``--out`` what a previous run saved there (the trained weights, each BG
route's samples, dlogp and row) and computes the rest, so a run can be
split across calls: ``... torch_latent_oracle.py`` then ``...
torch_latent_oracle.py --reuse --compose``. The last line of standard
output is one JSON object with every number; it is also written to
``--out``/oracle.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.torch_ambient_oracle import EpochClock, card_line  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--ambient_epochs", type=int, default=60)
    ap.add_argument("--atoms", type=int, default=19)
    ap.add_argument("--features", type=int, default=128)
    ap.add_argument("--layers", type=int, default=5)
    ap.add_argument("--frames", type=int, default=4096)
    ap.add_argument("--ambient_frames", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--jitter", type=float, default=0.25)
    ap.add_argument("--train_impl", default="dense")
    ap.add_argument("--train_compute_dtype", default="bf16_agg")
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--sample_batch", type=int, default=128)
    ap.add_argument("--T0", type=int, default=500)
    ap.add_argument("--T1", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compose", action="store_true")
    ap.add_argument("--out", default="chiprun_out/latent_oracle")
    ap.add_argument("--reuse", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_latent_oracle: no CUDA device is available", file=sys.stderr)
        return 2

    from ti_torch.analysis import oracles
    from ti_torch.analysis.weights import calc_importance_weights
    from ti_torch.config import MDQM9Config, ambient_preset, fast_profile, latent_preset
    from ti_torch.data.mdqm9 import (
        MDQM9AmbientDataset,
        MDQM9LatentDataset,
        make_synthetic_molecule,
    )
    from ti_torch.ops import _build
    from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of, sample_ambient
    from ti_torch.sampling.drivers import sample_latent
    from ti_torch.train import load_checkpoint, save_checkpoint, train_ambient, train_latent
    from ti_torch.train.ambient import build_ambient_model
    from ti_torch.train.latent import build_latent_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    result = {"card": card, "args": vars(args)}
    T0, T1, n = args.T0, args.T1, args.atoms
    d_eff = 3 * (n - 1)

    def sigma(T):
        return oracles.well_sigma(T, args.jitter)

    def neg_log_z(T):
        return oracles.neg_log_z_exact(sigma(T), d_eff)

    rng = np.random.default_rng(7)

    def well_frames(T, count):
        f = sigma(T) * rng.standard_normal((count, n, 3))
        return (f - f.mean(axis=1, keepdims=True)).astype(np.float32)

    def energy(x, T):
        return oracles.well_energy(x.astype(np.float64), sigma(T))

    def log_pz(z):
        return oracles.gaussian_log_pz(z.astype(np.float64), d_eff)

    def identity(log_w, x, T):
        est = oracles.neg_log_mean_exp(log_w)
        return {"neg_log_Z_est": est, "neg_log_Z_exact": neg_log_z(T),
                "abs_err": abs(est - neg_log_z(T)),
                "ess_fraction": oracles.ess_of_log_w(log_w) / len(x),
                "width": oracles.rms_width(x, d_eff), "width_target": sigma(T),
                "finite": bool(np.isfinite(x).all() and np.isfinite(log_w).all())}

    def train_cfg(**kw):
        return MDQM9Config(
            n_features=args.features, score_layers=args.layers, batch_size=args.batch,
            learning_rate=args.lr, train_impl=args.train_impl,
            train_compute_dtype=args.train_compute_dtype, scale_trajs=False, seed=args.seed,
            use_wandb=False, **kw)

    def trained(name, cfg, build, train, n_frames):
        """Train one field, or with ``--reuse`` reload the weights a previous
        run saved; returns (model, params)."""
        weights = os.path.join(args.out, f"{name}_weights.npz")
        if args.reuse and os.path.exists(weights):
            print(f"[train {name}] reusing {weights}", flush=True)
            return build().cuda(), {k: v.cuda() for k, v in load_checkpoint(weights).items()}
        clock = EpochClock()
        with tempfile.TemporaryDirectory() as tmp:  # the per-epoch checkpoints
            cfg.model_save_path = tmp
            t0 = time.perf_counter()
            res = train(cfg, clock)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        save_checkpoint(weights, res["params"])
        steps = n_frames // args.batch
        epoch_s = np.diff(clock.stamps)[1:]  # the first epoch pays the warm-up
        ms_step = 1e3 * float(np.median(epoch_s)) / steps
        result[f"train_{name}"] = {
            "seconds": wall, "epochs": cfg.n_epochs, "steps_per_epoch": steps,
            "ms_per_step_median_epoch": ms_step, "molecules_per_s": args.batch / ms_step * 1e3,
            "final_train_loss": res["history"]["train_loss"][-1],
            "final_last_train_loss": res["history"]["last_train_loss"][-1],
            "nan_steps": res["state"].nan_count, "final_lr": res["state"].lr}
        print(f"[train {name}] {cfg.n_epochs} epochs x {steps} steps of batch {args.batch} "
              f"({args.train_impl} {args.train_compute_dtype}) in {wall:.1f} s; {ms_step:.3f} ms "
              f"a step (median epoch, with its re-evaluation and checkpoints), "
              f"{args.batch / ms_step * 1e3:.1f} molecules/s; final loss "
              f"{res['history']['train_loss'][-1]:.4f} ({card})", flush=True)
        return res["model"], res["params"]

    mol = make_synthetic_molecule(n, seed=0)

    # ---- 1. the generator at T0 ----
    lat_cfg = train_cfg(n_epochs=args.epochs, T=[T0], sampling_T=T0, model_save_name="latent")
    lat_ds = MDQM9LatentDataset.from_arrays(well_frames(T0, args.frames),
                                            np.full(args.frames, float(T0)), mol, t_cond=0)
    model, params = trained("latent", lat_cfg, lambda: build_latent_model(lat_cfg, n),
                            lambda c, lg: train_latent(c, lat_ds, logger=lg), args.frames)

    # ---- 2. the BG identity on four routes ----
    def base():  # fast_profile edits the config it is given: a fresh one a route
        return latent_preset("00031", Ts=[T0], sampling_T=T0, n_features=args.features,
                             score_layers=args.layers, seed=args.seed)

    noise = lat_ds.sample_noise(torch.Generator(device="cuda").manual_seed(args.seed + 11),
                                args.chains).cpu().numpy()
    routes = {
        "kernel": fast_profile(base(), family="latent", compute_dtype="f32",
                               traj_forward_impl="pair_kernel", div_forward_impl="pair_tangent"),
        "published_gl8": fast_profile(base(), family="latent"),
        "published_gl16": fast_profile(base(), family="latent", dlogp_quad_points=16),
        "exact": None,
    }
    outs = {}
    for name, cfg in routes.items():
        saved = os.path.join(args.out, f"bg_{name}.npz")
        if args.reuse and os.path.exists(saved):  # a previous run's samples and dlogp
            outs[name] = dict(np.load(saved))
            result[f"bg_{name}"] = json.load(open(saved[:-4] + ".json"))
            print(f"[BG {name}] reusing {saved}", flush=True)
            continue
        t0 = time.perf_counter()
        _build.reset_launches()
        if cfg is None:  # stage-coupled RK4-64, exact divergence in every stage
            sampler = make_ode_sampler(
                molecular_v_fn_of(model, params, lat_ds.template, impl="dense_fused",
                                  device="cuda"),
                solver="rk4", n_steps=64, n_save=2, divergence="exact", device="cuda")
            xs, dl = [], []
            for i in range(0, args.chains, args.sample_batch):
                zb = noise[i: i + args.sample_batch]
                sol = sampler(zb, torch.zeros(len(zb), 0, device="cuda"))
                xs.append(sol.xs.cpu().numpy())
                dl.append(sol.dlogp[:, -1].cpu().numpy())
            out = {"samples": np.concatenate(xs), "dlogps": np.concatenate(dl)}
        else:
            out = sample_latent(cfg, model, params, lat_ds.template, noise=noise, save=False,
                                batch_size=args.sample_batch, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        outs[name] = out
        z, x = out["samples"][:, 0], out["samples"][:, -1]
        row = identity(-energy(x, T0) - log_pz(z) - out["dlogps"], x, T0)
        row.update(seconds=secs, samples_per_s=args.chains / secs,
                   launches_by_library={f"{k}:{lib}": v
                                        for (k, lib), v in _build.ROUTE_LAUNCHES.items() if v})
        result[f"bg_{name}"] = row
        np.savez(saved, samples=out["samples"], dlogps=out["dlogps"])
        with open(saved[:-4] + ".json", "w") as f:
            json.dump(row, f)
        print(f"[BG {name}] {args.chains} chains at {T0} K: |-log Z err| {row['abs_err']:.4f} "
              f"(est {row['neg_log_Z_est']:.4f}, exact {row['neg_log_Z_exact']:.4f}), ESS "
              f"{100 * row['ess_fraction']:.2f}%, width {row['width']:.4f} (sigma "
              f"{sigma(T0):.4f}); {secs:.1f} s, {row['samples_per_s']:.2f} samples/s; launches "
              f"{row['launches_by_library']} ({card})", flush=True)
    for name in ("kernel", "published_gl8", "published_gl16"):
        d = outs[name]["dlogps"] - outs["exact"]["dlogps"]
        result[f"bg_{name}_minus_exact_dlogp"] = {
            "mean": float(d.mean()), "rms": float(np.sqrt((d ** 2).mean()))}
        print(f"[BG dlogp {name} minus exact] mean {d.mean():.5f}, rms "
              f"{np.sqrt((d ** 2).mean()):.5f}", flush=True)
    ok = (result["bg_exact"]["abs_err"] < 0.2 and result["bg_exact"]["ess_fraction"] > 0.1
          and all(result[f"bg_{k}"]["finite"] for k in routes))

    # ---- 3. BG -> TI: the ambient field T0 <-> T1, the composed identity at T1 ----
    if args.compose:
        stack = np.concatenate([well_frames(T, args.ambient_frames) for T in (T0, T1)])
        temps = np.concatenate([np.full(args.ambient_frames, float(T)) for T in (T0, T1)])
        amb_ds = MDQM9AmbientDataset.from_arrays(stack, temps, mol)
        amb_cfg = train_cfg(n_epochs=args.ambient_epochs, gamma="brownian", a=0.1,
                            T0s=[T0, T1], T1s=[T0, T1], model_save_name="ambient")
        amb_model, amb_params = trained(
            "ambient", amb_cfg, lambda: build_ambient_model(amb_cfg, n),
            lambda c, lg: train_ambient(c, amb_ds, amb_ds, logger=lg), 2 * args.ambient_frames)
        bg = outs["exact"]
        z, x0, dlogp_bg = bg["samples"][:, 0], bg["samples"][:, -1], bg["dlogps"]
        z_sub = oracles.zero_com_coords(z.astype(np.float64))
        for name, over in (("exact_slice", dict(divergence="exact",
                                                div_forward_impl="pair_tangent")),
                           ("main_path", {})):
            cfg = fast_profile(ambient_preset("00031"), sampling_T0=T0, sampling_T1=T1,
                               seed=args.seed, **over)
            t0 = time.perf_counter()
            _build.reset_launches()
            out = sample_ambient(cfg, amb_model, amb_params, amb_ds.template, x0, latent_z=z,
                                 latent_dlogp=dlogp_bg, save=False,
                                 batch_size=args.sample_batch, device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            x1 = out["samples"][:, -1]
            e1 = energy(x1, T1)
            log_w = -e1 - log_pz(z) - dlogp_bg - out["dlogps"]
            row = identity(log_w, x1, T1)
            w = calc_importance_weights(z_sub.reshape(len(z), -1), e1 + log_w.max(),
                                        neg_dlogps_bg=out["latent_dlogps"],
                                        neg_dlogps_ti=out["dlogps"])
            row.update(seconds=secs, weights_agree=bool(np.allclose(  # f32 noise and dlogps
                np.log(w), log_w - log_w.max(), rtol=1e-6, atol=1e-4)),
                passthrough=bool(np.array_equal(out["latent_noises"], z)
                                 and np.array_equal(out["latent_dlogps"], dlogp_bg)),
                launches_by_library={f"{k}:{lib}": v
                                     for (k, lib), v in _build.ROUTE_LAUNCHES.items() if v})
            result[f"bg_ti_{name}"] = row
            print(f"[BG->TI {name}] {args.chains} chains {T0} -> {T1} K: |-log Z err| "
                  f"{row['abs_err']:.4f} (est {row['neg_log_Z_est']:.4f}, exact "
                  f"{row['neg_log_Z_exact']:.4f}), ESS {100 * row['ess_fraction']:.2f}%, width "
                  f"{row['width']:.4f} (sigma {sigma(T1):.4f}); {secs:.1f} s; launches "
                  f"{row['launches_by_library']} ({card})", flush=True)
        comp = result["bg_ti_exact_slice"]
        ok = ok and comp["abs_err"] < 0.5 and comp["ess_fraction"] > 0.01 and all(
            result[f"bg_ti_{k}"][c] for k in ("exact_slice", "main_path")
            for c in ("finite", "weights_agree", "passthrough"))

    result["ok"] = bool(ok)
    with open(os.path.join(args.out, "oracle.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
