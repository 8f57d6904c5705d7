"""Latent (Boltzmann-generator) end-to-end physics validation (port of
scripts/validate_latent_physics.py).

Synthetic frames are exact Boltzmann samples of an isotropic harmonic well
centered at the origin (u = |center(x)|^2 / (2 sigma_T^2), sigma_T =
jitter*sqrt(T/300), COM-projected; rotation-invariant, as an SE(3)-
equivariant generator needs). With z ~ N(0, I) COM-projected (3(N-1)
dimensions) carried to x by the learned flow with dlogp, the generator's
density is log q(x) = log p_z(z) + dlogp and the weight w = exp(-u(x))/q(x)
satisfies E_q[w] = Z = (2 pi sigma_T^2)^{3(N-1)/2} exactly, whatever the
generator (ti_torch/analysis/oracles.py). This CLI trains the latent stack
(``train_latent``), generates with ``sample_latent`` and prints the
partition-function identity as one JSON line.

Usage: python -m ti_torch.cli.validate_latent_physics [--epochs 400] [--device cpu]

Runs on the card unless ``--device`` names another device. The trained
weights go to ``out_dir/oracle_params.npz`` (``convert.save_npz`` with the
arch flags that shape them); ``--reuse`` reads them back and exits on an
arch mismatch.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--features", type=int, default=64)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames", type=int, default=4096)
    ap.add_argument("--atoms", type=int, default=4)
    ap.add_argument("--jitter", type=float, default=0.25)
    ap.add_argument("--T", type=int, default=300)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--t_distr", default="uniform")
    ap.add_argument("--n_gen", type=int, default=2048)
    ap.add_argument("--align", type=int, default=1)
    ap.add_argument("--out_dir", default=os.path.join(tempfile.gettempdir(), "latent_physics"))
    ap.add_argument("--n_steps", type=int, default=64,
                    help="rk4 trajectory steps for the generator transport")
    ap.add_argument("--compute_dtype", choices=["f32", "bf16", "bf16_agg"], default="f32",
                    help="sampling-path compute dtype")
    ap.add_argument("--quad_dlogp", action="store_true",
                    help="Gauss-Legendre quadrature-decoupled dlogp instead of the "
                         "stage-coupled exact dlogp")
    ap.add_argument("--gl_points", type=int, default=8)
    ap.add_argument("--divergence", choices=["exact", "hutchinson"], default="exact")
    ap.add_argument("--num_probes", type=int, default=16)
    ap.add_argument("--probe_mode", choices=["rademacher", "orthogonal"],
                    default="rademacher")
    ap.add_argument("--sample_batch", type=int, default=512,
                    help="generator chain batch")
    ap.add_argument("--reuse", action="store_true",
                    help="reload out_dir/oracle_params.npz from a previous run "
                         "instead of retraining")
    ap.add_argument("--train_impl", choices=["edge", "dense"], default="edge")
    ap.add_argument("--train_compute_dtype", choices=["f32", "bf16", "bf16_agg"],
                    default="f32")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def bg_identity(z, x, dlogp, sigma: float) -> dict:
    """The BG partition-function identity of generated samples: width,
    -log Z estimated and exact, their difference and the ESS."""
    from ti_torch.analysis import oracles

    d_eff = 3 * (x.shape[1] - 1)
    log_w = -oracles.well_energy(x, sigma) - oracles.gaussian_log_pz(z, d_eff) - dlogp
    est = oracles.neg_log_mean_exp(log_w)
    exact = oracles.neg_log_z_exact(sigma, d_eff)
    return {"width": oracles.rms_width(x, d_eff), "width_target": sigma,
            "neg_log_Z_est": est, "neg_log_Z_exact": exact, "abs_err": abs(est - exact),
            "ess": oracles.ess_of_log_w(log_w), "n": len(x)}


def main(argv=None) -> int:
    args = parse(argv)

    from ti_torch import resolve_device
    from ti_torch.analysis import oracles
    from ti_torch.cli.validate_mdqm9_physics import load_reused
    from ti_torch.config import MDQM9Config
    from ti_torch.data.mdqm9 import MDQM9LatentDataset, make_synthetic_molecule
    from ti_torch.models.convert import save_npz
    from ti_torch.sampling import drivers
    from ti_torch.train.latent import build_latent_model, train_latent

    dev = resolve_device(args.device)
    T, N = args.T, args.atoms
    sigma = oracles.well_sigma(T, args.jitter)

    mol = make_synthetic_molecule(n_atoms=N, seed=0)
    rng = np.random.default_rng(7)
    frames = sigma * rng.standard_normal((args.frames, N, 3)).astype(np.float32)
    frames -= frames.mean(axis=1, keepdims=True)

    cfg = MDQM9Config(
        n_features=args.features, score_layers=args.layers, batch_size=args.batch,
        n_epochs=args.epochs, learning_rate=args.lr, t_distr=args.t_distr,
        scale_trajs=False, T=[T], sampling_T=T,
        solver_type="rk4", n_steps=args.n_steps, return_dlogp=True,
        divergence=args.divergence, num_probes=args.num_probes, probe_mode=args.probe_mode,
        train_impl=args.train_impl, train_compute_dtype=args.train_compute_dtype,
        compute_dtype=args.compute_dtype,
        dlogp_quad_points=args.gl_points if args.quad_dlogp else 0, dlogp_quad="gauss",
        steps_per_dispatch=16,
        model_save_path=f"{args.out_dir}/models", data_save_path=f"{args.out_dir}/out",
        use_wandb=False,
    )
    ds = MDQM9LatentDataset.from_arrays(frames, np.full(len(frames), float(T)), mol, t_cond=0,
                                        align=bool(args.align))

    params_path = os.path.join(args.out_dir, "oracle_params.npz")
    arch = {"features": args.features, "layers": args.layers, "atoms": args.atoms}
    if args.reuse and os.path.exists(params_path):
        print(f"reusing trained params from {params_path}", file=sys.stderr)
        model = build_latent_model(cfg, N).to(dev)
        params = {k: t.to(dev) for k, t in load_reused(params_path, arch).items()}
    else:
        res = train_latent(cfg, ds, device=dev)
        print("final train losses:", [f"{x:.3f}" for x in res["history"]["train_loss"][-3:]],
              file=sys.stderr)
        model, params = res["model"], res["params"]
        os.makedirs(args.out_dir, exist_ok=True)
        save_npz(params_path, {k: t.detach().cpu() for k, t in params.items()}, arch=arch)

    out = drivers.sample_latent(cfg, model, params, ds.template, n_samples=args.n_gen,
                                save=False, batch_size=min(args.n_gen, args.sample_batch),
                                device=dev)
    print(json.dumps(bg_identity(out["samples"][:, 0], out["samples"][:, -1], out["dlogps"],
                                 sigma)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
