"""Composed BG->TI end-to-end physics validation (port of
scripts/validate_bg_ti_physics.py: the reference's BG-TFEP route, latent
generator -> ambient transport -> combined importance weights).

Both stages train on exact Boltzmann samples of origin-centered isotropic
harmonic wells (u_T = |center(x)|^2 / (2 sigma_T^2), sigma_T =
jitter*sqrt(T/300), COM-projected). The composed generator density of x1 =
TI(BG(z)) is log q(x1) = log p_z(z) + dlogp_bg + dlogp_ti, so the weight
w = exp(-u_T1(x1)) / q(x1) satisfies E_q[w] = Z_T1 = (2 pi
sigma_T1^2)^{3(N-1)/2} exactly, whatever the models (only the spread of w,
the ESS, depends on them). ``train`` fits the latent and the ambient
stacks; ``evaluate`` composes them through ``sample_ambient(latent_z=,
latent_dlogp=)``, weighs the samples with ``calc_importance_weights`` and
prints one JSON line.

Usage: python -m ti_torch.cli.validate_bg_ti_physics [--latent_epochs 300]
    [--ambient_epochs 120] [--atoms 4] [--device cpu] ...

Runs on the card unless ``--device`` names another device.
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
    ap.add_argument("--latent_epochs", type=int, default=300)
    ap.add_argument("--ambient_epochs", type=int, default=120)
    ap.add_argument("--features", type=int, default=64)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames", type=int, default=4096)
    ap.add_argument("--atoms", type=int, default=4)
    ap.add_argument("--jitter", type=float, default=0.25)
    ap.add_argument("--T0", type=int, default=500)
    ap.add_argument("--T1", type=int, default=300)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--n_gen", type=int, default=1024)
    ap.add_argument("--gl_points", type=int, default=8)
    ap.add_argument("--out_dir", default=os.path.join(tempfile.gettempdir(), "bg_ti_physics"))
    ap.add_argument("--compute_dtype", choices=["f32", "bf16", "bf16_agg"], default="f32",
                    help="sampling compute dtype for both stages")
    ap.add_argument("--latent_quad", action="store_true",
                    help="use the GL quadrature-decoupled dlogp for the latent "
                         "stage too (stage 2 always uses it)")
    ap.add_argument("--sample_batch", type=int, default=512,
                    help="chain batch for both sampling stages")
    ap.add_argument("--divergence", choices=["exact", "hutchinson"], default="exact",
                    help="divergence estimator for both stages' dlogp")
    ap.add_argument("--num_probes", type=int, default=32)
    ap.add_argument("--probe_mode", choices=["rademacher", "orthogonal"],
                    default="rademacher")
    ap.add_argument("--train_impl", choices=["edge", "dense"], default="edge",
                    help="training forward impl for both stages")
    ap.add_argument("--train_compute_dtype", choices=["f32", "bf16", "bf16_agg"],
                    default="f32")
    ap.add_argument("--probe_debias", action="store_true",
                    help="record both stages' hutchinson probe-noise variance and "
                         "also report the log-normal-debiased identity row "
                         "(log_w -= (var_bg + var_ti)/2)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def sigma_of(args, T: float) -> float:
    from ti_torch.analysis.oracles import well_sigma

    return well_sigma(T, args.jitter)


def latent_config(args):
    """Stage 1's config: the latent BG at T0 (single-T, unconditioned)."""
    from ti_torch.config import MDQM9Config

    return MDQM9Config(
        n_features=args.features, score_layers=args.layers, batch_size=args.batch,
        n_epochs=args.latent_epochs, learning_rate=args.lr,
        scale_trajs=False, T=[args.T0], sampling_T=args.T0,
        solver_type="rk4", n_steps=64, return_dlogp=True,
        divergence=args.divergence, num_probes=args.num_probes, probe_mode=args.probe_mode,
        train_impl=args.train_impl, train_compute_dtype=args.train_compute_dtype,
        steps_per_dispatch=16, compute_dtype=args.compute_dtype,
        dlogp_quad_points=args.gl_points if args.latent_quad else 0, dlogp_quad="gauss",
        return_dlogp_var=bool(args.probe_debias and args.latent_quad
                              and args.divergence == "hutchinson"),
        model_save_path=f"{args.out_dir}/models_lat",
        data_save_path=f"{args.out_dir}/out_lat", use_wandb=False,
    )


def ambient_config(args):
    """Stage 2's config: the ambient TI T0 -> T1 (two-sided,
    (T0, T1)-conditioned), always on the Gauss quadrature dlogp."""
    from ti_torch.config import MDQM9Config

    T0, T1 = args.T0, args.T1
    return MDQM9Config(
        n_features=args.features, score_layers=args.layers, batch_size=args.batch,
        n_epochs=args.ambient_epochs, learning_rate=args.lr, gamma="brownian", a=0.1,
        scale_trajs=False, T0s=[T0, T1], T1s=[T0, T1], sampling_T0=T0, sampling_T1=T1,
        solver_type="rk4", n_steps=64, return_dlogp=True,
        divergence=args.divergence, num_probes=args.num_probes, probe_mode=args.probe_mode,
        train_impl=args.train_impl, train_compute_dtype=args.train_compute_dtype,
        steps_per_dispatch=16, dlogp_quad_points=args.gl_points, dlogp_quad="gauss",
        compute_dtype=args.compute_dtype,
        return_dlogp_var=bool(args.probe_debias and args.divergence == "hutchinson"),
        model_save_path=f"{args.out_dir}/models_amb",
        data_save_path=f"{args.out_dir}/out_amb", use_wandb=False,
    )


def train(args, device=None) -> dict:
    """Both stages trained on their wells: ``{"latent": (model, params,
    template), "ambient": (model, params, template)}``."""
    from ti_torch import resolve_device
    from ti_torch.data.mdqm9 import (
        MDQM9AmbientDataset,
        MDQM9LatentDataset,
        make_synthetic_molecule,
    )
    from ti_torch.train.ambient import train_ambient
    from ti_torch.train.latent import train_latent

    dev = resolve_device(device)
    T0, T1, N = args.T0, args.T1, args.atoms
    mol = make_synthetic_molecule(n_atoms=N, seed=0)
    rng = np.random.default_rng(7)

    def well_frames(T, n):
        f = sigma_of(args, T) * rng.standard_normal((n, N, 3)).astype(np.float32)
        return f - f.mean(axis=1, keepdims=True)

    frames = {T: well_frames(T, args.frames) for T in (T0, T1)}

    lat_ds = MDQM9LatentDataset.from_arrays(frames[T0], np.full(args.frames, float(T0)), mol,
                                            t_cond=0, align=True)
    lat = train_latent(latent_config(args), lat_ds, device=dev)
    print("latent losses:", [f"{x:.3f}" for x in lat["history"]["train_loss"][-3:]],
          file=sys.stderr)

    stack = np.concatenate([frames[T0], frames[T1]])
    temps = np.concatenate([np.full(args.frames, float(T0)), np.full(args.frames, float(T1))])
    amb_ds = MDQM9AmbientDataset.from_arrays(stack, temps, mol)
    amb = train_ambient(ambient_config(args), amb_ds, amb_ds, device=dev)
    print("ambient losses:", [f"{x:.3f}" for x in amb["history"]["train_loss"][-3:]],
          file=sys.stderr)
    return {"latent": (lat["model"], lat["params"], lat["template"]),
            "ambient": (amb["model"], amb["params"], amb["template"])}


def evaluate(fields: dict, args, device=None) -> dict:
    """The composed identity on trained ``fields`` (as ``train`` returns
    them): BG samples at T0 through ``sample_latent``, carried to T1 by
    ``sample_ambient`` with the noise and the BG dlogp passed through,
    weighed by ``calc_importance_weights``. Prints and returns the JSON
    row."""
    from ti_torch import resolve_device
    from ti_torch.analysis import oracles
    from ti_torch.analysis.weights import calc_ess, calc_importance_weights
    from ti_torch.sampling import drivers

    dev = resolve_device(device)
    T1, N = args.T1, args.atoms
    d_eff = 3 * (N - 1)
    lat_model, lat_params, lat_template = fields["latent"]
    amb_model, amb_params, amb_template = fields["ambient"]

    lat_out = drivers.sample_latent(
        latent_config(args), lat_model, lat_params, lat_template, n_samples=args.n_gen,
        save=False, batch_size=min(args.n_gen, args.sample_batch), device=dev)
    z = lat_out["samples"][:, 0]
    x0 = lat_out["samples"][:, -1]
    dlogp_bg = lat_out["dlogps"]

    out = drivers.sample_ambient(
        ambient_config(args), amb_model, amb_params, amb_template, x0, latent_z=z,
        latent_dlogp=dlogp_bg, save=False,
        batch_size=min(args.n_gen, 256, args.sample_batch), device=dev)
    x1 = out["samples"][:, -1]
    dlogp_ti = out["dlogps"]

    # the composed identity: E_q[exp(-u1)/q] = Z_T1
    E1 = oracles.well_energy(x1, sigma_of(args, T1))
    log_w = -E1 - oracles.gaussian_log_pz(z, d_eff) - dlogp_bg - dlogp_ti
    mx = log_w.max()
    # the analysis layer's own weights (the reference's ess.py:13-23): z in
    # an orthonormal zero-COM basis, so its N(0, I) normalisation counts
    # the 3(N-1) dimensions the noise has
    z_sub = oracles.zero_com_coords(z)
    w_ref = calc_importance_weights(z_sub.reshape(len(z), -1), E1 + mx,
                                    neg_dlogps_bg=dlogp_bg, neg_dlogps_ti=dlogp_ti)
    np.testing.assert_allclose(w_ref, np.exp(log_w - mx), rtol=1e-4)

    neg_log_Z_est = oracles.neg_log_mean_exp(log_w)
    neg_log_Z_exact = oracles.neg_log_z_exact(sigma_of(args, T1), d_eff)
    ess = calc_ess(np.exp(log_w - mx))

    debias_report = {}
    if args.probe_debias and "dlogp_vars" in out:
        # both stages' probe noise is independent of the sample: the
        # log-normal debias subtracts (var_bg + var_ti)/2 from log w
        v = np.asarray(out["dlogp_vars"])
        if "dlogp_vars" in lat_out:
            v = v + np.asarray(lat_out["dlogp_vars"])
        log_w_c = log_w - 0.5 * v
        est_c = oracles.neg_log_mean_exp(log_w_c)
        debias_report = {
            "neg_log_Z_est_debiased": est_c,
            "abs_err_debiased": abs(est_c - neg_log_Z_exact),
            "ess_frac_debiased": calc_ess(np.exp(log_w_c - log_w_c.max())) / len(x1),
            "dlogp_var_mean": float(v.mean()),
        }

    row = {
        "width": oracles.rms_width(x1, d_eff), "width_target": sigma_of(args, T1),
        "width_bg_stage": sigma_of(args, args.T0),
        "neg_log_Z_est": neg_log_Z_est, "neg_log_Z_exact": neg_log_Z_exact,
        "abs_err": abs(neg_log_Z_est - neg_log_Z_exact),
        "ess": ess, "ess_frac": ess / len(x1), "n": len(x1),
        **debias_report,
    }
    print(json.dumps(row))
    return row


def main(argv=None) -> int:
    args = parse(argv)
    from ti_torch import resolve_device

    dev = resolve_device(args.device)
    evaluate(train(args, dev), args, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
