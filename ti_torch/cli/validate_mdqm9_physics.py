"""Molecular end-to-end physics validation against closed-form oracles (port
of scripts/validate_mdqm9_physics.py).

Synthetic frames are exact Boltzmann samples of an isotropic harmonic well
(sigma_T = jitter*sqrt(T/300), COM-centered), so the TFEP free-energy
difference and the mean dlogp are closed-form (ti_torch/analysis/oracles.py).
This CLI trains the ambient stack (``train_ambient``), transports 1024 fresh
T0 frames to T1 and prints the oracle comparison as one JSON line.

Usage: python -m ti_torch.cli.validate_mdqm9_physics [--epochs 300] [--features 64]
    [--device cpu]

Runs on the card unless ``--device`` names another device. The trained
weights go to ``out_dir/oracle_params.npz`` (``convert.save_npz`` with the
arch flags that shape them); ``--reuse`` reads them back and exits on an
arch mismatch. ``--traj_impl``, ``--div_impl`` and ``--probe_debias`` need
``--quad_dlogp``; on the card a kernel flag whose library is not built for
``--features`` raises ``WidthRefusal`` before anything trains (B1 and B3 take
F = 64, the default, 128 and 256; ``ops/pair_layer_kernel.py``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np


def _ints(s):
    return [int(v) for v in s.split(",")]


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--features", type=int, default=64)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames", type=int, default=2048)
    ap.add_argument("--atoms", type=int, default=4)
    ap.add_argument("--jitter", type=float, default=0.4)
    ap.add_argument("--T0", type=int, default=1000)
    ap.add_argument("--T1", type=int, default=300)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--gamma", default="brownian")
    ap.add_argument("--a", type=float, default=0.1)
    ap.add_argument("--single_direction", action="store_true",
                    help="train only T0->T1 pairs (conditioning ablation)")
    ap.add_argument("--train_temps", type=_ints, default=None,
                    help="comma list of training temperatures (leave-one-out "
                         "extrapolation oracle: exclude T1, e.g. "
                         "--train_temps 300,400,500,700,800,900,1000 --T1 600)")
    ap.add_argument("--temp_length", type=float, default=100.0,
                    help="temperature positional-encoding length scale")
    ap.add_argument("--out_dir", default=os.path.join(tempfile.gettempdir(), "mdqm9_physics"))
    ap.add_argument("--eval_batch", type=int, default=0,
                    help="transport-evaluation chain batch (0 = all 1024 at once)")
    ap.add_argument("--reuse", action="store_true",
                    help="load out_dir/oracle_params.npz from a previous run "
                         "instead of retraining")
    ap.add_argument("--eval_steps", type=_ints, default=[64],
                    help="comma list; first = headline, rest = step study")
    ap.add_argument("--solver", choices=["euler", "heun", "rk4"], default="rk4",
                    help="fixed-step trajectory solver for the transport")
    ap.add_argument("--quad_dlogp", action="store_true",
                    help="use the Gauss-Legendre dlogp path")
    ap.add_argument("--traj_impl", choices=["default", "pair_kernel", "pair_kernel_bf16"],
                    default="default",
                    help="trajectory-segment drift for the gauss path (requires "
                         "--quad_dlogp): kernel B1 in f32 or bf16_agg")
    ap.add_argument("--div_impl", choices=["default", "pair_tangent", "pair_tangent_bf16"],
                    default="default",
                    help="divergence-node estimator for the gauss path (requires "
                         "--quad_dlogp): kernel B3 in f32 or bf16_agg; with "
                         "--divergence exact the full orthogonal frame")
    ap.add_argument("--gl_points", type=int, default=10)
    ap.add_argument("--divergence", choices=["exact", "hutchinson", "hutchpp"],
                    default="exact")
    ap.add_argument("--num_probes", type=int, default=8)
    ap.add_argument("--probe_mode", choices=["rademacher", "orthogonal"],
                    default="rademacher")
    ap.add_argument("--probe_debias", action="store_true",
                    help="record the per-sample probe-noise variance of the "
                         "hutchinson dlogp (gauss path only) and also report "
                         "the log-normal-debiased oracle row (phi += var/2)")
    ap.add_argument("--probe_crn", action="store_true",
                    help="share the stochastic-divergence probes across chains")
    ap.add_argument("--probe_sweep", default=None,
                    help="comma list of mode:K:seed combos (mode = "
                         "rademacher|orthogonal|exact), one JSON line each")
    ap.add_argument("--eval_seed", type=int, default=0,
                    help="seed of the transport's probe draws")
    ap.add_argument("--sde_g", type=lambda s: [float(v) for v in s.split(",")], default=None,
                    help="comma list of SDE noise scales g: also transport with "
                         "Euler-Maruyama and report the final width and the KS "
                         "statistic of the target energy against Gamma(3(N-1)/2, 1)")
    ap.add_argument("--sde_steps", type=int, default=100,
                    help="Euler-Maruyama step count for --sde_g")
    ap.add_argument("--train_impl", choices=["edge", "dense"], default="edge")
    ap.add_argument("--train_compute_dtype", choices=["f32", "bf16", "bf16_agg"],
                    default="f32")
    ap.add_argument("--compute_dtype", choices=["f32", "bf16", "bf16_agg", "both", "all"],
                    default="f32",
                    help="sampling-path compute dtype; 'both' also evaluates "
                         "bf16, 'all' bf16 and bf16_agg, on the same field")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def check_flags(args, dev) -> None:
    """The script's guards, before anything trains: the kernel flags need
    the quadrature path, and on the card their libraries must be built for
    ``--features`` (``WidthRefusal`` otherwise)."""
    if args.traj_impl != "default" and not args.quad_dlogp:
        raise SystemExit("--traj_impl requires --quad_dlogp (the gauss "
                         "quadrature-dlogp path, see make_ode_sampler)")
    if args.div_impl != "default" and not args.quad_dlogp:
        raise SystemExit("--div_impl requires --quad_dlogp (the gauss "
                         "quadrature-dlogp path, see make_ode_sampler)")
    if args.probe_debias and not args.quad_dlogp:
        raise SystemExit("--probe_debias requires --quad_dlogp (the gauss "
                         "quadrature-dlogp path)")
    if dev.type != "cuda":  # the plain versions take any width
        return
    from ti_torch.ops import pair_layer_kernel as plk
    from ti_torch.ops import pair_tangent_kernel as ptk

    libs = []
    if args.traj_impl != "default":
        libs.append(plk._route(args.traj_impl.endswith("bf16"), 1, None, args.features))
    if args.div_impl != "default":
        libs.append(ptk._route(args.div_impl.endswith("bf16"), "mma", args.features))
    for lib in libs:
        plk.check_width(args.features, lib, plk.LIB_WIDTHS.get(lib, plk.KERNEL_F))


def load_reused(path: str, arch: dict):
    """The state dict saved at ``path``; exits when its arch differs from
    ``arch`` (the flags that shape the model)."""
    from ti_torch.models.convert import load_npz_arch

    state, saved = load_npz_arch(path)
    diff = {}
    if saved is not None:
        diff = {k: (saved.get(k), arch[k]) for k in arch
                if saved.get(k) is None or float(np.asarray(saved[k])) != float(arch[k])}
    if diff:
        raise SystemExit(
            f"--reuse architecture mismatch vs {path}: {diff} (saved, requested). "
            "Re-run without --reuse or match the flags the checkpoint was trained with."
        )
    return state


def main(argv=None) -> int:
    args = parse(argv)

    import torch

    from ti_torch import resolve_device
    from ti_torch.analysis import oracles
    from ti_torch.config import MDQM9Config
    from ti_torch.data.mdqm9 import (
        MDQM9AmbientDataset,
        make_synthetic_frames,
        make_synthetic_molecule,
    )
    from ti_torch.models.convert import save_npz
    from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of
    from ti_torch.train.ambient import build_ambient_model, train_ambient

    dev = resolve_device(args.device)
    check_flags(args, dev)
    T0, T1, N = args.T0, args.T1, args.atoms

    def sigma(T):
        return oracles.well_sigma(T, args.jitter)

    mol = make_synthetic_molecule(n_atoms=N, seed=0)
    # leave-one-out extrapolation: train only on --train_temps (which must
    # exclude T1 for a true held-out target)
    train_T = args.train_temps or [T0, T1]
    frames = {T: make_synthetic_frames(mol, args.frames, T, seed=T, jitter=args.jitter)
              for T in sorted(set(train_T) | {T0, T1})}
    stack = np.concatenate([frames[T] for T in train_T])
    temps = np.concatenate([np.full(args.frames, float(T)) for T in train_T])

    t0_list = [T0] if args.single_direction else train_T
    t1_list = [T1] if args.single_direction else train_T
    cfg = MDQM9Config(
        n_features=args.features, score_layers=args.layers, batch_size=args.batch,
        n_epochs=args.epochs, learning_rate=args.lr, gamma=args.gamma, a=args.a,
        temp_length=args.temp_length,
        train_impl=args.train_impl, train_compute_dtype=args.train_compute_dtype,
        scale_trajs=False, T0s=t0_list, T1s=t1_list,
        model_save_path=f"{args.out_dir}/models", data_save_path=f"{args.out_dir}/out",
        use_wandb=False,
    )
    if args.single_direction:
        ds0 = MDQM9AmbientDataset.from_arrays(frames[T0], np.full(args.frames, float(T0)), mol)
        ds1 = MDQM9AmbientDataset.from_arrays(frames[T1], np.full(args.frames, float(T1)), mol)
    else:
        ds0 = ds1 = MDQM9AmbientDataset.from_arrays(stack, temps, mol)

    params_path = os.path.join(args.out_dir, "oracle_params.npz")
    arch = {"features": args.features, "layers": args.layers,
            "temp_length": args.temp_length, "atoms": args.atoms}
    if args.reuse and os.path.exists(params_path):
        model = build_ambient_model(cfg, N).to(dev)
        params = {k: t.to(dev) for k, t in load_reused(params_path, arch).items()}
        print(f"reusing trained params from {params_path}", file=sys.stderr)
    else:
        res = train_ambient(cfg, ds0, ds1, device=dev)
        print("final train losses:", [f"{x:.3f}" for x in res["history"]["train_loss"][-3:]],
              file=sys.stderr)
        model, params = res["model"], res["params"]
        os.makedirs(args.out_dir, exist_ok=True)
        save_npz(params_path, {k: t.detach().cpu() for k, t in params.items()}, arch=arch)
    template = ds0.template

    x0 = make_synthetic_frames(mol, 1024, T0, seed=999, jitter=args.jitter)
    temps_v = np.tile(np.array([float(T0), float(T1)], np.float32), (len(x0), 1))
    cd_of = {"f32": None, "bf16": torch.bfloat16, "bf16_agg": "bf16_agg"}

    def v_fn_of_dtype(name):
        return molecular_v_fn_of(model, params, template, compute_dtype=cd_of[name], device=dev)

    traj_drift = None
    if args.traj_impl != "default":
        from ti_torch.ops.pair_layer_kernel import pair_kernel_drift

        traj_drift = pair_kernel_drift(
            model, params, template,
            compute_dtype="bf16_agg" if args.traj_impl.endswith("bf16") else None, device=dev)

    debias = bool(args.probe_debias)

    def div_drift_for(div, k, pm, want_var):
        if args.div_impl == "default":
            return None
        from ti_torch.ops.pair_tangent_kernel import pair_tangent_div_fn

        if div == "exact":
            k, pm = 3 * N, "orthogonal"  # full frame = exact trace
        return pair_tangent_div_fn(
            model, params, template, num_probes=k, probe_mode=pm,
            compute_dtype="bf16_agg" if args.div_impl.endswith("bf16") else None,
            return_var=want_var, device=dev)

    last_var = {}

    def transport(n_steps, quad, dtype_name="f32", divergence=None, num_probes=None,
                  probe_mode=None, seed=None):
        div = divergence or args.divergence
        kk = num_probes or args.num_probes
        pm = probe_mode or args.probe_mode
        want_var = debias and quad and div == "hutchinson"
        sampler = make_ode_sampler(
            v_fn_of_dtype(dtype_name), solver=args.solver, n_steps=n_steps, n_save=2,
            return_dlogp=True, divergence=div, num_probes=kk, steps_per_dispatch=16,
            dlogp_quad_points=(args.gl_points if quad else None), dlogp_quad="gauss",
            probe_crn=args.probe_crn, probe_mode=pm,
            traj_drift=traj_drift if quad else None,
            div_drift=div_drift_for(div, kk, pm, want_var) if quad else None,
            return_dlogp_var=want_var, device=dev,
        )
        bs = args.eval_batch or len(x0)
        xs, lps, lpvars = [], [], []
        for i in range(0, len(x0), bs):
            gen = torch.Generator(device=dev).manual_seed(
                args.eval_seed if seed is None else seed)
            sol = sampler(x0[i: i + bs], temps_v[i: i + bs], gen)
            xs.append(sol.xs[:, -1].cpu().numpy())
            lps.append(sol.dlogp[:, -1].cpu().numpy())
            if want_var:
                lpvars.append(sol.dlogp_var[:, -1].cpu().numpy())
        last_var["var"] = np.concatenate(lpvars) if want_var else None
        return np.concatenate(xs), np.concatenate(lps)

    headline_dtype = args.compute_dtype if args.compute_dtype in ("bf16", "bf16_agg") else "f32"
    x1, dlogp = transport(args.eval_steps[0], args.quad_dlogp, headline_dtype)
    dlogp_var = last_var["var"]
    # step-count study on the same trained field: the oracle error per step
    # count (stderr; the headline uses [0])
    extra = {ns: transport(ns, args.quad_dlogp, headline_dtype) for ns in args.eval_steps[1:]}

    p_eq = (mol.positions - mol.positions.mean(0)).astype(np.float32)
    d_eff = 3 * (N - 1)
    width = oracles.rms_width(x1, d_eff, p_eq)
    e0 = oracles.well_energy(x0, sigma(T0), p_eq)
    dF_exact = oracles.tfep_dF_exact(N, sigma(T0), sigma(T1))

    def phis_of(x1_a, dlogp_a):  # phi = u1 - u0 + dlogp (reference convention)
        return oracles.well_energy(x1_a, sigma(T1), p_eq) - e0 + dlogp_a

    def oracle_row(x1_a, dlogp_a):
        phis_a = phis_of(x1_a, dlogp_a)
        return (abs(oracles.neg_log_mean_exp(-phis_a) - dF_exact),
                oracles.ess_of_log_w(-phis_a) / len(x1_a))

    phis = phis_of(x1, dlogp)
    dF_est = oracles.neg_log_mean_exp(-phis)
    ess = oracles.ess_of_log_w(-phis)

    for ns, (x1_s, dlogp_s) in extra.items():
        print(f"[step-study] n_steps={ns}: dF_abs_err={oracle_row(x1_s, dlogp_s)[0]:.2e}, "
              f"dlogp_mean_shift={float(np.mean(dlogp_s - dlogp)):.2e}", file=sys.stderr)

    dtype_report = {}
    for name in {"both": ["bf16"], "all": ["bf16", "bf16_agg"]}.get(args.compute_dtype, []):
        x1_b, dlogp_b = transport(args.eval_steps[0], args.quad_dlogp, name)
        dtype_report.update({
            f"dF_abs_err_{name}": oracle_row(x1_b, dlogp_b)[0],
            f"dlogp_mean_shift_{name}": float(np.mean(dlogp_b - dlogp)),
            f"dlogp_rms_shift_{name}": float(np.sqrt(np.mean((dlogp_b - dlogp) ** 2))),
            f"x1_rms_shift_{name}": float(np.sqrt(np.mean((x1_b - x1) ** 2))),
        })

    if args.probe_sweep:
        for combo in args.probe_sweep.split(","):
            mode, k, seed = combo.split(":")
            div = "exact" if mode == "exact" else "hutchinson"
            x1_s, dlogp_s = transport(args.eval_steps[0], args.quad_dlogp, headline_dtype,
                                      divergence=div, num_probes=int(k),
                                      probe_mode=mode if div == "hutchinson" else None,
                                      seed=int(seed))
            err_s, ess_s = oracle_row(x1_s, dlogp_s)
            print(json.dumps({"sweep_mode": mode, "K": int(k), "seed": int(seed),
                              "dF_abs_err": err_s, "ess_frac": ess_s}), flush=True)

    sde_report = {}
    if args.sde_g:
        from scipy import stats

        from ti_torch.sampling.drivers import sample_molecular_sde

        # closed form: with COM removed, e1 = |x1c - p_eq|^2 / (2 sigma1^2) is a
        # sum of 3(N-1) squared standard normals / 2 ~ Gamma(3(N-1)/2, 1)
        gamma_cdf = stats.gamma(d_eff / 2.0).cdf
        for gval in args.sde_g:
            bs = args.eval_batch or len(x0)
            outs = []
            for i in range(0, len(x0), bs):
                out = sample_molecular_sde(
                    model, params, template, x0[i: i + bs], temps_v[i: i + bs],
                    torch.Generator(device=dev).manual_seed(7 + i), g_fn=gval,
                    n_steps=args.sde_steps, compute_dtype=cd_of[headline_dtype], device=dev)
                outs.append(out[:, -1].cpu().numpy())
            x1_sde = np.concatenate(outs)
            w_s = oracles.rms_width(x1_sde, d_eff, p_eq)
            ks = float(stats.kstest(oracles.well_energy(x1_sde, sigma(T1), p_eq),
                                    gamma_cdf).statistic)
            tag = f"{gval:g}"
            sde_report[f"sde_g{tag}_width"] = w_s
            sde_report[f"sde_g{tag}_ks_energy"] = ks
            print(f"[sde-study] g={gval:g} steps={args.sde_steps}: width={w_s:.4f} "
                  f"(target {sigma(T1):.4f}), KS(e1)={ks:.4f}", file=sys.stderr)
        # the ODE route's yardstick on the same samples
        sde_report["ode_ks_energy"] = float(stats.kstest(
            oracles.well_energy(x1, sigma(T1), p_eq), gamma_cdf).statistic)

    debias_report = {}
    if dlogp_var is not None:
        # log-normal probe-noise debias: phi + var/2 makes E[e^{-phi}]
        # unbiased when the probe noise is ~N(0, var), independent of the sample
        phis_c = phis + 0.5 * dlogp_var
        debias_report = {
            "dF_abs_err_debiased": abs(oracles.neg_log_mean_exp(-phis_c) - dF_exact),
            "ess_frac_debiased": oracles.ess_of_log_w(-phis_c) / len(x1),
            "dlogp_var_mean": float(dlogp_var.mean()),
        }

    print(json.dumps({
        "width": width, "width_target": sigma(T1), "width_start": sigma(T0),
        "dlogp_mean": float(dlogp.mean()),
        "dlogp_expected": float(3 * (N - 1) * np.log(sigma(T0) / sigma(T1))),
        "dF_est": dF_est, "dF_exact": dF_exact,
        "dF_abs_err": abs(dF_est - dF_exact),
        "ess": ess, "ess_frac": ess / len(x1),
        "eval_steps": args.eval_steps[0],
        "solver": args.solver,
        "quad_dlogp": bool(args.quad_dlogp),
        "traj_impl": args.traj_impl,
        "div_impl": args.div_impl,
        "divergence": args.divergence,
        "compute_dtype": headline_dtype,
        "train_temps": train_T,
        "extrapolated_T1": T1 not in train_T,
        **dtype_report,
        **sde_report,
        **debias_report,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
