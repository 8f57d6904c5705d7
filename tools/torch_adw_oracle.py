"""The ADW physics on fields the port trains, on one CUDA card.

The port's counterpart of tests/test_adw_physics.py and of the paper's
lambda_2-vs-beta experiment (BASELINE.md, "Production-scale ADW kinetics
run"). The script

1. (physics) trains ``FCNetMultiBeta`` 64 x 3 with ``train_adw`` on the
   card at tests/test_adw_physics.py's configuration (40k exact samples at
   beta 1.0 and 1.25, 50 epochs of batch 1024, lr 1e-3, no decay),
   transports 4,000 fresh beta0 samples by stage-coupled RK4-128 with the
   exact divergence, and reports that file's five checks: the KS distance
   to the beta1 Boltzmann CDF (< 0.06), |dF_TFEP - dF_quadrature| (< 0.05)
   and ESS (> 20%), the round trip of 500 chains (x and dlogp within 1e-3),
   and the p99 error of Simpson-17/33 and GL-6/10 dlogp against the
   stage-coupled one (Simpson-33 < 5e-3, GL-10 < 1e-2, each no worse than
   its coarser rule);
2. (production) trains the published 5 x 256 field for 120 epochs (batch
   512, lr 1e-4, decay 1e-5) on the 300k-sample dataset from beta 1.0 to
   {1.25, 1.5, 1.75, 2.0}, transports 3,000 test chains a beta with
   ``sample_adw`` on RK4-64 + GL-8, and runs ``reweighted_gedmd_spectrum``
   and ``direct_reweighted_gedmd_spectrum`` (1,000 bootstraps each); checks
   that lambda_2 (index 2 of the negated nev = 4 spectrum) falls with beta
   and that the TI and direct 95% intervals of lambda_2 overlap at every
   beta; reports TFEP dF against quadrature and ESS at every beta. Beside
   the checks it reports what lambda_2 depends on: the spectra of the whole
   30,000-chain test split (200 bootstraps) and of each of its disjoint
   sets of 3,000 chains (with how many of them the check's intervals
   overlap on), of the first 3,000 on the stage-coupled exact route
   (RK4-64), and the barrier's population (|x| < 0.5) among the
   transported samples, raw and weighted, against the quadrature's.

    python3 tools/torch_adw_oracle.py [--epochs 120] [--out chiprun_out/adw_oracle] [--reuse]

Every stage reports its seconds, the trainers their ms a step (host clock
over the median epoch, with the validation pass and the checkpoint). The
last line of standard output is one JSON object with every number; it is
also written to ``--out``/oracle.json, beside both fields' weights
(``physics_weights.npz``, ``production_weights.npz``), which ``--reuse``
evaluates instead of training. Exits 1 when a check fails, 2 with no card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BETA0 = 1.0
PRODUCTION_BETAS = (1.25, 1.5, 1.75, 2.0)
EV_INDEX = 2  # lambda_2 in the nev = 4 layout (scripts/adw_plots.py)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


class EpochClock:
    """A ``MetricLogger`` stand-in that keeps the wall clock at every
    epoch's end and prints every tenth epoch."""

    def __init__(self):
        self.stamps = [time.perf_counter()]

    def log(self, metrics, step=None):
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        if step is None or step % 10 == 0:
            print(f"[train] epoch {step}: " + " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()), flush=True)

    def finish(self):
        pass


def train(cfg, base, target, weights: str, reuse: bool) -> tuple:
    """``train_adw`` on the card, its weights saved to ``weights``; or with
    ``reuse`` the field those weights hold. (model, params, numbers)."""
    from ti_torch.train import build_adw_model, load_checkpoint, save_checkpoint, train_adw

    if reuse:
        params = {k: v.cuda() for k, v in load_checkpoint(weights).items()}
        return build_adw_model(cfg).cuda(), params, {"reused": weights}
    clock = EpochClock()
    t0 = time.perf_counter()
    res = train_adw(cfg, base, target, logger=clock)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = res["state"].count // cfg.epochs
    epoch_s = np.diff(clock.stamps)[1:]  # the first epoch pays the warm-up
    ms = 1e3 * float(np.median(epoch_s)) / steps
    save_checkpoint(weights, res["params"])
    return res["model"], res["params"], {
        "seconds": wall, "epochs": cfg.epochs, "steps_per_epoch": steps,
        "ms_per_step_median_epoch": ms, "samples_per_s": cfg.batch_size / ms * 1e3,
        "final_train_loss": res["history"]["train_loss"][-1],
        "final_val_loss": res["history"]["val_loss"][-1],
        "nan_steps": res["state"].nan_count, "final_lr": res["state"].lr}


def tfep(x0, x1, dlogp, beta1, pot):
    """(dF estimate, ESS fraction) of transport beta0 -> beta1."""
    from ti_torch.analysis.weights import calc_ess

    log_w = BETA0 * np.asarray(pot(x0)) - beta1 * np.asarray(pot(x1)) - dlogp
    mx = log_w.max()
    return (float(-(mx + np.log(np.mean(np.exp(log_w - mx))))),
            float(calc_ess(np.exp(log_w - mx)) / len(x0)))


def physics(tmp: str, card: str, out_dir: str, reuse: bool) -> tuple:
    """Part 1: tests/test_adw_physics.py's five checks; (numbers, fails)."""
    from ti_torch.analysis.potentials import (
        AsymmetricDoubleWell,
        BoltzmannDensity1D,
        delta_f_quadrature,
    )
    from ti_torch.config import ADWConfig
    from ti_torch.data.adw import ADWDataset, make_synthetic_adw_csv
    from ti_torch.sampling.drivers import adw_v_fn_of
    from ti_torch.sampling.integrators import (
        sample_ode,
        sample_ode_gauss_dlogp,
        sample_ode_quad_dlogp,
    )

    beta1, pot = 1.25, AsymmetricDoubleWell()
    csv = make_synthetic_adw_csv(os.path.join(tmp, "physics.csv"), betas=[BETA0, beta1],
                                 n_samples=40_000)
    cfg = ADWConfig(n_samples=40_000, hidden_size=64, num_layers=3, epochs=50, lr=1e-3, wd=0.0,
                    batch_size=1024, a=0.9, model_save_path=os.path.join(tmp, "physics"),
                    use_wandb=False)
    model, params, out = train(cfg, ADWDataset.from_csv(csv, [BETA0], cfg.n_samples),
                               ADWDataset.from_csv(csv, [beta1], cfg.n_samples),
                               os.path.join(out_dir, "physics_weights.npz"), reuse)
    print(f"[physics train] {json.dumps(out)} ({card})", flush=True)

    x0 = BoltzmannDensity1D(BETA0, pot).sample(123, 4000).astype(np.float32)
    x = torch.from_numpy(x0)[:, None].cuda()

    def v(n):
        conds = torch.tensor([[BETA0, beta1]], device="cuda").expand(n, 2)
        return adw_v_fn_of(model, params)(conds)

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = sample_ode(v(len(x0)), x, n_steps=128, method="rk4", return_dlogp=True)
        torch.cuda.synchronize()
        out["rk4_128_exact_seconds"] = time.perf_counter() - t0
        x1, dlogp = sol.xs[:, -1, 0].cpu().numpy(), sol.dlogp[:, -1].cpu().numpy()
        back = sample_ode(v(500), sol.xs[:500, -1], t0=1.0, t1=0.0, n_steps=128, method="rk4",
                          return_dlogp=True)
        quad = {}
        for rule, pts in (("simpson", 17), ("simpson", 33), ("gauss", 6), ("gauss", 10)):
            if rule == "simpson":
                q = sample_ode_quad_dlogp(v(1000), x[:1000], n_steps=128, div_points=pts,
                                          method="rk4")
            else:
                q = sample_ode_gauss_dlogp(v(1000), x[:1000], n_steps=128, gl_points=pts,
                                           method="rk4")
            err = np.abs(q.dlogp[:, -1].cpu().numpy() - dlogp[:1000])
            quad[f"{rule}_{pts}"] = {"p99": float(np.percentile(err, 99)),
                                     "max": float(err.max())}

    xs = np.linspace(-4, 4, 4000)
    cdf = np.cumsum(BoltzmannDensity1D(beta1, pot).pdf(xs))
    grid = np.linspace(-2.0, 2.0, 201)
    ks = float(np.max(np.abs(np.searchsorted(np.sort(x1), grid) / len(x1)
                             - np.interp(grid, xs, cdf / cdf[-1]))))
    dF, ess = tfep(x0, x1, dlogp, beta1, pot)
    dF_exact = delta_f_quadrature(BETA0, beta1, pot)
    rt_x = float(np.abs(back.xs[:, -1, 0].cpu().numpy() - x0[:500]).max())
    rt_l = float(np.abs(dlogp[:500] + back.dlogp[:, -1].cpu().numpy()).max())
    out.update(ks=ks, dF=dF, dF_exact=dF_exact, dF_err=abs(dF - dF_exact), ess=ess,
               round_trip_x=rt_x, round_trip_dlogp=rt_l, quadrature=quad)
    checks = {
        "KS < 0.06": ks < 0.06,
        "|dF err| < 0.05": abs(dF - dF_exact) < 0.05,
        "ESS > 20%": ess > 0.2,
        "round trip within 1e-3": rt_x <= 1e-3 and rt_l <= 1e-3,
        "Simpson-33 p99 < 5e-3, max < 5e-2, no worse than Simpson-17":
            quad["simpson_33"]["p99"] < 5e-3 and quad["simpson_33"]["max"] < 5e-2
            and quad["simpson_33"]["p99"] <= quad["simpson_17"]["p99"] + 1e-5,
        "GL-10 p99 < 1e-2, max < 5e-2, no worse than GL-6":
            quad["gauss_10"]["p99"] < 1e-2 and quad["gauss_10"]["max"] < 5e-2
            and quad["gauss_10"]["p99"] <= quad["gauss_6"]["p99"] + 1e-5,
    }
    out["checks"] = checks
    print(f"[physics] KS {ks:.4f}; dF {dF:.5f} vs quadrature {dF_exact:.5f} (|err| "
          f"{abs(dF - dF_exact):.5f}), ESS {100 * ess:.2f}%; round trip x {rt_x:.2e}, dlogp "
          f"{rt_l:.2e}; quadrature dlogp p99/max {quad}; checks {checks}", flush=True)
    return out, [k for k, ok in checks.items() if not ok]


def barrier_share(x, w=None, half_width: float = 0.5) -> float:
    """The (weighted) share of samples with |x| < half_width."""
    w = np.ones_like(x) if w is None else w
    return float(np.sum(w * (np.abs(x) < half_width)) / np.sum(w))


def production(tmp: str, card: str, out_dir: str, reuse: bool, epochs: int, chains: int,
               n_bootstrap: int) -> tuple:
    """Part 2: the lambda_2-vs-beta experiment; (numbers, fails)."""
    from ti_torch.analysis.potentials import (
        AsymmetricDoubleWell,
        BoltzmannDensity1D,
        delta_f_quadrature,
    )
    from ti_torch.analysis.reweight import (
        calculate_weights,
        direct_reweighted_gedmd_spectrum,
        reweighted_gedmd_spectrum,
    )
    from ti_torch.config import ADWConfig
    from ti_torch.data.adw import ADWDataset, make_synthetic_adw_csv
    from ti_torch.gedmd.rff import sample_rff_gaussian
    from ti_torch.sampling.drivers import sample_adw

    cfg = ADWConfig(epochs=epochs, beta1s=list(PRODUCTION_BETAS), traj_path=tmp,
                    model_save_path=os.path.join(tmp, "production"),
                    data_save_path=os.path.join(tmp, "outputs"), use_wandb=False)
    t0 = time.perf_counter()
    csv = make_synthetic_adw_csv(os.path.join(tmp, cfg.traj_filename),
                                 betas=[BETA0, *PRODUCTION_BETAS], n_samples=cfg.n_samples)
    base = ADWDataset.from_csv(csv, cfg.beta0s, cfg.n_samples, seed=cfg.seed)
    target = ADWDataset.from_csv(csv, cfg.beta1s, cfg.n_samples, seed=cfg.seed)
    out = {"data_seconds": time.perf_counter() - t0}
    model, params, out["train"] = train(cfg, base, target,
                                        os.path.join(out_dir, "production_weights.npz"), reuse)
    print(f"[production train] {json.dumps(out['train'])} ({card})", flush=True)

    test0 = base.splits()[2]
    omega = sample_rff_gaussian(0, 1, 50, 0.6)  # scripts/adw_reweight_gedmd.py's
    pot = AsymmetricDoubleWell()
    gl8 = dict(solver_type="rk4", n_step=64, dlogp_quad_points=8, dlogp_quad="gauss")

    def transport(beta1, lo, hi, route=gl8):
        sc = ADWConfig(beta1s=[beta1], **route)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = sample_adw(sc, model, params, test0.x[lo:hi], test0.beta[lo:hi, 0], save=False)
        return s, time.perf_counter() - t0

    def lam2(spec):
        return [float(np.real(spec[k][EV_INDEX]))
                for k in ("eigenvalues_mean", "lower_bound", "upper_bound")]

    rows = {}
    for beta1 in PRODUCTION_BETAS:
        s, t_sample = transport(beta1, 0, chains)
        t0 = time.perf_counter()
        ti = reweighted_gedmd_spectrum(s["initial_samples"], s["samples"], s["dlogps"], beta1,
                                       n_bootstrap=n_bootstrap, Omega=omega)
        direct = direct_reweighted_gedmd_spectrum(s["initial_samples"], BETA0, beta1,
                                                  n_bootstrap=n_bootstrap, Omega=omega)
        t_gedmd = time.perf_counter() - t0
        dF, ess = tfep(s["initial_samples"], s["samples"][-1], s["dlogps"][-1], beta1, pot)
        row = {"sample_seconds": t_sample, "samples_per_s": chains / t_sample, "nfe": s["nfe"],
               "gedmd_seconds": t_gedmd, "dF": dF,
               "dF_exact": delta_f_quadrature(BETA0, beta1, pot), "ess": ess,
               "n_filtered": ti["n_filtered"]}
        for name, spec in (("ti", ti), ("direct", direct)):
            row[name] = {k: np.real(spec[k]).tolist()
                         for k in ("eigenvalues_mean", "lower_bound", "upper_bound")}
        # what lambda_2 depends on (reported, not checked)
        grid = np.linspace(-3.0, 3.0, 60001)
        pdf = BoltzmannDensity1D(beta1, pot).pdf(grid)
        x1, w = calculate_weights(s["initial_samples"], s["samples"], s["dlogps"], beta1)
        diag = {"barrier_share_quadrature": float(np.sum(pdf * (np.abs(grid) < 0.5))
                                                  / np.sum(pdf)),
                "barrier_share_transported": barrier_share(x1),
                "barrier_share_weighted": barrier_share(x1, w)}
        sa, _ = transport(beta1, 0, len(test0))
        diag["lambda_2_ti_all_test_chains_200_bootstraps"] = lam2(reweighted_gedmd_spectrum(
            sa["initial_samples"], sa["samples"], sa["dlogps"], beta1, n_bootstrap=200,
            Omega=omega))
        diag["lambda_2_direct_all_test_chains_200_bootstraps"] = lam2(
            direct_reweighted_gedmd_spectrum(sa["initial_samples"], BETA0, beta1,
                                             n_bootstrap=200, Omega=omega))
        # every disjoint set of ``chains`` test chains: how often the check's
        # intervals overlap on this field
        sets = []
        for lo in range(0, len(test0) - chains + 1, chains):
            part = {k: v[..., lo:lo + chains] for k, v in sa.items() if k != "nfe"}
            xs, ws = calculate_weights(part["initial_samples"], part["samples"],
                                       part["dlogps"], beta1)
            sets.append({
                "chains": [lo, lo + chains],
                "ti": lam2(reweighted_gedmd_spectrum(
                    part["initial_samples"], part["samples"], part["dlogps"], beta1,
                    n_bootstrap=n_bootstrap, Omega=omega)),
                "direct": lam2(direct_reweighted_gedmd_spectrum(
                    part["initial_samples"], BETA0, beta1, n_bootstrap=n_bootstrap,
                    Omega=omega)),
                "barrier_share_transported": barrier_share(xs),
                "barrier_share_weighted": barrier_share(xs, ws)})
        diag["disjoint_sets"] = sets
        diag["disjoint_sets_overlapping"] = sum(
            max(d["ti"][1], d["direct"][1]) <= min(d["ti"][2], d["direct"][2]) for d in sets)
        se, _ = transport(beta1, 0, chains, dict(solver_type="rk4", n_step=64))
        diag["lambda_2_ti_stage_coupled_exact"] = lam2(reweighted_gedmd_spectrum(
            se["initial_samples"], se["samples"], se["dlogps"], beta1, n_bootstrap=n_bootstrap,
            Omega=omega))
        diag["dlogp_gl8_minus_exact_max"] = float(np.abs(s["dlogps"][-1]
                                                         - se["dlogps"][-1]).max())
        row["diagnostics"] = diag
        print(f"[production beta {beta1} diagnostics] {json.dumps(diag)}", flush=True)
        rows[beta1] = row
        ti2, dr2 = lam2(ti), lam2(direct)
        print(f"[production beta {beta1}] {chains} chains in {t_sample:.3f} s (RK4-64 GL-8, NFE "
              f"{s['nfe']}), gEDMD {t_gedmd:.1f} s; lambda_2 TI {ti2[0]:.5f} [{ti2[1]:.5f}, "
              f"{ti2[2]:.5f}], direct {dr2[0]:.5f} [{dr2[1]:.5f}, {dr2[2]:.5f}]; dF {dF:.5f} vs "
              f"{row['dF_exact']:.5f}, ESS {100 * ess:.2f}%", flush=True)
    out["betas"] = rows
    lam = [rows[b]["ti"]["eigenvalues_mean"][EV_INDEX] for b in PRODUCTION_BETAS]
    overlap = {b: max(r["ti"]["lower_bound"][EV_INDEX], r["direct"]["lower_bound"][EV_INDEX])
               <= min(r["ti"]["upper_bound"][EV_INDEX], r["direct"]["upper_bound"][EV_INDEX])
               for b, r in rows.items()}
    checks = {"lambda_2 falls with beta": all(a > b for a, b in zip(lam, lam[1:])),
              "TI and direct intervals of lambda_2 overlap at every beta": all(overlap.values())}
    out.update(lambda_2_ti=lam, overlap=overlap, checks=checks)
    print(f"[production] lambda_2 (TI) {lam}; intervals overlap {overlap}; checks {checks}",
          flush=True)
    return out, [k for k, ok in checks.items() if not ok]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=120, help="production training epochs")
    ap.add_argument("--chains", type=int, default=3000, help="test chains a beta")
    ap.add_argument("--n_bootstrap", type=int, default=1000)
    ap.add_argument("--out", default="chiprun_out/adw_oracle")
    ap.add_argument("--reuse", action="store_true",
                    help="evaluate the weights a previous run saved in --out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_adw_oracle: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    result = {"card": card, "args": vars(args)}
    with tempfile.TemporaryDirectory() as tmp:
        result["physics"], fails = physics(tmp, card, args.out, args.reuse)
        result["production"], more = production(tmp, card, args.out, args.reuse, args.epochs,
                                                args.chains, args.n_bootstrap)
    result["failed"] = fails + more
    with open(os.path.join(args.out, "oracle.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(card)
    print(json.dumps(result))
    return 1 if result["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
