"""Phase 19 of chip_smoke.py: the seven study CLIs (ti_torch/cli: adw_plots,
step_count_study, adw_f64_study, probe_mode_study, sde_scan,
large_scale_scan, profile_divergence) on one NVIDIA H100.

``phase_studies(model, template, card)`` runs after phases 2-18, so the
kernel libraries are built. Every CLI runs in this process through
``main(argv)`` at a cut size (``PERF.md`` §4), and the launch counts each
prints are those of one run of each row:

- (a) ``sde_scan`` at 2048 chains, f32 and bf16_agg, ``dense`` and
  ``pair_kernel`` at chain blocks 1 and 4, 20 steps, one timed run after
  the warm-up (``--reps 1``, cut from 2 for the smoke's time): every row a
  finite positive rate; the ``pair_kernel`` rows exactly layers x steps
  launches of B1 (chain block 1) or B2 (4), all from pair_layer_tf32x3
  (f32) or pair_layer_mma (bf16_agg); the ``dense`` rows none;
- (b) ``large_scale_scan`` at the 10506 width (29 atoms, F = 256 x 5), 16
  chains, Hutchinson-32, impls default, pair_kernel and pair_kernel_bf16
  crossed with node impls default and pair_tangent_bf16, ``--reps 1``: every
  row runs at a finite positive rate, ``pair_kernel`` with exactly 360
  launches of pair_layer_tf32x3_f256 a batch and ``pair_kernel_bf16`` 360
  of pair_layer_mma_f256 (72 forwards x 5 layers, as in phase 15), and the
  ``pair_tangent_bf16`` rows exactly 40 launches of B3 from
  pair_tangent_mma_f256 (8 nodes x 5 layers);
- (c) ``profile_divergence`` at 16 chains: every row a finite positive
  time; one fused forward exactly 5 B4 launches (fused_edge_mlp_tf32x3),
  the fully fused forward 5 B4 and 7 B6 (fused_mlp_tf32x3), one
  ``dense_fused`` exact node 10 B4 and 5 B5 (fused_edge_mlp_jvp_tf32x3);
  no other row launches a kernel;
- (d) ``probe_mode_study --keys 8`` on the smoke's field, written as a
  port checkpoint with its arch (``--params``): the orthogonal frame at
  K = d = 3N within 1e-3 rms of the exact trace, every row finite (a
  random-init field with flax's laws has traces of order 1e4 at this
  width, where f32's rounding alone reads 1e-2);
- (e) ``step_count_study`` (5 epochs, 10,000 samples a beta, 1,000 chains,
  RK4 at 8, 16 and 32 steps): finite errors, RK4's NFE 4 a step, the
  summary line;
- (f) ``adw_f64_study`` (3 epochs, 10,000 samples, 2,000 chains, RK4-64):
  f32 and f64 trained on the card, finite dF errors, KS distances and ESS;
- (g) ``adw_plots``: exit 2 where matplotlib is missing (the card's
  machine), else the figure.

The only errors a scan passes over are running out of device memory and
the width refusal; anything else raises here. A rehearsal on the CPU sets
``DEVICE = "cpu"`` and small sizes (``SDE``, ``LARGE``, ``PROFILE_CHAINS``,
``STEP``, ``F64``); the checks that only the card can meet (launch counts)
are then logged as skipped.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import os
import tempfile
import time

import numpy as np

from chip_smoke import log, require

DEVICE = "cuda"
SDE = dict(chains=2048, steps=20, layers=5, extra=[])
LARGE = dict(chains=16, probes=32, layers=5, steps=16, gl_points=8, extra=[])
PROFILE_CHAINS = 16
STEP = ["--epochs", "5", "--n_samples", "10000", "--n_eval", "1000", "--steps", "8", "16", "32"]
F64 = ["--epochs", "3", "--n_train", "10000", "--n", "2000", "--steps", "64"]
PROBE_KEYS = 8


def _card_check(ok: bool, what: str) -> None:
    """A check only the card can meet (its kernels' launches)."""
    if DEVICE == "cpu":
        log(f"[19 rehearsal] skipped on the CPU: {what}")
        return
    require(ok, what)


def _run(main, argv) -> tuple:
    """(exit code, stdout) of a CLI's ``main(argv)`` run here."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = main(argv)
    return rc, text.getvalue()


def _cli(main, argv) -> list:
    """The printed lines of a CLI that must exit 0."""
    rc, out = _run(main, ["--device", DEVICE, *argv])
    require(rc == 0, f"{main.__module__} exits 0 (rc {rc}): {out[-2000:]}")
    return out.strip().splitlines()


def _tagged(lines, tag: str):
    """The JSON after ``tag`` on the last line that starts with it."""
    hits = [line[len(tag):] for line in lines if line.startswith(tag)]
    require(bool(hits), f"a {tag!r} line: {lines[-5:]}")
    return json.loads(hits[-1])


def _rate_ok(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x) and x > 0


def _sde_scan(card: str) -> None:
    """(a): B1 and B2 through sde_scan, f32 and bf16_agg."""
    from ti_torch.cli import sde_scan

    lines = _cli(sde_scan.main, [
        "--chains", str(SDE["chains"]), "--dtypes", "f32,bf16_agg", "--impls",
        "dense,pair_kernel", "--chain_blocks", "1,4", "--steps", str(SDE["steps"]),
        "--reps", "1", "--layers", str(SDE["layers"]), *SDE["extra"]])
    rows = _tagged(lines, "rows: ")
    require(not any("FAILED" in line for line in lines), f"19a: no sde_scan row fails: {lines}")
    require(len(rows) == 6, f"19a: six sde_scan rows: {rows}")
    n = SDE["layers"] * SDE["steps"]
    for r in rows:
        require(_rate_ok(r["samples_per_s"]), f"19a: a finite positive rate: {r}")
        if r["impl"] == "dense":
            want = {}
        else:
            lib = "pair_layer_tf32x3" if r["dtype"] == "f32" else "pair_layer_mma"
            want = {f"{'pair_layer' if r['chain_block'] == 1 else 'pair_layer_cb'}:{lib}": n}
        _card_check(r["launches"] == want, f"19a: {r['dtype']}/{r['impl']}/cb{r['chain_block']} "
                                          f"launches {want} a run: {r['launches']}")
        log(f"[19a sde_scan] {r['chains']} chains {r['dtype']}/{r['impl']}/cb{r['chain_block']}: "
            f"{r['samples_per_s']:.3f} samples/s (host clock, one run, {card}); launches "
            f"{r['launches']}")


def _large_scale_scan(card: str) -> None:
    """(b): the 10506 width; B1 at F = 256 runs in both types, B3 in bf16_agg."""
    from ti_torch.cli import large_scale_scan

    lines = _cli(large_scale_scan.main, [
        "--chains", str(LARGE["chains"]), "--probes", str(LARGE["probes"]), "--impls",
        "default,pair_kernel,pair_kernel_bf16", "--div_impls", "default,pair_tangent_bf16",
        "--reps", "1", "--layers", str(LARGE["layers"]), "--steps", str(LARGE["steps"]),
        "--gl_points", str(LARGE["gl_points"]), *LARGE["extra"]])
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    require(len(rows) == 6, f"19b: six large_scale_scan rows: {lines}")
    gaps = LARGE["gl_points"] + 1
    forwards = gaps * min(25, -(-LARGE["steps"] // gaps)) * 4  # RK4 steps a gap, 4 stages
    for r in rows:
        require("error" not in r, f"19b: {r['impl']}/{r['div_impl']} runs: {r}")
        require(_rate_ok(r["samples_per_sec"]), f"19b: a finite positive rate: {r}")
        lib = {"pair_kernel": "pair_layer_tf32x3_f256",
               "pair_kernel_bf16": "pair_layer_mma_f256"}.get(r["impl"])
        want = {f"pair_layer:{lib}": forwards * LARGE["layers"]} if lib else {}
        if r["div_impl"] == "pair_tangent_bf16":  # a node's 5 layers, GL-8's nodes
            want["pair_tangent:pair_tangent_mma_f256"] = LARGE["gl_points"] * LARGE["layers"]
        _card_check(r["launches"] == want, f"19b: {r['impl']}/{r['div_impl']} launches {want} a "
                                          f"batch: {r['launches']}")
        log(f"[19b large_scale_scan] {r['chains']} chains h-{r['probes']} {r['impl']}/"
            f"{r['div_impl']}: {r['samples_per_sec']:.3f} samples/s (host clock, one run, "
            f"{card}); launches {r['launches']}")


def _profile_divergence(card: str) -> None:
    """(c): B4, B5 and B6 through profile_divergence's fused rows."""
    from ti_torch.cli import profile_divergence

    lines = _cli(profile_divergence.main, [str(PROFILE_CHAINS)])
    prof = _tagged(lines, "rows: ")
    b4, b5, b6 = ("fused_edge_mlp:fused_edge_mlp_tf32x3",
                  "fused_edge_mlp_jvp:fused_edge_mlp_jvp_tf32x3", "fused_mlp:fused_mlp_tf32x3")
    kernel_rows = {"primal fused": {b4: 5}, "primal fused+mlp": {b4: 5, b6: 7},
                   "div fused": {b4: 10, b5: 5}}
    for label, t in prof["ms"].items():
        require(_rate_ok(t), f"19c: {label}: a finite positive time ({t} ms)")
        want = kernel_rows.get(label, {})
        _card_check(prof["launches"][label] == want,
                    f"19c: {label} launches {want} a call: {prof['launches'][label]}")
    for line in lines[:-1]:
        if line.strip():
            log(f"[19c profile_divergence] {line} ({card})")
    log(f"[19c profile_divergence] launches a call {prof['launches']}")


def _probe_mode_study(model, template, root: str, card: str) -> None:
    """(d): the estimators on the smoke's field; the K = d frame is exact."""
    from ti_torch.cli import probe_mode_study
    from ti_torch.models.convert import save_npz

    n = template.n_atoms
    d = 3 * n
    path = os.path.join(root, "field.npz")
    save_npz(path, {k: t.detach().cpu() for k, t in model.state_dict().items()},
             arch={"atoms": n, "features": model.n_features, "layers": model.score_layers,
                   "temp_length": model.temp_length})
    probes = ",".join(str(k) for k in sorted({8, 16, 32, d}))
    lines = _cli(probe_mode_study.main, ["--params", path, "--keys", str(PROBE_KEYS),
                                         "--probes", probes])
    rows = {(r["mode"], r["K"]): r for r in _tagged(lines, "rows: ")}
    require(all(math.isfinite(r["rms_err"]) and math.isfinite(r["bias"]) for r in rows.values()),
            f"19d: finite rows: {rows}")
    exact = rows[("orthogonal", d)]["rms_err"]
    require(exact < 1e-3, f"19d: the orthogonal frame at K = d = {d} is exact within 1e-3 rms "
                          f"({exact:.3e})")
    for line in lines:
        if not line.startswith("rows: "):
            log(f"[19d probe_mode_study] {line}")
    log(f"[19d probe_mode_study] orthogonal K = d = {d}: rms {exact:.3e} against the exact trace "
        f"({card})")


def _step_count_study(card: str) -> None:
    """(e): RK4 against dopri5@1e-5 on an ADW field trained on the card."""
    from ti_torch.cli import step_count_study

    lines = _cli(step_count_study.main, STEP)
    rows = [json.loads(line) for line in lines if line.startswith('{"rk4_steps"')]
    summary = json.loads(lines[-1])
    steps = [int(s) for s in STEP[STEP.index("--steps") + 1:]]
    require([r["rk4_steps"] for r in rows] == steps, f"19e: a row a step count: {rows}")
    for r in rows:
        require(r["nfe"] == 4 * r["rk4_steps"], f"19e: RK4's NFE is 4 a step: {r}")
        errs = [v for k, v in r.items() if "err" in k]
        require(all(math.isfinite(v) for v in errs), f"19e: finite errors: {r}")
        require(("gauss10_nfe" in r) == (r["rk4_steps"] >= 16), f"19e: GL-10 from 16 steps: {r}")
        log(f"[19e step_count_study] {json.dumps(r)}")
    require(summary.get("summary") and summary["rk4_steps"] in steps,
            f"19e: the summary line: {summary}")
    log(f"[19e step_count_study] {json.dumps(summary)} ({card})")


def _adw_f64_study(root: str, card: str) -> None:
    """(f): ADW trained in f32 and f64 on the card, the physics of each."""
    from ti_torch.cli import adw_f64_study

    lines = _cli(adw_f64_study.main, [*F64, "--out", os.path.join(root, "f64")])
    res = json.loads(lines[-1])
    for dtype in ("f32", "f64"):
        r = res[dtype]
        require(all(math.isfinite(r[k]) for k in ("dF_est", "dF_err", "ks", "ess_frac")),
                f"19f: finite {dtype} physics: {r}")
    require(all(math.isfinite(v) for v in res["cross"].values()), f"19f: finite deltas: {res}")
    log(f"[19f adw_f64_study] {lines[-1]} ({card})")


def _adw_plots(root: str) -> None:
    """(g): the figure, or its refusal where matplotlib is missing."""
    from ti_torch.cli import adw_plots

    rng = np.random.default_rng(6)
    path = os.path.join(root, "rw.npz")
    np.savez(path, betas=np.array([1.25, 1.5]), eigenvalues_mean=rng.uniform(0.01, 0.1, (2, 4)),
             lower=rng.uniform(0.005, 0.01, (2, 4)), upper=rng.uniform(0.1, 0.2, (2, 4)))
    out = os.path.join(root, "lambda2.png")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, _ = _run(adw_plots.main, ["--reweighted", path, "--out", out])
    if importlib.util.find_spec("matplotlib") is None:
        require(rc == 2 and "matplotlib is not available" in err.getvalue(),
                f"19g: adw_plots refuses with exit 2 without matplotlib (rc {rc})")
        log("[19g adw_plots] matplotlib is missing here: refused with exit 2")
    else:
        require(rc == 0 and os.path.getsize(out) > 1000, f"19g: adw_plots writes {out}")
        log(f"[19g adw_plots] wrote {out}")


def phase_studies(model, template, card: str) -> dict:
    """19. The study CLIs; returns each step's seconds."""
    import torch

    t_phase = time.perf_counter()
    secs = {}
    with tempfile.TemporaryDirectory() as root:
        for step, fn in (("a", lambda: _sde_scan(card)),
                         ("b", lambda: _large_scale_scan(card)),
                         ("c", lambda: _profile_divergence(card)),
                         ("d", lambda: _probe_mode_study(model, template, root, card)),
                         ("e", lambda: _step_count_study(card)),
                         ("f", lambda: _adw_f64_study(root, card)),
                         ("g", lambda: _adw_plots(root))):
            t0 = time.perf_counter()
            fn()
            if DEVICE == "cuda":
                torch.cuda.synchronize()
            secs[step] = time.perf_counter() - t0
    secs["phase"] = time.perf_counter() - t_phase
    log("[19 studies] " + ", ".join(f"({k}) {v:.3f} s" for k, v in secs.items()) + f" ({card})")
    return secs
