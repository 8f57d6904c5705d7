"""Chip smoke test of the PyTorch port (ti_torch) on one NVIDIA H100.

Builds the hand-written CUDA kernels from ti_torch/csrc, holds each against
its plain PyTorch version at the main path's shapes, runs the main path —
MDQM9 ambient transport with dlogp under ``fast_profile`` at the 00031
width (19 atoms, F = 128, 5 message layers, 128 chains) — through
``ti_torch.sampling.drivers.sample_ambient``, checks what comes out, and
shows that the path went through the kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. the card, TF32 off, the kernel build (seconds, ``-Xptxas -v``);
  2. kernel B1 (pair layer) against its plain version, f32 and bf16_agg;
  3. kernel B3 (pair tangent) at K = 16 bf16_agg and K = 57 f32;
  4. the exact slice (full orthogonal frame) against the same sampler
     built from the plain versions: samples rtol 1e-4 / atol 1e-5,
     dlogp rtol 1e-3 (atol 1e-3 x max |dlogp| for chains near 0);
  5. the slice as users run it (``fast_profile``), artifacts written to a
     temporary directory, launch counts and samples/s;
  6. the ``kernels`` line, the card line and the result line.

Exits with code 2 when no CUDA card is available.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_ATOMS, F, LAYERS, CHAINS, LENGTH_SCALE = 19, 128, 5, 128, 10.0
H100_FP32 = 67e12     # FLOP/s, f32 outside the tensor cores (data sheet, 700 W)
H100_BF16 = 989e12    # FLOP/s, dense bf16 tensor cores
H100_HBM = 3.35e12    # bytes/s
BAR = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # max |kernel - plain| / max |plain|


def log(*a):
    print(*a, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, n: int, warm: int = 2) -> float:
    """Mean device time of ``fn`` over n calls, CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def compare(outs, refs, dtype, what: str) -> float:
    """Max abs error over the outputs; fails past the scaled bar."""
    worst_abs, worst_rel = 0.0, 0.0
    for a, r in zip(outs, refs):
        require(a.shape == r.shape and a.dtype == r.dtype, f"{what}: output shape/dtype")
        require(bool(torch.isfinite(a.float()).all()), f"{what}: finite outputs")
        err = (a.float() - r.float()).abs().max().item()
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / max(r.float().abs().max().item(), 1e-30))
    log(f"[{what}] max abs err {worst_abs:.3e}, max err / max |plain| {worst_rel:.3e} "
        f"(bar {BAR[dtype]:g})")
    require(worst_rel <= BAR[dtype], f"{what}: kernel disagrees with its plain version")
    return worst_abs


def layer_inputs(params, dtype, k: int, seed: int):
    from ti_torch.ops.pair_layer_kernel import pack_layer

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")).to(dtype)

    b, n = CHAINS, N_ATOMS
    w = pack_layer(params, 0, F, dtype, "cuda")
    x = 0.3 * torch.randn(b, n, 3, generator=g, device="cuda")
    base = (x, rnd(b, n, F), rnd(b, 3, n, F, scale=0.3), rnd(b, n * n, F))
    lanes = (torch.randn(b, k, n, 3, generator=g, device="cuda"), rnd(b, k, n, F, scale=0.1),
             rnd(b, k, 3, n, F, scale=0.1), rnd(b, k, n * n, F, scale=0.1))
    return w, base, lanes


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(flops: float, peak: float, moved: int):
    t_ops, t_bytes = flops / peak, moved / H100_HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ti_torch.config import ambient_preset, fast_profile
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops import _build
    from ti_torch.ops.pair_layer_kernel import pair_kernel_drift, pair_layer, pair_layer_plain
    from ti_torch.ops.pair_tangent_kernel import (
        pair_tangent,
        pair_tangent_div_fn,
        pair_tangent_plain,
    )
    from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of, sample_ambient

    t_start = time.perf_counter()
    # ---- 1. card, precision flags, build ----
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[flags] torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    report = _build.build_all(force=True)
    for name, r in report.items():
        log(f"[build] {name}: {r['seconds']:.1f} s (nvcc, sm_90a, parallel)")
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build]   {line.strip()}")

    torch.manual_seed(0)
    model = CPaiNN(F, LAYERS, n_atoms=N_ATOMS)
    params = {k: t.detach() for k, t in model.state_dict().items()}
    mac_row = 15 * F * F  # message-MLP multiply-adds per pair row (phi 8F², w 7F²)
    rows = CHAINS * N_ATOMS * N_ATOMS
    rows_kernels = {}

    # ---- 2. B1 against its plain version ----
    for dtype in (torch.float32, torch.bfloat16):
        w, base, _ = layer_inputs(params, dtype, 0, seed=1)
        out = pair_layer(*base, w, LENGTH_SCALE)
        torch.cuda.synchronize()
        err = compare(out, pair_layer_plain(*base, w, LENGTH_SCALE), dtype,
                      f"B1 pair_layer {dtype} B={CHAINS}")
        ms = cuda_ms(lambda: pair_layer(*base, w, LENGTH_SCALE), 20)
        plain = cuda_ms(lambda: pair_layer_plain(*base, w, LENGTH_SCALE), 10)
        moved = nbytes(*base, w.mats, w.vecs, *out)
        bnd, by = bound_ms(2.0 * mac_row * rows, H100_FP32 if dtype == torch.float32 else H100_BF16,
                           moved)
        log(f"[B1 {dtype}] kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms ({by})")
        if dtype == torch.float32:  # the main path's trajectory profile
            rows_kernels["pair_layer"] = dict(err=err, ms=ms, plain=plain, bound=bnd, by=by)

    # ---- 3. B3 against its plain version ----
    for dtype, k, lane_block in ((torch.bfloat16, 16, 4), (torch.float32, 3 * N_ATOMS, 1)):
        w, base, lanes = layer_inputs(params, dtype, k, seed=2)
        out = pair_tangent(*base, *lanes, w, LENGTH_SCALE, lane_block)
        torch.cuda.synchronize()
        err = compare(out, pair_tangent_plain(*base, *lanes, w, LENGTH_SCALE, lane_block), dtype,
                      f"B3 pair_tangent {dtype} K={k} L={lane_block}")
        reps = 5 if k <= 16 else 2
        ms = cuda_ms(lambda: pair_tangent(*base, *lanes, w, LENGTH_SCALE, lane_block), reps, warm=1)
        plain = cuda_ms(lambda: pair_tangent_plain(*base, *lanes, w, LENGTH_SCALE, lane_block),
                        reps, warm=1)
        moved = nbytes(*base, *lanes, w.mats, w.vecs, *out)
        bnd, by = bound_ms(2.0 * mac_row * rows * (1 + k),
                           H100_FP32 if dtype == torch.float32 else H100_BF16, moved)
        log(f"[B3 {dtype} K={k} L={lane_block}] kernel {ms:.3f} ms, plain {plain:.3f} ms, "
            f"bound {bnd:.4f} ms ({by})")
        if dtype == torch.bfloat16:  # the main path's divergence profile
            rows_kernels["pair_tangent"] = dict(err=err, ms=ms, plain=plain, bound=bnd, by=by)
        del w, base, lanes, out
        torch.cuda.empty_cache()

    # ---- 4. the exact slice against the plain-version sampler ----
    mol = make_synthetic_molecule(N_ATOMS, seed=0)
    template = graph_template(mol, t_cond=2)
    rng = np.random.default_rng(1)
    x0 = (0.1 * rng.standard_normal((2 * CHAINS, N_ATOMS, 3))).astype(np.float32)
    x0 -= x0.mean(axis=1, keepdims=True)
    cfg_exact = fast_profile(ambient_preset("00031"), divergence="exact",
                             div_forward_impl="pair_tangent")
    require((cfg_exact.n_features, cfg_exact.traj_forward_impl) == (F, "pair_kernel"),
            "fast_profile at 00031")
    t0 = time.perf_counter()
    exact = sample_ambient(cfg_exact, model, None, template, x0[:CHAINS], save=False,
                           batch_size=CHAINS, device="cuda")
    t_exact = time.perf_counter() - t0
    plain_sampler = make_ode_sampler(
        molecular_v_fn_of(model, None, template, device="cuda"),
        solver=cfg_exact.solver_type, n_steps=cfg_exact.n_steps, n_save=2,
        divergence="exact", steps_per_dispatch=cfg_exact.steps_per_dispatch,
        dlogp_quad_points=cfg_exact.dlogp_quad_points, dlogp_quad="gauss",
        traj_drift=pair_kernel_drift(model, None, template, device="cuda", kernel=False),
        div_drift=pair_tangent_div_fn(model, None, template, num_probes=3 * N_ATOMS,
                                      probe_mode="orthogonal", device="cuda", kernel=False),
        device="cuda",
    )
    temps = np.tile(np.array([cfg_exact.sampling_T0, cfg_exact.sampling_T1], np.float32),
                    (CHAINS, 1))
    t0 = time.perf_counter()
    ref = plain_sampler(x0[:CHAINS], temps, torch.Generator(device="cuda").manual_seed(0))
    t_plain = time.perf_counter() - t0
    ref_samples = ref.xs.cpu().numpy()
    ref_dlogp = ref.dlogp[:, -1].cpu().numpy()
    require(exact["samples"].shape == (CHAINS, 2, N_ATOMS, 3), "exact slice: samples shape")
    require(np.isfinite(exact["samples"]).all() and np.isfinite(exact["dlogps"]).all(),
            "exact slice: finite")
    s_err = float(np.max(np.abs(exact["samples"] - ref_samples)))
    d_err = float(np.max(np.abs(exact["dlogps"] - ref_dlogp)))
    d_atol = 1e-3 * float(np.max(np.abs(ref_dlogp)))
    log(f"[slice exact] kernels {t_exact:.2f} s, plain versions {t_plain:.2f} s; samples max abs "
        f"err {s_err:.3e}, dlogp max abs err {d_err:.3e} (max |dlogp| {np.max(np.abs(ref_dlogp)):.4f}); "
        f"dlogp mean {exact['dlogps'].mean():.5f}")
    require(np.allclose(exact["samples"], ref_samples, rtol=1e-4, atol=1e-5),
            "exact slice: samples agree with the plain versions (rtol 1e-4, atol 1e-5)")
    require(np.allclose(exact["dlogps"], ref_dlogp, rtol=1e-3, atol=d_atol),
            "exact slice: dlogp agrees with the plain versions (rtol 1e-3, atol 1e-3 max|dlogp|)")

    # ---- 5. the slice as users run it ----
    cfg = fast_profile(ambient_preset("00031"))
    require((cfg.traj_forward_impl, cfg.div_forward_impl, cfg.num_probes, cfg.probe_mode)
            == ("pair_kernel", "pair_tangent_bf16", 16, "orthogonal"), "fast_profile route")
    with tempfile.TemporaryDirectory() as tmp:
        cfg.data_save_path = tmp
        sample_ambient(cfg, model, None, template, x0[:CHAINS], save=False,
                       batch_size=CHAINS, device="cuda")  # warm-up, not counted
        n_batches = len(x0) // CHAINS
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = sample_ambient(cfg, model, None, template, x0, save=True, batch_size=CHAINS,
                             device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        saved = sorted(os.listdir(tmp))
    log(f"[slice fast_profile] {len(x0)} chains in {n_batches} batches of {CHAINS}: {wall:.3f} s, "
        f"{len(x0) / wall:.3f} samples/s (host clock, {card}); launches {launches}; "
        f"artifacts {saved}")
    gaps = 1 + cfg.dlogp_quad_points  # GL-8: 9 trajectory gaps, one RK4 step each
    stages = {"rk4": 4}[cfg.solver_type]
    want = {"pair_layer": n_batches * gaps * stages * LAYERS,
            "pair_tangent": n_batches * cfg.dlogp_quad_points * LAYERS}
    require(launches == want, f"launch counts {launches} == {want}")
    require(out["samples"].shape == (len(x0), 2, N_ATOMS, 3) and out["dlogps"].shape == (len(x0),),
            "fast slice: output shapes")
    require(np.isfinite(out["samples"]).all() and np.isfinite(out["dlogps"]).all(),
            "fast slice: finite samples and dlogp")
    require(np.allclose(out["samples"][:CHAINS], exact["samples"], rtol=1e-6, atol=1e-7),
            "fast slice: the f32 pair-kernel trajectory repeats the exact run's")
    require(len(saved) == 4, "fast slice: samples/dlogps/latent artifacts written")
    diff = out["dlogps"][:CHAINS] - exact["dlogps"]
    log(f"[slice fast_profile] dlogp (orthogonal-16, bf16_agg) minus exact: mean {diff.mean():.5f}, "
        f"rms {math.sqrt(float((diff ** 2).mean())):.5f}")

    # ---- 6. result lines ----
    sources = {"pair_layer": ("ti_torch/csrc/pair_layer.cu", "ti_tpu/ops/pair_layer_kernel.py:83"),
               "pair_tangent": ("ti_torch/csrc/pair_tangent.cu",
                                "ti_tpu/ops/pair_tangent_kernel.py:76")}
    kernels = []
    for name, r in rows_kernels.items():
        src, replaces = sources[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain"], "bound_ms": r["bound"], "bound_by": r["by"],
                        "library_ms": None})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
