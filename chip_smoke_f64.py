"""Phase 22 of chip_smoke.py: kernels B1/B2 and B3 at F = 64 in f32 and
bf16_agg (libraries pair_layer_tf32x3_f64, pair_layer_mma_f64,
pair_tangent_tf32x3_f64 and pair_tangent_mma_f64: the four tensor-core
sources built with -DPK_F=64), and ``validate_mdqm9_physics`` on its kernel
routes at its own default width, on one NVIDIA H100.

``phase_f64(rows_kernels, report, card)`` runs after phases 2-21, so the
kernel libraries are built (phase 1 holds the four to no register spills):

- (a) the four libraries' registers and spills, as ``-Xptxas -v`` printed
  them; the F = 128 and F = 256 builds of B3 keep the register counts phase
  1 and phase 21 printed (``KEPT_REGS``);
- (b) each kernel against its plain version on the same inputs (max
  |kernel - plain| / max |plain|: bar 2e-5 in f32, 2e-2 in bf16_agg), two
  launches of each equal to the bit, timed in turns with the plain version
  (CUDA events after warm-up: kernel, plain, kernel, plain) beside its bound
  (2 x 15 F^2 x B x N^2 FLOP for B1, x (1 + K) for B3: 989 TFLOP/s bf16, or
  three TF32 passes at 495; or the bytes at 3.35 TB/s, if more). Two shapes:
  the CLI's (N = 4, 1,024 chains, K = 12, the exact frame: the ``kernels``
  line's numbers) and the 00031 molecule's (N = 19, 128 chains; K = 16
  bf16_agg, K = 57 f32). B2 at C = 2, 3 and 4 in both types equal to B1 to
  the bit, and bf16_agg C = 4 timed at the CLI's shape. Ragged shapes: 130
  chains at N = 19 and 29 (the last row tile not full), N = 32 and N = 2,
  B3 lane blocks of 2 and 1 and partial last lane tiles (f32: N = 19, K = 7;
  N = 5, K = 30);
- (c) ``validate_mdqm9_physics`` at its defaults (4 atoms, F = 64 x 3,
  batch 128, 2,048 frames a temperature, 1,024 chains, RK4-64, the exact
  divergence on the Gauss path, ``--quad_dlogp``) with its 300 epochs cut
  to ``EPOCHS`` (``EPOCHS`` x 32 updates): a run on the f32 kernel flags
  (``--traj_impl pair_kernel --div_impl pair_tangent``) that trains the
  field, then ``--reuse`` on the bf16_agg flags and on the default route.
  Each kernel run launches exactly 792 B1 (11 Gauss gaps x 6 RK4 steps x 4
  stages x 3 layers) and 30 B3 (10 nodes x 3 layers), all from the type's
  ``_f64`` libraries; its per-chain samples and dlogps lie within the type's
  bar of the default route's on the same field (f32 samples at rtol 1e-4 /
  atol 1e-5, bf16_agg samples at 2e-2 of max |x|; dlogps at 2e-5 and 2e-2
  of max |dlogp|), and its JSON within phase 20's closed-form bars (|dF
  err| < 0.2, ESS > 2%, the dlogp mean 0.4-1.6x the volume change). Then
  the SDE on the trained field through B2 (``sample_molecular_sde(
  forward_impl="pair_kernel", chain_block=4)``, bf16_agg, 1,024 chains,
  ``SDE_STEPS`` steps: exactly ``SDE_STEPS`` x 3 launches of
  pair_layer_mma_f64).

Returns (c)'s launch counts by ``kernels``-line name.

Run alone (builds what it needs, then (a)-(c)):

    python3 chip_smoke_f64.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from chip_smoke import (
    BAR,
    H100_BF16,
    H100_TF32,
    LENGTH_SCALE,
    bound_ms,
    card_line,
    compare,
    cuda_ms,
    layer_inputs,
    log,
    nbytes,
    ptxas_kernels,
    require,
    torch_default_weights_,
)

F64 = 64
LAYER_LIBS = {torch.float32: "pair_layer_tf32x3_f64", torch.bfloat16: "pair_layer_mma_f64"}
TANGENT_LIBS = {torch.float32: "pair_tangent_tf32x3_f64", torch.bfloat16: "pair_tangent_mma_f64"}
LAYER_NAMES = {torch.float32: "pair_layer_f64", torch.bfloat16: "pair_layer_bf16_agg_f64"}
TANGENT_NAMES = {torch.float32: "pair_tangent_f32_f64", torch.bfloat16: "pair_tangent_bf16_agg_f64"}
# the F = 128 and F = 256 builds of B3, registers a thread as phases 1 and 21
# printed them (PERF.md section 6)
KEPT_REGS = {"pair_tangent_mma": 246, "pair_tangent_tf32x3": 248, "pair_tangent_mma_f256": 242,
             "pair_tangent_tf32x3_f256": 254}
CLI_N, CLI_CHAINS, CLI_LAYERS = 4, 1024, 3  # validate_mdqm9_physics's defaults
CLI_K = 3 * CLI_N                           # its exact divergence: the full orthogonal frame
WIDE_N, WIDE_CHAINS, K_BF16, K_F32 = 19, 128, 16, 57  # the 00031 molecule, the main path's batch
# of the CLI's 300 epochs: 32 updates an epoch (2 x 2,048 frames at batch 128),
# host-paced at 80-95 ms each. The dlogp mean read 0.415x the volume change
# after 8 epochs (its bar is 0.4x) and 0.650x after 20 (PERF.md section 6)
EPOCHS = 14
SDE_STEPS = 20
# GL-10 over one save interval: 11 gaps of ceil(64 / 11) RK4 steps, 10 nodes
GAUSS_GAPS, RK4_STEPS, GL_NODES = 11, 6, 10


def _dtype_name(dtype) -> str:
    return "bf16_agg" if dtype == torch.bfloat16 else "f32"


def _bound(flops: float, dtype, moved: int):
    if dtype == torch.bfloat16:
        return (*bound_ms(flops, H100_BF16, moved), f"{flops:.4e} FLOP at 989 TFLOP/s bf16")
    return (*bound_ms(3 * flops, H100_TF32, moved), f"3 x {flops:.4e} FLOP at 495 TFLOP/s TF32")


def _timed(what: str, lib: str, run, plain, flops: float, dtype, moved: int, card: str,
           n: int = 20) -> dict:
    """Kernel and plain version in turns, beside the bound."""
    ms, plain_ms = [], []
    for _ in range(2):  # in turns: kernel, plain, kernel, plain
        ms.append(cuda_ms(run, n, warm=2))
        plain_ms.append(cuda_ms(plain, 3, warm=1))
    bnd, by, peak = _bound(flops, dtype, moved)
    log(f"[22b {what}] {lib} {' and '.join(f'{t:.4f}' for t in ms)} ms per launch ({n} launches "
        f"a reading, in turns with the plain version's "
        f"{' and '.join(f'{t:.4f}' for t in plain_ms)} ms); bound {bnd:.4f} ms ({by}, {peak}, "
        f"{moved / 1e6:.2f} MB), at {min(ms) / bnd:.2f}x its bound ({card})")
    return dict(ms=min(ms), plain=min(plain_ms), bound=bnd, by=by)


def _layer(params, dtype, b: int, n: int, seed: int, chain_blocks=(), time_it=False,
           card: str = "") -> dict:
    """B1 against its plain version and a second launch to the bit; B2 at
    each of ``chain_blocks`` equal to B1 to the bit; with ``time_it`` B1's
    time in turns beside its bound."""
    from ti_torch.ops import _build
    from ti_torch.ops.pair_layer_kernel import pair_layer, pair_layer_plain

    w, base, _ = layer_inputs(params, dtype, 0, seed, b, n, F64)
    lib = LAYER_LIBS[dtype]
    what = f"B1 {_dtype_name(dtype)} F={F64} B={b} N={n}"
    _build.reset_launches()
    out = pair_layer(*base, w, LENGTH_SCALE)
    again = pair_layer(*base, w, LENGTH_SCALE)
    torch.cuda.synchronize()
    require(_build.route_counts() == {f"pair_layer:{lib}": 2},
            f"{what}: both launches from {lib}: {_build.route_counts()}")
    require(all(torch.equal(a, q) for a, q in zip(out, again)),
            f"{what}: two launches agree to the bit")
    err = compare(out, pair_layer_plain(*base, w, LENGTH_SCALE), dtype, what)
    for c in chain_blocks:
        _build.reset_launches()
        cb = pair_layer(*base, w, LENGTH_SCALE, c)
        torch.cuda.synchronize()
        require(_build.route_counts() == {f"pair_layer_cb:{lib}": 1},
                f"B2 C={c}: launched from {lib}: {_build.route_counts()}")
        require(all(torch.equal(a, q) for a, q in zip(cb, out)),
                f"{what}: B2 at C = {c} equals B1 to the bit")
    if chain_blocks:
        log(f"[22b {what}] B2 at C = {', '.join(map(str, chain_blocks))} equal to B1 to the bit")
    if not time_it:
        return dict(err=err)
    flops = 2.0 * 15 * F64 * F64 * b * n * n
    moved = nbytes(*base, w.mats, w.vecs, *out)
    return dict(err=err, **_timed(what, lib, lambda: pair_layer(*base, w, LENGTH_SCALE),
                                  lambda: pair_layer_plain(*base, w, LENGTH_SCALE), flops, dtype,
                                  moved, card))


def _b2_timed(params, dtype, b: int, n: int, c: int, seed: int, card: str) -> dict:
    """B2 at chain block c against its plain version, timed beside its bound."""
    from ti_torch.ops.pair_layer_kernel import pair_layer, pair_layer_plain

    w, base, _ = layer_inputs(params, dtype, 0, seed, b, n, F64)
    what = f"B2 {_dtype_name(dtype)} F={F64} B={b} N={n} C={c}"
    out = pair_layer(*base, w, LENGTH_SCALE, c)
    torch.cuda.synchronize()
    err = compare(out, pair_layer_plain(*base, w, LENGTH_SCALE), dtype, what)
    flops = 2.0 * 15 * F64 * F64 * b * n * n
    moved = nbytes(*base, w.mats, w.vecs, *out)
    return dict(err=err, **_timed(what, LAYER_LIBS[dtype],
                                  lambda: pair_layer(*base, w, LENGTH_SCALE, c),
                                  lambda: pair_layer_plain(*base, w, LENGTH_SCALE), flops, dtype,
                                  moved, card))


def _tangent(params, dtype, b: int, n: int, k: int, seed: int, lane_block=None, time_it=False,
             card: str = "") -> dict:
    """B3 against its plain version, a second launch to the bit, and with
    ``time_it`` the times in turns and the bound."""
    from ti_torch.ops import _build
    from ti_torch.ops.pair_tangent_kernel import pair_tangent, pair_tangent_plain

    w, base, lanes = layer_inputs(params, dtype, k, seed, b, n, F64)
    lib = TANGENT_LIBS[dtype]
    what = f"B3 {_dtype_name(dtype)} F={F64} B={b} N={n} K={k}"
    if lane_block:
        what += f" L={lane_block}"
    _build.reset_launches()
    out = pair_tangent(*base, *lanes, w, LENGTH_SCALE, lane_block)
    again = pair_tangent(*base, *lanes, w, LENGTH_SCALE, lane_block)
    torch.cuda.synchronize()
    require(_build.route_counts() == {f"pair_tangent:{lib}": 2},
            f"{what}: both launches from {lib}: {_build.route_counts()}")
    require(all(torch.equal(a, q) for a, q in zip(out, again)),
            f"{what}: two launches agree to the bit")
    plain_lb = lane_block or (4 if dtype == torch.bfloat16 and k % 4 == 0 else 1)

    def plain():
        return pair_tangent_plain(*base, *lanes, w, LENGTH_SCALE, plain_lb)

    err = compare(out, plain(), dtype, what)
    if not time_it:
        return dict(err=err)
    flops = 2.0 * 15 * F64 * F64 * (1 + k) * b * n * n
    moved = nbytes(*base, *lanes, w.mats, w.vecs, *out)
    return dict(err=err, **_timed(what, lib,
                                  lambda: pair_tangent(*base, *lanes, w, LENGTH_SCALE, lane_block),
                                  plain, flops, dtype, moved, card, n=5))


def registers(report) -> None:
    """(a): the four libraries and the kept B3 builds."""
    for lib in (*LAYER_LIBS.values(), *TANGENT_LIBS.values()):
        found = ptxas_kernels(report[lib]["ptxas"])
        require(bool(found), f"{lib}: -Xptxas -v reported its kernels")
        for fn, regs, spill in found:
            log(f"[22a {lib} build] {fn}: {regs}; {spill}")
            require("0 bytes spill stores, 0 bytes spill loads" in spill,
                    f"{lib} builds without register spills: {spill}")
    for lib, want in KEPT_REGS.items():
        found = ptxas_kernels(report[lib]["ptxas"])
        used = [int(regs.split("Used ")[1].split(" registers")[0]) for _, regs, _ in found]
        log(f"[22a {lib} build] {used} registers a thread (before the F = 64 build: {want})")
        require(used == [want], f"{lib} keeps {want} registers a thread: {used}")


def kernels_f64(rows_kernels, card: str) -> None:
    """(b): every F = 64 kernel against its plain version, timed at the CLI's
    shape (the kernels line) and at the 00031 molecule's."""
    from ti_torch.models.cpainn import CPaiNN

    model = torch_default_weights_(CPaiNN(F64, 1, n_atoms=WIDE_N))
    params = {k: t.detach() for k, t in model.state_dict().items()}
    bf, f32 = torch.bfloat16, torch.float32
    for dtype in (f32, bf):
        rows_kernels[LAYER_NAMES[dtype]] = _layer(params, dtype, CLI_CHAINS, CLI_N, 41,
                                                  (2, 3, 4), time_it=True, card=card)
        _layer(params, dtype, WIDE_CHAINS, WIDE_N, 42, (2, 3, 4), time_it=True, card=card)
        rows_kernels[TANGENT_NAMES[dtype]] = _tangent(params, dtype, CLI_CHAINS, CLI_N, CLI_K, 43,
                                                      time_it=True, card=card)
        _tangent(params, dtype, WIDE_CHAINS, WIDE_N, K_BF16 if dtype == bf else K_F32, 44,
                 time_it=True, card=card)
    rows_kernels["pair_layer_cb_f64"] = _b2_timed(params, bf, CLI_CHAINS, CLI_N, 4, 45, card)
    for dtype in (f32, bf):  # ragged: the last row tile not full; the widest and narrowest N
        _layer(params, dtype, 130, WIDE_N, 46, (3,))
        _layer(params, dtype, 130, 29, 47, (4,))
        _layer(params, dtype, 5, 32, 48, (2,))
        _layer(params, dtype, 7, 2, 49, (4,))
        _tangent(params, dtype, 130, CLI_N, 8, 50)
        _tangent(params, dtype, 3, 32, 4, 51)
        _tangent(params, dtype, 3, 2, 6, 52)
    for lane_block in (2, 1):  # K = 6 in blocks of 2 and of 1
        _tangent(params, bf, 5, WIDE_N, 6, 53, lane_block)
    _tangent(params, f32, 5, WIDE_N, 7, 54)  # 6 lanes a tile: the last tile 1 lane
    _tangent(params, f32, 3, 5, 30, 55)      # 25 lanes a tile: the last tile 5 lanes
    torch.cuda.empty_cache()


def validate_cli(root: str, card: str) -> dict:
    """(c): the CLI at its own width on both kernel routes and the default
    route, one field; then the SDE on that field through B2."""
    from chip_smoke_validate import _cli
    from ti_torch.cli import validate_mdqm9_physics
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.convert import load_npz_arch
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops import _build
    from ti_torch.sampling import drivers

    out_dir = os.path.join(root, "mdqm9_f64")
    real, seen = drivers.make_ode_sampler, []

    def make_ode_sampler(*a, **kw):
        sampler = real(*a, **kw)

        def run(*b, **bk):
            sol = sampler(*b, **bk)
            seen.append([t.cpu().numpy() for t in (sol.xs[:, -1], sol.dlogp[:, -1])])
            return sol

        return run

    routes = (("f32", ["--traj_impl", "pair_kernel", "--div_impl", "pair_tangent"]),
              ("bf16_agg", ["--reuse", "--traj_impl", "pair_kernel_bf16", "--div_impl",
                            "pair_tangent_bf16"]),
              ("default", ["--reuse"]))
    layer_launches = GAUSS_GAPS * RK4_STEPS * 4 * CLI_LAYERS
    node_launches = GL_NODES * CLI_LAYERS
    want = {"f32": {f"pair_layer:{LAYER_LIBS[torch.float32]}": layer_launches,
                    f"pair_tangent:{TANGENT_LIBS[torch.float32]}": node_launches},
            "bf16_agg": {f"pair_layer:{LAYER_LIBS[torch.bfloat16]}": layer_launches,
                         f"pair_tangent:{TANGENT_LIBS[torch.bfloat16]}": node_launches},
            "default": {}}
    rows, got = {}, {}
    drivers.make_ode_sampler = make_ode_sampler
    try:
        for name, flags in routes:
            _build.reset_launches()
            t0 = time.perf_counter()
            rows[name] = _cli(validate_mdqm9_physics.main, ["--epochs", str(EPOCHS), "--quad_dlogp",
                                                            "--out_dir", out_dir, *flags])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = _build.route_counts()
            got[name] = seen[-1]
            log(f"[22c validate_mdqm9_physics {name}] 4 atoms, F = 64 x 3, 1024 chains"
                f"{', trained ' + str(EPOCHS) + ' epochs' if name == 'f32' else ' (--reuse)'}: "
                f"{secs:.1f} s; launches {counts}; {json.dumps(rows[name])} ({card})")
            require(counts == want[name], f"22c {name}: launches {counts} == {want[name]}")
    finally:
        drivers.make_ode_sampler = real
    require(len(seen) == 3, f"22c: one transport a run ({len(seen)})")
    xd, dd = got["default"]
    for name, dtype in (("f32", torch.float32), ("bf16_agg", torch.bfloat16)):
        row = rows[name]
        require(row["dF_abs_err"] < 0.2 and row["ess_frac"] > 0.02,
                f"22c {name}: |dF err| {row['dF_abs_err']:.4f} < 0.2 and ESS "
                f"{row['ess_frac']:.4f} > 2%")
        require(0.4 * row["dlogp_expected"] < row["dlogp_mean"] < 1.6 * row["dlogp_expected"],
                f"22c {name}: dlogp mean {row['dlogp_mean']:.4f} within 0.4-1.6x the volume "
                f"change {row['dlogp_expected']:.4f}")
        xk, dk = got[name]
        x_err = float(np.max(np.abs(xk - xd)))
        x_rel = x_err / float(np.max(np.abs(xd)))
        d_rel = float(np.max(np.abs(dk - dd)) / np.max(np.abs(dd)))
        log(f"[22c {name} kernel route] against the default route on the same field: samples "
            f"max abs {x_err:.3e} ({x_rel:.3e} of max |x|), dlogps {d_rel:.3e} of max |dlogp| "
            f"(bar {BAR[dtype]:g})")
        if dtype == torch.float32:
            np.testing.assert_allclose(xk, xd, rtol=1e-4, atol=1e-5)
        else:
            require(x_rel <= BAR[dtype], f"22c {name}: samples within {BAR[dtype]:g} of max |x|")
        require(d_rel <= BAR[dtype], f"22c {name}: dlogps within {BAR[dtype]:g} of max |dlogp|")

    # the SDE on the trained field through B2 (bf16_agg, C = 4)
    state, arch = load_npz_arch(os.path.join(out_dir, "oracle_params.npz"))
    model = CPaiNN(F64, CLI_LAYERS, n_atoms=CLI_N, temp_length=float(arch["temp_length"]),
                   conditioning="ambient").cuda()
    params = {k: torch.as_tensor(v).cuda() for k, v in state.items()}
    template = graph_template(make_synthetic_molecule(CLI_N, seed=0), t_cond=2)
    rng = np.random.default_rng(22)
    x0 = (0.1 * rng.standard_normal((CLI_CHAINS, CLI_N, 3))).astype(np.float32)
    x0 -= x0.mean(axis=1, keepdims=True)
    temps = np.tile(np.array([1000.0, 300.0], np.float32), (CLI_CHAINS, 1))

    def sde():
        return drivers.sample_molecular_sde(
            model, params, template, x0, temps, torch.Generator(device="cuda").manual_seed(5),
            g_fn=0.1, n_steps=SDE_STEPS, compute_dtype="bf16_agg", forward_impl="pair_kernel",
            chain_block=4, device="cuda")

    sde()  # warm-up, not counted
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    xs = sde()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _build.route_counts()
    want_sde = {f"pair_layer_cb:{LAYER_LIBS[torch.bfloat16]}": SDE_STEPS * CLI_LAYERS}
    xs = xs.cpu().numpy()
    com = np.max(np.abs(xs.mean(axis=2)), axis=(0, 2))
    log(f"[22c SDE] 1024 chains, F = 64 x 3, bf16_agg, C = 4, {SDE_STEPS} steps: {secs:.3f} s, "
        f"{CLI_CHAINS / secs:.1f} samples/s (host clock, {card}); launches {counts}; max |centre "
        f"of mass| at t0 {com[0]:.2e}, at t1 {com[1]:.2e} (the field's drift moves it)")
    require(counts == want_sde, f"22c SDE: launches {counts} == {want_sde}")
    require(xs.shape == (CLI_CHAINS, 2, CLI_N, 3) and np.isfinite(xs).all() and com[0] <= 1e-6,
            "22c SDE: finite samples of the expected shape from centred frames")
    return {LAYER_NAMES[torch.float32]: layer_launches,
            TANGENT_NAMES[torch.float32]: node_launches,
            LAYER_NAMES[torch.bfloat16]: layer_launches,
            TANGENT_NAMES[torch.bfloat16]: node_launches,
            "pair_layer_cb_f64": SDE_STEPS * CLI_LAYERS}


def phase_f64(rows_kernels, report, card: str) -> dict:
    """22. (a)-(c) above; returns (c)'s launch counts by kernels-line name."""
    t_phase = time.perf_counter()
    secs = {}
    registers(report)
    t0 = time.perf_counter()
    kernels_f64(rows_kernels, card)
    secs["b"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        launches = validate_cli(root, card)
        secs["c"] = time.perf_counter() - t0
    secs["phase"] = time.perf_counter() - t_phase
    log("[22 f64] " + ", ".join(f"({k}) {v:.1f} s" for k, v in secs.items()) + f" ({card})")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke_f64: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ti_torch.ops import _build

    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    report = _build.build_all((*LAYER_LIBS.values(), *TANGENT_LIBS.values(), *KEPT_REGS),
                              force=True)
    log(f"[build] {len(report)} libraries in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, "
        f"parallel)")
    rows = {}
    launches = phase_f64(rows, report, card)
    for name, r in rows.items():
        log(f"[22 {name}] launches {launches.get(name)}, max abs err {r['err']:.3e}, "
            f"{r.get('ms', float('nan')):.4f} ms (plain {r.get('plain', float('nan')):.4f}, bound "
            f"{r.get('bound', float('nan')):.4f}, {r.get('by')})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
