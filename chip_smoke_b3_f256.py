"""Phase 21 of chip_smoke.py: kernel B3 at F = 256 in bf16_agg (library
pair_tangent_mma_f256, csrc/pair_tangent_mma.cu built with -DPK_F=256) and in
f32 (pair_tangent_tf32x3_f256, csrc/pair_tangent_tf32x3.cu built with
-DPK_F=256), and the 10506 divergence nodes through them, on one NVIDIA
H100.

``phase_b3_f256(rows_kernels, report, card)`` runs after phases 2-20, so
the kernel libraries are built (phase 1 holds both to no register spills):

- (a) both libraries' registers and spills, as ``-Xptxas -v`` printed them;
- (b) each kernel against its plain version on the same inputs (max
  |kernel - plain| / max |plain|: bar 2e-2 in bf16_agg, 2e-5 in f32) at the
  10506 node shape (16 chains, N = 29, K = 32; bf16_agg at lane block 2),
  timed in turns with the plain version (CUDA events after warm-up: kernel,
  plain, kernel, plain) beside its bound (2 x 15 F^2 x (1 + K) x B x N^2
  FLOP: 0.8827 ms at 989 TFLOP/s bf16, 5.29 ms as three TF32 passes at 495;
  or the bytes, if more); f32 also at the exact frame (K = 87 = 3N); two
  launches of each agree to the bit; then ragged shapes: 17 chains; N = 32
  and N = 17; K = 6 at lane blocks 2 and 1 (bf16_agg); partial last lane
  tiles (f32: N = 10, K = 7 and N = 16, K = 5);
- (c) ``sample_ambient(fast_profile(ambient_preset("10506"),
  div_forward_impl=...))`` at 16 chains, two batches, with
  ``"pair_tangent_bf16"`` and then ``"pair_tangent"``, each after a warm-up
  batch: exactly 360 B1 launches (pair_layer_mma_f256) and 40 B3 launches
  (8 Gauss-Legendre nodes x 5 layers) from the type's ``_f256`` library a
  batch; samples equal to the bit to the default node route's (the same
  trajectory: the nodes do not feed it), run in the same call; the first
  batch's dlogps against the same sampler with B3's plain version at the
  nodes (``pair_tangent_div_fn(kernel=False)``) on the same probes, within
  the type's bar of max |dlogp| (2e-2 bf16_agg, 2e-5 f32); each route's
  samples/s beside the default route's (host clock);
- (d) is phase 19(b)'s: ``large_scale_scan``'s node rows at F = 256 run
  through pair_tangent_mma_f256 (chip_smoke_studies.py).

Returns (c)'s launch counts: {"pair_tangent_bf16_agg_f256": n,
"pair_tangent_f32_f256": n} (two batches each).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from chip_smoke import (
    BAR,
    H100_BF16,
    H100_TF32,
    LENGTH_SCALE,
    bound_ms,
    compare,
    cuda_ms,
    layer_inputs,
    log,
    nbytes,
    ptxas_kernels,
    require,
    torch_default_weights_,
    zero_com_x0,
)

N256, F256, LAYERS, B = 29, 256, 5, 16
LIBS = {torch.bfloat16: "pair_tangent_mma_f256", torch.float32: "pair_tangent_tf32x3_f256"}
NAMES = {torch.bfloat16: "pair_tangent_bf16_agg_f256", torch.float32: "pair_tangent_f32_f256"}


def _check(params, dtype, b: int, n: int, k: int, seed: int, lane_block=None, time_it=False,
           card: str = "") -> dict:
    """One launch against the plain version, a second to the bit, and with
    ``time_it`` the times in turns and the bound."""
    from ti_torch.ops import _build
    from ti_torch.ops.pair_tangent_kernel import pair_tangent, pair_tangent_plain

    w, base, lanes = layer_inputs(params, dtype, k, seed, b, n, F256)
    what = f"B3 {'bf16_agg' if dtype == torch.bfloat16 else 'f32'} F={F256} B={b} N={n} K={k}"
    if lane_block:
        what += f" L={lane_block}"
    _build.reset_launches()
    out = pair_tangent(*base, *lanes, w, LENGTH_SCALE, lane_block)
    again = pair_tangent(*base, *lanes, w, LENGTH_SCALE, lane_block)
    torch.cuda.synchronize()
    require(_build.route_counts() == {f"pair_tangent:{LIBS[dtype]}": 2},
            f"{what}: both launches from {LIBS[dtype]}: {_build.route_counts()}")
    require(all(torch.equal(a, q) for a, q in zip(out, again)),
            f"{what}: two launches agree to the bit")
    plain_lb = lane_block or (2 if dtype == torch.bfloat16 else 1)

    def plain():
        return pair_tangent_plain(*base, *lanes, w, LENGTH_SCALE, plain_lb)

    err = compare(out, plain(), dtype, what)
    if not time_it:
        return {}
    ms, plain_ms = [], []
    for _ in range(2):  # in turns: kernel, plain, kernel, plain
        ms.append(cuda_ms(lambda: pair_tangent(*base, *lanes, w, LENGTH_SCALE, lane_block), 5,
                          warm=1))
        plain_ms.append(cuda_ms(plain, 2, warm=1))
    flops = 2.0 * 15 * F256 * F256 * (1 + k) * b * n * n
    moved = nbytes(*base, *lanes, w.mats, w.vecs, *out)
    if dtype == torch.bfloat16:
        bnd, by = bound_ms(flops, H100_BF16, moved)
        peak = f"{flops:.4e} FLOP at 989 TFLOP/s bf16"
    else:
        bnd, by = bound_ms(3 * flops, H100_TF32, moved)
        peak = f"3 x {flops:.4e} FLOP at 495 TFLOP/s TF32"
    log(f"[{what}] {LIBS[dtype]} {' and '.join(f'{t:.4f}' for t in ms)} ms per launch (5 "
        f"launches a reading, in turns with the plain version's "
        f"{' and '.join(f'{t:.4f}' for t in plain_ms)} ms); bound {bnd:.4f} ms ({by}, {peak}, "
        f"{moved / 1e6:.2f} MB), at {min(ms) / bnd:.2f}x its bound ({card})")
    return dict(err=err, ms=min(ms), plain=min(plain_ms), bound=bnd, by=by)


def kernels_b3_f256(rows_kernels, card: str) -> None:
    """(b): both types against their plain versions, timed at the node shape."""
    from ti_torch.models.cpainn import CPaiNN

    model = torch_default_weights_(CPaiNN(F256, 1, n_atoms=N256))
    params = {k: t.detach() for k, t in model.state_dict().items()}
    bf, f32 = torch.bfloat16, torch.float32
    rows_kernels[NAMES[bf]] = _check(params, bf, B, N256, 32, 31, time_it=True, card=card)
    rows_kernels[NAMES[f32]] = _check(params, f32, B, N256, 32, 32, time_it=True, card=card)
    _check(params, f32, B, N256, 3 * N256, 33)  # the exact frame
    for dtype in (bf, f32):  # ragged: 17 chains, N = 32 and 17
        _check(params, dtype, 17, N256, 8, 34)
        _check(params, dtype, 3, 32, 4, 35)
        _check(params, dtype, 3, 17, 4, 36)
    for lane_block in (2, 1):  # K = 6 in blocks of 2 and of 1
        _check(params, bf, 3, N256, 6, 37, lane_block)
    _check(params, f32, 3, 10, 7, 38)  # 3 lanes a tile: the last tile 1 lane
    _check(params, f32, 3, 16, 5, 39)  # 2 lanes a tile: the last tile 1 lane
    torch.cuda.empty_cache()


def profile_nodes(card: str) -> dict:
    """(c): the 10506 fast profile with B3 at its nodes, both types."""
    from ti_torch.config import ambient_preset, fast_profile
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops import _build
    from ti_torch.ops.pair_layer_kernel import pair_kernel_drift
    from ti_torch.ops.pair_tangent_kernel import pair_tangent_div_fn
    from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of, sample_ambient

    model = torch_default_weights_(CPaiNN(F256, LAYERS, n_atoms=N256))
    template = graph_template(make_synthetic_molecule(N256, seed=0), t_cond=2)
    x0 = zero_com_x0(np.random.default_rng(21), 2 * B, N256)

    def run(impl: str, warm: bool):
        cfg = fast_profile(ambient_preset("10506"), div_forward_impl=impl)
        if warm:
            sample_ambient(cfg, model, None, template, x0[:B], save=False, batch_size=B,
                           device="cuda")
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = sample_ambient(cfg, model, None, template, x0, save=False, batch_size=B,
                             device="cuda")
        torch.cuda.synchronize()
        return cfg, out, time.perf_counter() - t0, _build.route_counts()

    cfg, ref, ref_wall, ref_routes = run("default", warm=False)  # phase 15 warmed this route
    gaps = 1 + cfg.dlogp_quad_points
    traj = 2 * gaps * -(-cfg.n_steps // gaps) * 4 * LAYERS  # two batches: 72 forwards x 5 layers
    nodes = 2 * cfg.dlogp_quad_points * LAYERS  # two batches: 8 nodes x 5 layers
    require(ref_routes == {"pair_layer:pair_layer_mma_f256": traj},
            f"the default node route launches B1 only: {ref_routes}")
    log(f"[21c 10506 default nodes] {2 * B} chains in 2 batches of {B}: {ref_wall:.3f} s, "
        f"{2 * B / ref_wall:.3f} samples/s (host clock, {card})")
    temps = np.tile(np.array([cfg.sampling_T0, cfg.sampling_T1], np.float32), (B, 1))
    launches = {}
    for impl, dtype, cd in (("pair_tangent_bf16", torch.bfloat16, "bf16_agg"),
                            ("pair_tangent", torch.float32, None)):
        cfg, out, wall, routes = run(impl, warm=True)
        want = {"pair_layer:pair_layer_mma_f256": traj, f"pair_tangent:{LIBS[dtype]}": nodes}
        log(f"[21c 10506 {impl} nodes] {2 * B} chains in 2 batches of {B}: {wall:.3f} s, "
            f"{2 * B / wall:.3f} samples/s against the default nodes' {2 * B / ref_wall:.3f} "
            f"(host clock, {card}); launches by library {routes}")
        require(routes == want, f"{impl}: launches by library {routes} == {want}")
        require(out["samples"].shape == ref["samples"].shape
                and np.isfinite(out["samples"]).all() and np.isfinite(out["dlogps"]).all(),
                f"{impl}: finite samples and dlogps of the expected shape")
        require(np.array_equal(out["samples"], ref["samples"]),
                f"{impl}: samples equal to the bit to the default node route's")
        # the first batch again, B3's plain version at the nodes, the same probes
        plain = make_ode_sampler(
            molecular_v_fn_of(model, None, template, compute_dtype=cfg.compute_dtype,
                              device="cuda"),
            solver=cfg.solver_type, n_steps=cfg.n_steps, n_save=2, divergence=cfg.divergence,
            steps_per_dispatch=cfg.steps_per_dispatch, dlogp_quad_points=cfg.dlogp_quad_points,
            dlogp_quad="gauss", num_probes=cfg.num_probes, probe_mode=cfg.probe_mode,
            traj_drift=pair_kernel_drift(model, None, template, compute_dtype="bf16_agg",
                                         device="cuda"),
            div_drift=pair_tangent_div_fn(model, None, template, num_probes=cfg.num_probes,
                                          probe_mode=cfg.probe_mode, compute_dtype=cd,
                                          device="cuda", kernel=False),
            device="cuda",
        )(x0[:B], temps, torch.Generator(device="cuda").manual_seed(int(cfg.seed)))
        pd = plain.dlogp[:, -1].cpu().numpy()
        px = plain.xs.cpu().numpy()
        d_err = float(np.max(np.abs(out["dlogps"][:B] - pd)))
        scale = float(np.max(np.abs(pd)))
        x_same = np.array_equal(px, out["samples"][:B])
        log(f"[21c 10506 {impl} nodes] first batch against B3's plain version at the nodes, "
            f"same probes: dlogp max abs {d_err:.3e} (max |dlogp| {scale:.4f}, ratio "
            f"{d_err / scale:.3e}, bar {BAR[dtype]:g}); samples equal to the bit "
            f"{x_same}; dlogp mean {out['dlogps'].mean():.5f} against the default nodes' "
            f"{ref['dlogps'].mean():.5f}")
        require(x_same, f"{impl}: the plain-node route's samples equal the kernel route's")
        require(d_err <= BAR[dtype] * scale,
                f"{impl}: dlogps within {BAR[dtype]:g} of max |dlogp| of the plain nodes'")
        launches[NAMES[dtype]] = routes[f"pair_tangent:{LIBS[dtype]}"]
        del out, plain
        torch.cuda.empty_cache()
    return launches


def phase_b3_f256(rows_kernels, report, card: str) -> dict:
    """21. (a)-(c) above; returns (c)'s B3 launch counts by kernels-line name."""
    t_phase = time.perf_counter()
    for lib in LIBS.values():
        for fn, regs, spill in ptxas_kernels(report[lib]["ptxas"]):
            log(f"[21a {lib} build] {fn}: {regs}; {spill}")
    kernels_b3_f256(rows_kernels, card)
    launches = profile_nodes(card)
    log(f"[21] phase {time.perf_counter() - t_phase:.1f} s")
    return launches
