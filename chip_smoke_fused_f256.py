"""Phase 23 of chip_smoke.py: kernels B4, B5 and B6 at F = 256 (libraries
fused_edge_mlp_tf32x3_f256, fused_edge_mlp_jvp_tf32x3_f256 and
fused_mlp_tf32x3_f256: csrc/fused_edge_mlp_tf32x3.cu,
csrc/fused_edge_mlp_jvp_tf32x3.cu and csrc/fused_mlp_tf32x3.cu built with
-DPK_F=256), and the fused-MLP paths on the 10506 model (29 atoms, F = 256,
5 layers), on one NVIDIA H100.

``phase_fused_f256(rows_kernels, report, card)`` runs after phases 2-22, so
the kernel libraries are built (phase 1 holds all three to no register
spills):

- (a) the three libraries' registers and spills as ``-Xptxas -v`` printed
  them, and their shared memory, tile rows and CTAs an SM against the
  wrappers'; each kernel against its plain version on the same inputs (max
  |kernel - plain| / max |plain|, bar 2e-5) at the 10506 shapes, timed in
  turns with the plain version (CUDA events after warm-up: kernel, plain,
  kernel, plain) beside its bound (max of the FLOPs as three TF32 passes
  at 495 TFLOP/s and the bytes at 3.35 TB/s): B4 at 13,456 dense pair rows
  (16 chains x 29^2, the ``dense_fused`` sampler's launches) and 12,992
  edge rows (``fused_velocity_fn``'s), B5 at K = 32 over 13,456 rows (the
  sampler's Hutchinson-32 nodes) and K = 87 over 3,364 rows (the exact
  divergence at 4 chains), B6 on the combine (4F -> F), update (2F -> 3F)
  and readout (F -> 2) MLPs at 464 node rows; two launches of each agree
  to the bit; then ragged shapes (B4 R = 1, 31, 33, 1,007; B5 R = 5, K = 1
  and R = 65, K = 3; B6 R = 1, 17 and the latent combine, 3F -> F);
- (b) ``fused_velocity_fn`` at 16 chains against ``dense_velocity_fn``
  (rtol 1e-4, atol 1e-5): 5 B4 launches from fused_edge_mlp_tf32x3_f256
  and 7 B6 from fused_mlp_tf32x3_f256 a forward, ms a forward of both;
- (c) the ``dense_fused`` sampler at the 10506 fast profile's settings in
  f32 at 16 chains (RK4-16, GL-8, Rademacher Hutchinson-32) against
  ``impl="dense"`` on the same probes: dlogp rtol 1e-3 / atol 1e-3 of max
  |dlogp| (phase 9's bar); the samples, whose f32 routes part on a few
  chains of this field along the RK4 steps (phase 20), no farther from the
  same trajectory in f64 than twice the dense f32 route's (the chains past
  phase 9's rtol 1e-4 / atol 1e-5 are counted); 88 forwards x 5 =
  440 B4 launches from fused_edge_mlp_tf32x3_f256 and 8 nodes x 5 = 40 B5
  from fused_edge_mlp_jvp_tf32x3_f256; samples/s of both routes (host
  clock);
- (d) the exact divergence (87 lanes, one node at t = 0.5) through
  ``dense_fused`` against ``dense`` at 4 chains: the velocity rtol 1e-4 /
  atol 1e-5, the divergence rtol 1e-3; 10 B4 launches (the JVPs' primal
  and the velocity) and 5 B5 (K = 87).

Returns the paths' launch counts by kernels-line name:
{"fused_edge_mlp_f256": (c)'s B4, "fused_edge_mlp_jvp_f256": (c)'s B5,
"fused_mlp_f256": (b)'s B6}.
"""

from __future__ import annotations

import copy
import ctypes
import time

import numpy as np
import torch

from chip_smoke import (
    H100_TF32,
    ambient_temps,
    bound_ms,
    compare,
    cuda_ms,
    log,
    nbytes,
    ptxas_kernels,
    require,
    torch_default_weights_,
    zero_com_x0,
)

N256, F256, LAYERS, B = 29, 256, 5, 16
LIBS = {"fused_edge_mlp": "fused_edge_mlp_tf32x3_f256",
        "fused_edge_mlp_jvp": "fused_edge_mlp_jvp_tf32x3_f256",
        "fused_mlp": "fused_mlp_tf32x3_f256"}
NAMES = {k: f"{k}_f256" for k in LIBS}  # kernels-line names
FWD_BAR = dict(rtol=1e-4, atol=1e-5)


def _timed(kernel, plain, reps: int, plain_reps: int, warm: int = 2):
    """Kernel and plain version timed in turns (kernel, plain, kernel,
    plain), CUDA events after warm-up; the readings of each."""
    ms, plain_ms = [], []
    for _ in range(2):
        ms.append(cuda_ms(kernel, reps, warm=warm))
        plain_ms.append(cuda_ms(plain, plain_reps, warm=1))
    return ms, plain_ms


def _report(what: str, lib: str, ms, plain_ms, flops: float, moved: int, card: str):
    bnd, by = bound_ms(3 * flops, H100_TF32, moved)
    fmt = lambda ts: " and ".join(f"{t:.4f}" for t in ts)
    log(f"[{what}] {lib} {fmt(ms)} ms per launch (in turns with the plain version's "
        f"{fmt(plain_ms)} ms); bound {bnd:.4f} ms ({by}, 3 x {flops:.4e} FLOP at 495 TFLOP/s TF32, "
        f"{moved / 1e6:.2f} MB), at {min(ms) / bnd:.2f}x its bound ({card})")
    return bnd, by


def _twice(fn, what: str, key: str):
    """Two launches from the ``_f256`` library, equal to the bit."""
    from ti_torch.ops import _build

    _build.reset_launches()
    out, again = fn(), fn()
    torch.cuda.synchronize()
    require(_build.route_counts() == {f"{key}:{LIBS[key]}": 2},
            f"{what}: both launches from {LIBS[key]}: {_build.route_counts()}")
    require(torch.equal(out, again), f"{what}: two launches agree to the bit")
    return out


def kernels_fused_f256(params, rows_kernels, report, card: str) -> None:
    """(a): each library against its plain version, timed, and its layout."""
    from ti_torch.ops import _build
    from ti_torch.ops import pallas_kernels as pk
    from ti_torch.ops.mlp_block import mlp_weights
    from ti_torch.ops.pair_layer_kernel import pack_layer, with_tf32_weights

    f32, f = torch.float32, F256
    for lib in LIBS.values():
        for fn, regs, spill in ptxas_kernels(report[lib]["ptxas"]):
            log(f"[23a {lib} build] {fn}: {regs}; {spill}")
    edge = _build.load(LIBS["fused_edge_mlp"])
    edge.fused_edge_mlp_tf32x3_smem_bytes.restype = ctypes.c_ulonglong
    jvp = _build.load(LIBS["fused_edge_mlp_jvp"])
    jvp.fused_edge_mlp_jvp_tf32x3_smem_bytes.restype = ctypes.c_ulonglong
    mlp = _build.load(LIBS["fused_mlp"])
    mlp.fused_mlp_tf32x3_smem_bytes.restype = ctypes.c_ulonglong
    layout = dict(
        b4=(edge.fused_edge_mlp_tf32x3_rows(), edge.fused_edge_mlp_tf32x3_smem_bytes(),
            edge.fused_edge_mlp_tf32x3_ctas_per_sm()),
        b5=(jvp.fused_edge_mlp_jvp_tf32x3_rows(), jvp.fused_edge_mlp_jvp_tf32x3_smem_bytes(),
            jvp.fused_edge_mlp_jvp_tf32x3_scratch_floats()),
        b6=(mlp.fused_mlp_tf32x3_rows(), mlp.fused_mlp_tf32x3_smem_bytes(),
            mlp.fused_mlp_tf32x3_ctas_per_sm()))
    want = dict(b4=(pk.edge_tile_rows(f), pk.tc_edge_smem_bytes(f), pk.EDGE_CTAS_PER_SM),
                b5=(pk.edge_tile_rows(f), pk.tc_jvp_smem_bytes(f), pk.tc_jvp_scratch(f)),
                b6=(pk.MLP_ROWS, pk.tc_mlp_smem_bytes(f), pk.mlp_ctas_per_sm(f)))
    log(f"[23a layout] (tile rows, shared memory bytes, CTAs an SM or scratch floats a CTA) "
        f"{layout}")
    require(layout == want, f"the _f256 libraries' layouts are the wrappers': {layout} == {want}")

    g = torch.Generator(device="cuda").manual_seed(23)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    w = with_tf32_weights(pack_layer(params, 0, f, f32, "cuda"))
    mac_row = 15 * f * f
    # B4 at the dense pair rows of 16 chains (the dense_fused sampler's) and
    # the edge rows of fused_velocity_fn's 16 chains
    for r, what in ((B * N256 ** 2, "dense pair rows"), (B * N256 * (N256 - 1), "edge rows")):
        in_feat, pe = rn(r, 2 * f), rn(r, f)
        name = f"B4 F={f} R={r} ({what})"
        out = _twice(lambda: pk.fused_edge_mlp(in_feat, pe, w), name, "fused_edge_mlp")
        plain = lambda: pk.fused_edge_mlp_reference(in_feat, pe, w.phi, w.w)
        err = compare([out], [plain()], f32, name)
        ms, plain_ms = _timed(lambda: pk.fused_edge_mlp(in_feat, pe, w), plain, 20, 5)
        bnd, by = _report(name, LIBS["fused_edge_mlp"], ms, plain_ms, 2.0 * mac_row * r,
                          nbytes(in_feat, pe, w.mats, w.vecs, out), card)
        if r == B * N256 ** 2:
            rows_kernels[NAMES["fused_edge_mlp"]] = dict(err=err, ms=min(ms), plain=min(plain_ms),
                                                         bound=bnd, by=by)
        del in_feat, pe, out
    for r in (1, 31, 33, 1007):
        in_feat, pe = rn(r, 2 * f), rn(r, f)
        compare([pk.fused_edge_mlp(in_feat, pe, w)],
                [pk.fused_edge_mlp_reference(in_feat, pe, w.phi, w.w)], f32, f"B4 F={f} R={r}")
    require(_build.ROUTES["fused_edge_mlp"] == LIBS["fused_edge_mlp"], "B4 routes to its _f256 build")

    # B5 at the sampler's nodes (K = 32 over 16 chains) and the exact frame at 4
    for r, k in ((B * N256 ** 2, 32), (4 * N256 ** 2, 3 * N256)):
        in_feat, pe, din, dpe = rn(r, 2 * f), rn(r, f), rn(k, r, 2 * f), rn(k, r, f)
        name = f"B5 F={f} K={k} R={r}"
        out = _twice(lambda: pk.fused_edge_mlp_jvp(in_feat, pe, din, dpe, w), name,
                     "fused_edge_mlp_jvp")
        plain = lambda: pk.edge_mlp_jvp_reference(in_feat, pe, din, dpe, w.phi, w.w)
        err = compare([out], [plain()], f32, name)
        ms, plain_ms = _timed(lambda: pk.fused_edge_mlp_jvp(in_feat, pe, din, dpe, w), plain, 3, 2,
                              warm=1)
        bnd, by = _report(name, LIBS["fused_edge_mlp_jvp"], ms, plain_ms,
                          2.0 * mac_row * r * (k + 1),
                          nbytes(in_feat, pe, din, dpe, w.mats, w.vecs, out), card)
        if k == 32:
            rows_kernels[NAMES["fused_edge_mlp_jvp"]] = dict(err=err, ms=min(ms),
                                                             plain=min(plain_ms), bound=bnd, by=by)
        del in_feat, pe, din, dpe, out
        torch.cuda.empty_cache()
    for r, k in ((5, 1), (65, 3)):
        in_feat, pe, din, dpe = rn(r, 2 * f), rn(r, f), rn(k, r, 2 * f), rn(k, r, f)
        compare([pk.fused_edge_mlp_jvp(in_feat, pe, din, dpe, w)],
                [pk.edge_mlp_jvp_reference(in_feat, pe, din, dpe, w.phi, w.w)], f32,
                f"B5 F={f} K={k} R={r}")
    require(_build.ROUTES["fused_edge_mlp_jvp"] == LIBS["fused_edge_mlp_jvp"],
            "B5 routes to its _f256 build")

    # B6 at the node rows of 16 chains: each MLP of fused_velocity_fn, and the
    # latent conditioning's 3F -> F combine (the combine's first 3F rows)
    r = B * N256
    combine = mlp_weights(params, "combine")
    for name, mw in (("combine", combine), ("update_0.mlp", mlp_weights(params, "update_0.mlp")),
                     ("readout.mlp", mlp_weights(params, "readout.mlp")),
                     ("latent combine", combine._replace(w1=combine.w1[:3 * f]))):
        pack = pk.pack_mlp(mw, "cuda")
        what = f"B6 F={f} {name} {pack.f_in}->{pack.f_out} R={r}"
        x = rn(r, pack.f_in)
        out = _twice(lambda: pk.fused_mlp(x, pack), what, "fused_mlp")
        plain = lambda: pk._mlp_block(x, pack.w)
        err = compare([out], [plain()], f32, what)
        for rr in (1, 17):
            xr = rn(rr, pack.f_in)
            compare([pk.fused_mlp(xr, pack)], [pk._mlp_block(xr, pack.w)], f32,
                    f"B6 F={f} {name} R={rr}")
        if name == "latent combine":
            continue
        ms, plain_ms = _timed(lambda: pk.fused_mlp(x, pack), plain, 50, 50, warm=5)
        bnd, by = _report(what, LIBS["fused_mlp"], ms, plain_ms,
                          2.0 * r * (pack.f_in + f + pack.f_out) * f, nbytes(x, *pack.w, out), card)
        if name == "update_0.mlp":  # 5 of the 7 launches of a forward
            rows_kernels[NAMES["fused_mlp"]] = dict(err=err, ms=min(ms), plain=min(plain_ms),
                                                    bound=bnd, by=by)
    torch.cuda.empty_cache()


def paths_fused_f256(model, template, card: str) -> dict:
    """(b)-(d): the fused forward, the dense_fused sampler and the exact
    divergence on the 10506 model."""
    from ti_torch.config import ambient_preset, fast_profile
    from ti_torch.models.cpainn import state_of
    from ti_torch.models.cpainn_dense import dense_velocity_fn
    from ti_torch.models.cpainn_fused import fused_velocity_fn
    from ti_torch.ops import _build
    from ti_torch.ops.divergence import divergence_exact
    from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of

    rng = np.random.default_rng(23)
    launches = {}

    # (b) fused_velocity_fn: 5 B4 and 7 B6 a forward
    xs = torch.as_tensor(zero_com_x0(rng, B, N256), device="cuda")
    conds = torch.as_tensor(ambient_temps(B), device="cuda")
    fused = fused_velocity_fn(model, None, template, device="cuda")
    p = {k: t.detach().to("cuda") for k, t in state_of(model, None).items()}
    dense = dense_velocity_fn(model, p, template)
    fused(xs, 0.5, conds)  # warm-up, not counted
    torch.cuda.synchronize()
    _build.reset_launches()
    v_fused = fused(xs, 0.5, conds)
    torch.cuda.synchronize()
    routes = _build.route_counts()
    with torch.no_grad():
        v_dense = dense(xs, 0.5, conds)
        ms_f = cuda_ms(lambda: fused(xs, 0.5, conds), 5)
        ms_d = cuda_ms(lambda: dense(xs, 0.5, conds), 5)
    err = (v_fused - v_dense).abs().max().item()
    log(f"[23b fused_velocity_fn 10506 B={B}] against dense_velocity_fn: max abs err {err:.3e} "
        f"(max |v| {v_dense.abs().max().item():.4f}); {ms_f:.3f} ms a forward (dense "
        f"{ms_d:.3f} ms; {card}); launches by library {routes}")
    want = {f"fused_edge_mlp:{LIBS['fused_edge_mlp']}": LAYERS,
            f"fused_mlp:{LIBS['fused_mlp']}": LAYERS + 2}
    require(routes == want, f"fused_velocity_fn at F = 256: launches by library {routes} == {want}")
    require(bool(torch.allclose(v_fused, v_dense, **FWD_BAR)),
            "fused_velocity_fn at F = 256 agrees with dense_velocity_fn (rtol 1e-4, atol 1e-5)")
    launches[NAMES["fused_mlp"]] = routes[f"fused_mlp:{LIBS['fused_mlp']}"]

    # (c) the dense_fused sampler at the 10506 fast profile's settings, in f32
    cfg = fast_profile(ambient_preset("10506"))
    gl, n_steps = cfg.dlogp_quad_points, cfg.n_steps
    kw = dict(solver=cfg.solver_type, n_steps=n_steps, dlogp_quad=cfg.dlogp_quad,
              dlogp_quad_points=gl, steps_per_dispatch=cfg.steps_per_dispatch,
              divergence=cfg.divergence, num_probes=cfg.num_probes, probe_mode=cfg.probe_mode,
              device="cuda")
    x0, temps = zero_com_x0(rng, B, N256), ambient_temps(B)
    samplers = {impl: make_ode_sampler(molecular_v_fn_of(model, None, template, impl=impl,
                                                         device="cuda"), **kw)
                for impl in ("dense_fused", "dense")}
    outs, walls = {}, {}
    for impl, sampler in samplers.items():
        sampler(x0, temps, torch.Generator(device="cuda").manual_seed(0))  # warm-up, not counted
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        outs[impl] = sampler(x0, temps, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        walls[impl] = time.perf_counter() - t0
        if impl == "dense_fused":
            routes = _build.route_counts()
    # (1 + GL) gaps x ceil(steps / (1 + GL)) RK4 steps x 4 stages of trajectory
    # forwards, and per node two forwards (the JVPs' primal and the velocity)
    # and one B5 a layer
    forwards = (1 + gl) * max(1, -(-n_steps // (1 + gl))) * 4 + 2 * gl
    want = {f"fused_edge_mlp:{LIBS['fused_edge_mlp']}": forwards * LAYERS,
            f"fused_edge_mlp_jvp:{LIBS['fused_edge_mlp_jvp']}": gl * LAYERS}
    out_f, out_d = outs["dense_fused"], outs["dense"]
    # the same Gauss-gap trajectory on the dense forward in f64 (one probe:
    # only its states are read)
    m64 = copy.deepcopy(model).double()
    p64 = {k: t.detach().double() for k, t in m64.state_dict().items()}
    x64 = make_ode_sampler(molecular_v_fn_of(m64, p64, template, device="cuda"),
                           **{**kw, "num_probes": 1}, dtype=torch.float64)(
        x0, temps, torch.Generator(device="cuda").manual_seed(0)).xs
    s_err = (out_f.xs - out_d.xs).abs().max().item()
    f64_err = {k: (o.xs.double() - x64).abs().max().item() for k, o in outs.items()}
    parted = int((~torch.isclose(out_f.xs, out_d.xs, **FWD_BAR)).flatten(1).any(1).sum())
    d_ref = out_d.dlogp[:, -1]
    d_err = (out_f.dlogp[:, -1] - d_ref).abs().max().item()
    log(f"[23c dense_fused sampler 10506 B={B}] {cfg.solver_type.upper()}-{n_steps}, GL-{gl}, "
        f"{cfg.probe_mode} Hutchinson-{cfg.num_probes}, f32: {walls['dense_fused']:.3f} s, "
        f"{B / walls['dense_fused']:.3f} samples/s (dense: {walls['dense']:.3f} s, "
        f"{B / walls['dense']:.3f} samples/s; host clock, {card}); samples max abs err "
        f"{s_err:.3e} (max |x| {out_d.xs.abs().max().item():.4f}; {parted} of {B} chains past "
        f"rtol 1e-4 / atol 1e-5), from the f64 trajectory's: dense_fused "
        f"{f64_err['dense_fused']:.3e}, dense {f64_err['dense']:.3e}; dlogp max abs err "
        f"{d_err:.3e} (max |dlogp| {d_ref.abs().max().item():.4f}); launches by library {routes} "
        f"({forwards} forwards)")
    require(routes == want, f"dense_fused sampler at F = 256: launches {routes} == {want}")
    require(bool(torch.isfinite(out_f.xs).all() and torch.isfinite(out_f.dlogp).all()),
            "dense_fused sampler at F = 256: finite")
    # a rounding grows along the RK4 steps on a few chains of this field, so
    # that any two f32 routes part there (phase 20's finding): the fused
    # route is held to the f64 trajectory no farther than twice the dense f32
    # route is
    require(f64_err["dense_fused"] <= 2.0 * f64_err["dense"],
            "dense_fused sampler at F = 256: samples no farther from the f64 trajectory than "
            "twice the dense f32 route's")
    require(bool(torch.allclose(out_f.dlogp, out_d.dlogp, rtol=1e-3,
                                atol=1e-3 * d_ref.abs().max().item())),
            "dense_fused sampler at F = 256: dlogp agrees with dense (rtol 1e-3, atol 1e-3 "
            "max|dlogp|)")
    launches[NAMES["fused_edge_mlp"]] = routes[f"fused_edge_mlp:{LIBS['fused_edge_mlp']}"]
    launches[NAMES["fused_edge_mlp_jvp"]] = routes[f"fused_edge_mlp_jvp:{LIBS['fused_edge_mlp_jvp']}"]
    del samplers, outs
    torch.cuda.empty_cache()

    # (d) the exact divergence, all 87 lanes at once, at 4 chains
    b = 4
    x = torch.as_tensor(zero_com_x0(rng, b, N256), device="cuda")
    temps4 = torch.as_tensor(ambient_temps(b), device="cuda")
    res, node_ms, node_routes = {}, {}, {}
    for impl in ("dense_fused", "dense"):
        v = molecular_v_fn_of(model, None, template, impl=impl, device="cuda")(temps4)
        f = lambda y: v(y, 0.5)
        divergence_exact(f, x)  # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        res[impl] = divergence_exact(f, x)
        torch.cuda.synchronize()
        node_ms[impl] = 1e3 * (time.perf_counter() - t0)
        node_routes[impl] = _build.route_counts()
    (vel_f, div_f), (vel_d, div_d) = res["dense_fused"], res["dense"]
    div_err = (div_f - div_d).abs().max().item()
    log(f"[23d exact divergence 10506 B={b} K={3 * N256}] dense_fused {node_ms['dense_fused']:.1f} "
        f"ms, dense {node_ms['dense']:.1f} ms a node (host clock, {card}); divergence max abs err "
        f"{div_err:.3e} (max |div| {div_d.abs().max().item():.4f}); velocity max abs err "
        f"{(vel_f - vel_d).abs().max().item():.3e}; launches by library {node_routes}")
    # two forwards (the JVPs' primal and the velocity) and one B5 a layer
    want = {f"fused_edge_mlp:{LIBS['fused_edge_mlp']}": 2 * LAYERS,
            f"fused_edge_mlp_jvp:{LIBS['fused_edge_mlp_jvp']}": LAYERS}
    require(node_routes == {"dense_fused": want, "dense": {}},
            f"the exact node launches two B4 and one B5 a layer: {node_routes}")
    require(bool(torch.allclose(vel_f, vel_d, **FWD_BAR)),
            "exact node at F = 256: the velocity agrees with dense (rtol 1e-4, atol 1e-5)")
    require(bool(torch.allclose(div_f, div_d, rtol=1e-3, atol=1e-3 * div_d.abs().max().item())),
            "exact node at F = 256: the divergence agrees with dense (rtol 1e-3)")
    return launches


def phase_fused_f256(rows_kernels, report, card: str) -> dict:
    """23. (a)-(d) above; returns the paths' launch counts by kernels-line name."""
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.cpainn import CPaiNN

    t_phase = time.perf_counter()
    model = torch_default_weights_(CPaiNN(F256, LAYERS, n_atoms=N256))
    params = {k: t.detach() for k, t in model.state_dict().items()}
    kernels_fused_f256(params, rows_kernels, report, card)
    template = graph_template(make_synthetic_molecule(N256, seed=0), t_cond=2)
    launches = paths_fused_f256(model, template, card)
    log(f"[23] phase {time.perf_counter() - t_phase:.1f} s")
    return launches
