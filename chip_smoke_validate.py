"""Phase 20 of chip_smoke.py: kernel B1 and B2 in f32 at F = 256 (library
pair_layer_tf32x3_f256, csrc/pair_layer_tf32x3.cu built with -DPK_F=256)
and the three physics-validation CLIs (ti_torch/cli:
validate_mdqm9_physics, validate_latent_physics, validate_bg_ti_physics) on
one NVIDIA H100.

``phase_validate(model, rows_kernels, card)`` runs after phases 2-19, so
the kernel libraries are built (phase 1 holds pair_layer_tf32x3_f256 to no
register spills):

- (a) B1 in f32 at F = 256 against its plain version at N = 29, 16 and 128
  chains (bar 2e-5 of max |plain|), every launch from
  pair_layer_tf32x3_f256, CUDA-event times after warm-up beside the plain
  version's and the bound (three TF32 passes at 495 TFLOP/s, or the bytes);
- (b) B2 in f32 at F = 256, C = 4, 512 chains (phase 15's SDE) against its
  plain version at the same bar and timed, then the SDE through it
  (``sample_molecular_sde(forward_impl="pair_kernel", chain_block=4)``, f32,
  512 chains, 20 steps: exactly 100 B2 launches, all from
  pair_layer_tf32x3_f256);
- (c) a 16-chain batch of ``fast_profile(ambient_preset("10506"),
  traj_forward_impl="pair_kernel")`` (B1 in f32 on the trajectory, the
  profile's bf16_agg Hutchinson-32 nodes): exactly 360 launches of
  pair_layer_tf32x3_f256 (72 forwards x 5 layers), its samples/s beside
  phase 15's bf16_agg trajectory, timed in turns. The same batch with f32
  nodes (``compute_dtype="f32"``: the bf16 nodes turn the trajectories'
  last bits into rounding flips, about 1e-2 of a dlogp) against the same
  sampler with B1's plain f32 version on the trajectory and the same
  probes: its dlogps at rtol 1e-3, its samples no farther from the same
  Gauss-gap trajectory in f64 than twice the plain route's (on 2 of the 16
  chains any two f32 routes part past phase 4's bars, rtol 1e-4 / atol
  1e-5, the plain and the dense f32 forwards too: the count is printed);
- (d) ``validate_mdqm9_physics`` with ``--reuse`` on a 4-atom F =
  128 field saved from the smoke's weights with ``--quad_dlogp
  --traj_impl pair_kernel --div_impl pair_tangent_bf16 --divergence
  hutchinson --num_probes 8 --probe_debias``: exactly 1,320 B1 launches
  from pair_layer_tf32x3 and 50 B3 from pair_tangent_mma, every key of
  its JSON finite, and its per-chain samples, dlogps and variances against
  the same CLI with ``--traj_impl default --div_impl default`` on the same
  probes (samples at phase 4's bars; dlogps and variances at B3 bf16_agg's
  bar, 2e-2 of their max). The CLI's closed-form bars (|dF err| < 0.2, ESS
  > 2%, the dlogp mean within 0.4-1.6x the volume change) on a field it
  trains are phase 22's (chip_smoke_f64.py), at its own default width;
  until F = 64 ran on the kernels this phase trained one at
  tests/test_mdqm9_physics.py's size (F = 16 x 2);
- (e) ``validate_latent_physics`` at the latent fixture's size (4 atoms, F
  = 16 x 2, batch 64, 512 chains, RK4-64, the exact divergence; its 60
  epochs of 2048 frames cut to ``EPOCHS`` of ``LATENT_FRAMES``, on the Gauss
  path): |-log Z err| < 0.2, ESS > 10%; ``validate_bg_ti_physics`` at the
  same size, both stages (``BG_TI_FRAMES`` a temperature, ``--latent_quad``):
  |-log Z err| < 0.5, ESS > 1%;
- (f) is phase 19(b)'s: ``large_scale_scan``'s ``pair_kernel`` rows at F =
  256 run (chip_smoke_studies.py).

Returns the launch counts of (b)'s SDE and (c)'s batch, by kernel.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from chip_smoke import (
    BAR,
    H100_TF32,
    LENGTH_SCALE,
    SDE_STEPS,
    ambient_temps,
    bound_ms,
    compare,
    cuda_ms,
    log,
    nbytes,
    require,
    torch_default_weights_,
    zero_com_x0,
)

N256, F256, LIB = 29, 256, "pair_layer_tf32x3_f256"
SDE_CHAINS_256 = 512  # phase 15's SDE
# the latent fixture's sizes (F = 16 x 2, batch 64) with its 60 epochs cut to
# 5, its frames changed so that each field takes as many updates as its bars
# need, and its stage-coupled dlogp replaced by the Gauss path (the scripts'
# --latent_quad). The trainers' updates are host-paced (tens of ms each on the
# card, an epoch about 1 s more). Latent and BG->TI met their bars with
# margins of 9-50x at 120 and 60 + 120 updates (PERF.md section 6)
EPOCHS = 5
LATENT_FRAMES = 1536  # the latent generator: 24 updates an epoch, 120 in all
BG_TI_FRAMES = 768    # both BG->TI stages, a temperature: 60 and 120 updates


def _layer(params, b: int, seed: int):
    """Layer 0 of ``params`` at F = 256 in f32 (3xTF32 packing) and its
    inputs for b chains of N256 atoms."""
    from ti_torch.ops.pair_layer_kernel import pack_layer, with_tf32_weights

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = with_tf32_weights(pack_layer(params, 0, F256, torch.float32, "cuda"))
    x = 0.3 * torch.randn(b, N256, 3, generator=g, device="cuda")
    base = (x, torch.randn(b, N256, F256, generator=g, device="cuda"),
            0.3 * torch.randn(b, 3, N256, F256, generator=g, device="cuda"),
            torch.randn(b, N256 * N256, F256, generator=g, device="cuda"))
    return w, base


def _timed(name: str, base, w, c: int, rows_kernels, card: str) -> None:
    """Kernel against plain (bar 2e-5), every launch from LIB, times in
    turns with the plain version, the bound; a ``kernels`` row as ``name``."""
    from ti_torch.ops import _build
    from ti_torch.ops.pair_layer_kernel import pair_layer, pair_layer_plain

    b = base[0].shape[0]
    kernel = "pair_layer" if c == 1 else "pair_layer_cb"
    _build.reset_launches()
    out = pair_layer(*base, w, LENGTH_SCALE, c)
    torch.cuda.synchronize()
    require(_build.route_counts() == {f"{kernel}:{LIB}": 1},
            f"{name} B={b} C={c}: one launch, from {LIB}: {_build.route_counts()}")
    err = compare(out, pair_layer_plain(*base, w, LENGTH_SCALE), torch.float32,
                  f"{name} f32 F={F256} N={N256} B={b} C={c}")
    again = pair_layer(*base, w, LENGTH_SCALE, 1 if c > 1 else 4)
    torch.cuda.synchronize()
    require(all(torch.equal(a, q) for a, q in zip(again, out)),
            f"{name} B={b}: chain blocks 1 and 4 agree to the bit")
    ms = [cuda_ms(lambda: pair_layer(*base, w, LENGTH_SCALE, c), 20, warm=3) for _ in range(2)]
    plain = cuda_ms(lambda: pair_layer_plain(*base, w, LENGTH_SCALE), 3, warm=1)
    flops = 2.0 * 15 * F256 * F256 * b * N256 * N256
    moved = nbytes(*base, w.mats, w.vecs, *out)
    bnd, by = bound_ms(3 * flops, H100_TF32, moved)
    log(f"[{name} f32 F={F256} N={N256} B={b} C={c}] 3xTF32 ({LIB}, one 64-row tile a CTA of 16 "
        f"warps) {' and '.join(f'{t:.4f}' for t in ms)} ms per launch (20 launches a reading); "
        f"plain {plain:.4f} ms; bound {bnd:.4f} ms ({by}, 3 x {flops:.4e} FLOP at 495 TFLOP/s "
        f"TF32, {moved / 1e6:.2f} MB), at {min(ms) / bnd:.2f}x its bound ({card})")
    if name not in rows_kernels:
        rows_kernels[name] = dict(err=err, ms=min(ms), plain=plain, bound=bnd, by=by)


def kernels_f256(rows_kernels, card: str) -> dict:
    """(a) and (b): B1 and B2 in f32 at F = 256 against their plain
    versions, then the SDE through B2. Returns the SDE's launch counts."""
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops import _build
    from ti_torch.sampling.drivers import sample_molecular_sde

    model = torch_default_weights_(CPaiNN(F256, 5, n_atoms=N256))
    params = {k: t.detach() for k, t in model.state_dict().items()}
    for b, seed in ((16, 21), (128, 22)):
        w, base = _layer(params, b, seed)
        _timed("pair_layer_f256", base, w, 1, rows_kernels, card)
        del w, base
    w, base = _layer(params, SDE_CHAINS_256, 23)
    _timed("pair_layer_cb_f256", base, w, 4, rows_kernels, card)
    del w, base
    torch.cuda.empty_cache()

    template = graph_template(make_synthetic_molecule(N256, seed=0), t_cond=2)
    rng = np.random.default_rng(8)

    def sde(steps, seed):
        return sample_molecular_sde(
            model, None, template, zero_com_x0(rng, SDE_CHAINS_256, N256),
            ambient_temps(SDE_CHAINS_256), torch.Generator(device="cuda").manual_seed(seed),
            g_fn=0.1, n_steps=steps, n_save=2, forward_impl="pair_kernel", chain_block=4,
            device="cuda")

    sde(1, 0)  # warm-up, not counted
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    xs = sde(SDE_STEPS, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    require(_build.route_counts() == {f"pair_layer_cb:{LIB}": SDE_STEPS * 5},
            f"every B2 launch of the f32 SDE at F = 256 comes from {LIB}: "
            f"{_build.route_counts()}")
    require(xs.shape == (SDE_CHAINS_256, 2, N256, 3) and bool(torch.isfinite(xs).all()),
            "f32 SDE at F = 256: finite samples of the expected shape")
    log(f"[10506 SDE f32] {SDE_CHAINS_256} chains, {SDE_STEPS} Euler-Maruyama steps, g=0.1, "
        f"chain_block 4: {wall:.3f} s, {SDE_CHAINS_256 / wall:.3f} samples/s (host clock, {card}); "
        f"launches by library {_build.route_counts()}")
    return launches


def profile_10506_f32(card: str) -> dict:
    """(c): the 10506 fast profile with B1 in f32 on the trajectory
    (``traj_forward_impl="pair_kernel"``) timed in turns beside its bf16_agg
    trajectory, both with the profile's bf16_agg Hutchinson-32 nodes; then
    the same batch with f32 nodes against the same sampler with B1's plain
    f32 version on the trajectory and the same probes, and against the
    trajectory in f64. Returns the timed f32 batch's launch counts."""
    from ti_torch.config import ambient_preset, fast_profile
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops import _build
    from ti_torch.ops.pair_layer_kernel import pair_kernel_drift
    from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of, sample_ambient

    b, layers = 16, 5
    model = torch_default_weights_(CPaiNN(F256, layers, n_atoms=N256))
    template = graph_template(make_synthetic_molecule(N256, seed=0), t_cond=2)
    x0 = zero_com_x0(np.random.default_rng(5), b, N256)
    cfgs = {"f32": fast_profile(ambient_preset("10506"), traj_forward_impl="pair_kernel"),
            "bf16_agg": fast_profile(ambient_preset("10506")),
            "f32 nodes": fast_profile(ambient_preset("10506"), traj_forward_impl="pair_kernel",
                                      compute_dtype="f32")}
    cfg = cfgs["f32 nodes"]
    require((cfg.n_features, cfgs["f32"].traj_forward_impl, cfgs["f32"].compute_dtype,
             cfgs["bf16_agg"].traj_forward_impl) == (F256, "pair_kernel", "bf16_agg",
                                                     "pair_kernel_bf16"), "the 10506 profiles")
    libs = {"f32": LIB, "bf16_agg": "pair_layer_mma_f256", "f32 nodes": LIB}

    def batch(name):
        _build.reset_launches()
        t0 = time.perf_counter()
        out = sample_ambient(cfgs[name], model, None, template, x0, save=False, batch_size=b,
                             device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = {f"pair_layer:{libs[name]}": 360}  # 9 gaps x 2 RK4 steps x 4 stages x 5 layers
        require(_build.route_counts() == want,
                f"10506 {name}: launches {_build.route_counts()} == {want}")
        return out, wall, dict(_build.LAUNCHES)

    for name in ("f32", "bf16_agg"):
        batch(name)  # warm-up, not counted
    walls = {"f32": [], "bf16_agg": []}
    launches = None
    for name in ("f32", "bf16_agg", "bf16_agg", "f32"):
        _, wall, counts = batch(name)
        walls[name].append(wall)
        launches = launches or counts
    log(f"[10506 f32 trajectory] {b} chains: {' and '.join(f'{t:.3f}' for t in walls['f32'])} s "
        f"a batch, {b / min(walls['f32']):.3f} samples/s; the bf16_agg trajectory "
        f"{' and '.join(f'{t:.3f}' for t in walls['bf16_agg'])} s, "
        f"{b / min(walls['bf16_agg']):.3f} samples/s (in turns, the profile's bf16_agg nodes, "
        f"host clock, {card}); 360 launches of {LIB} a batch")

    # the check, with f32 nodes (bf16 nodes turn the trajectories' last
    # bits into rounding flips of the node values)
    got, wall, _ = batch("f32 nodes")
    temps = np.tile(np.array([cfg.sampling_T0, cfg.sampling_T1], np.float32), (b, 1))

    def route(v_fn, traj, dtype=torch.float32, probes=cfg.num_probes):
        return make_ode_sampler(
            v_fn, solver=cfg.solver_type, n_steps=cfg.n_steps, n_save=2,
            divergence=cfg.divergence, steps_per_dispatch=cfg.steps_per_dispatch,
            dlogp_quad_points=cfg.dlogp_quad_points, dlogp_quad="gauss", num_probes=probes,
            probe_mode=cfg.probe_mode, traj_drift=traj, device="cuda", dtype=dtype,
        )(x0, temps, torch.Generator(device="cuda").manual_seed(int(cfg.seed)))

    ref = route(molecular_v_fn_of(model, None, template, device="cuda"),
                pair_kernel_drift(model, None, template, device="cuda", kernel=False))
    ref_x, ref_d = ref.xs.cpu().numpy(), ref.dlogp[:, -1].cpu().numpy()
    # the same Gauss-gap trajectory on the dense forward in f64 (one probe:
    # only its states are read)
    m64 = copy.deepcopy(model).double()
    p64 = {k: t.detach().double() for k, t in m64.state_dict().items()}
    x64 = route(molecular_v_fn_of(m64, p64, template, device="cuda"), None, torch.float64,
                1).xs.cpu().numpy()
    require(np.isfinite(got["samples"]).all() and np.isfinite(got["dlogps"]).all(),
            "10506 f32 trajectory: finite samples and dlogps")
    x_err = float(np.max(np.abs(got["samples"] - ref_x)))
    k64 = float(np.max(np.abs(got["samples"] - x64)))
    p64_err = float(np.max(np.abs(ref_x - x64)))
    tol = 1e-5 + 1e-4 * np.abs(ref_x)
    parted = int(np.sum(np.any(np.abs(got["samples"] - ref_x) > tol, axis=(1, 2, 3))))
    d_rel = float(np.max(np.abs(got["dlogps"] - ref_d) / np.abs(ref_d)))
    log(f"[10506 f32 trajectory, f32 nodes] {b} chains in {wall:.3f} s: samples minus the plain "
        f"f32 trajectory's max abs {x_err:.3e} (max |x| {np.max(np.abs(ref_x)):.4f}; {parted} of "
        f"{b} chains past phase 4's bars), from the f64 trajectory's: kernel {k64:.3e}, plain "
        f"f32 {p64_err:.3e}; dlogp max rel against the plain route {d_rel:.3e} (dlogp mean "
        f"{got['dlogps'].mean():.5f})")
    # a rounding grows along 18 RK4 steps on a few chains of this field, so
    # that any two f32 routes part there (the plain and the dense f32
    # forwards as much as the kernel and the plain): the kernel route is
    # held to the f64 trajectory no farther than twice the plain f32 route
    require(k64 <= 2.0 * p64_err, "10506: the f32 kernel route's samples lie no farther from "
            "the f64 trajectory than twice the plain f32 route's")
    np.testing.assert_allclose(got["dlogps"], ref_d, rtol=1e-3)
    return launches


def _cli(main, argv) -> dict:
    """The last JSON line of a CLI run here on the card."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = main(["--device", "cuda", *argv])
    require(rc == 0, f"{main.__module__} exits 0 (rc {rc})")
    row = json.loads(text.getvalue().strip().splitlines()[-1])
    require(all(math.isfinite(v) for v in row.values() if isinstance(v, float)),
            f"{main.__module__}: every number of its JSON is finite: {row}")
    return row


def validate_mdqm9(model, root: str, card: str) -> None:
    """(d): the CLI's kernel route on the smoke's field against its default
    route."""
    from ti_torch.cli import validate_mdqm9_physics
    from ti_torch.models.convert import save_npz
    from ti_torch.ops import _build
    from ti_torch.sampling import drivers

    # the smoke's field (F = 128 x 5) on 4 atoms, through the CLI's kernel route
    out_dir = os.path.join(root, "kernel")
    os.makedirs(out_dir, exist_ok=True)
    state = {k: t.detach().cpu() for k, t in model.state_dict().items()}
    state["atom_embed.weight"] = state["atom_embed.weight"][:4]
    save_npz(os.path.join(out_dir, "oracle_params.npz"), state,
             arch={"atoms": 4, "features": model.n_features, "layers": model.score_layers,
                   "temp_length": model.temp_length})
    base = ["--reuse", "--out_dir", out_dir, "--atoms", "4", "--features",
            str(model.n_features), "--layers", str(model.score_layers), "--temp_length",
            str(model.temp_length), "--quad_dlogp", "--divergence", "hutchinson",
            "--num_probes", "8", "--probe_debias"]
    real, seen = drivers.make_ode_sampler, []

    def make_ode_sampler(*a, **kw):
        sampler = real(*a, **kw)

        def run(*b, **bk):
            sol = sampler(*b, **bk)
            seen.append([t.cpu().numpy() for t in (sol.xs[:, -1], sol.dlogp[:, -1],
                                                   sol.dlogp_var[:, -1])])
            return sol

        return run

    drivers.make_ode_sampler = make_ode_sampler
    rows = {}
    try:
        for route, flags in (("kernel", ["--traj_impl", "pair_kernel", "--div_impl",
                                         "pair_tangent_bf16"]),
                             ("default", ["--traj_impl", "default", "--div_impl", "default"])):
            _build.reset_launches()
            t0 = time.perf_counter()
            rows[route] = _cli(validate_mdqm9_physics.main, [*base, *flags])
            torch.cuda.synchronize()
            rows[route]["seconds"] = time.perf_counter() - t0
            rows[route]["launches"] = _build.route_counts()
    finally:
        drivers.make_ode_sampler = real
    (xk, dk, vk), (xd, dd, vd) = seen
    # Gauss GL-10 over one save interval: 11 gaps of ceil(64 / 11) = 6 RK4
    # steps, 4 stages each, 5 layers a forward; 10 nodes, 5 layers a node
    want = {"pair_layer:pair_layer_tf32x3": 11 * 6 * 4 * 5,
            "pair_tangent:pair_tangent_mma": 10 * 5}
    require(rows["kernel"]["launches"] == want and rows["default"]["launches"] == {},
            f"20d: the kernel route launches {want}, the default none: "
            f"{rows['kernel']['launches']}, {rows['default']['launches']}")
    x_err = float(np.max(np.abs(xk - xd)))
    d_rel = float(np.max(np.abs(dk - dd)) / np.max(np.abs(dd)))
    v_rel = float(np.max(np.abs(vk - vd)) / np.max(np.abs(vd)))
    log(f"[20d kernel route] 1024 chains, 4 atoms, F = 128 x 5 (the smoke's field): "
        f"{rows['kernel']['seconds']:.2f} s against the default route's "
        f"{rows['default']['seconds']:.2f} s; launches {rows['kernel']['launches']}; samples "
        f"minus the default route's max abs {x_err:.3e} (max |x| {np.max(np.abs(xd)):.4f}); "
        f"dlogp max err / max |dlogp| {d_rel:.3e}, variance {v_rel:.3e}; kernel row "
        f"{json.dumps(rows['kernel'])} ({card})")
    np.testing.assert_allclose(xk, xd, rtol=1e-4, atol=1e-5)
    require(d_rel <= BAR[torch.bfloat16] and v_rel <= BAR[torch.bfloat16],
            f"20d: B3 bf16_agg's dlogps and variances within 2e-2 of max ({d_rel:.3e}, "
            f"{v_rel:.3e})")


def validate_latent_and_bg_ti(root: str, card: str) -> None:
    """(e): the BG identity and the composed BG->TI identity."""
    from ti_torch.cli import validate_bg_ti_physics, validate_latent_physics

    size = ["--features", "16", "--layers", "2", "--batch", "64"]
    t0 = time.perf_counter()
    lat = _cli(validate_latent_physics.main, [*size, "--frames", str(LATENT_FRAMES), "--epochs",
                                              str(EPOCHS), "--quad_dlogp", "--n_gen", "512",
                                              "--sample_batch", "256", "--out_dir",
                                              os.path.join(root, "latent")])
    t1 = time.perf_counter()
    log(f"[20e validate_latent_physics] 4 atoms, F = 16 x 2, {EPOCHS} epochs, {LATENT_FRAMES} "
        f"frames, 512 chains: {t1 - t0:.1f} s; {json.dumps(lat)} ({card})")
    require(lat["abs_err"] < 0.2 and lat["ess"] / lat["n"] > 0.1,
            f"20e: BG |-log Z err| {lat['abs_err']:.4f} < 0.2 and ESS "
            f"{lat['ess'] / lat['n']:.4f} > 10%")
    bg = _cli(validate_bg_ti_physics.main, [*size, "--frames", str(BG_TI_FRAMES),
                                            "--latent_epochs", str(EPOCHS),
                                            "--ambient_epochs", str(EPOCHS), "--latent_quad",
                                            "--n_gen", "512",
                                            "--sample_batch", "256", "--out_dir",
                                            os.path.join(root, "bg_ti")])
    log(f"[20e validate_bg_ti_physics] both stages 4 atoms, F = 16 x 2, {EPOCHS} epochs, "
        f"{BG_TI_FRAMES} frames a temperature, 512 chains: {time.perf_counter() - t1:.1f} s; "
        f"{json.dumps(bg)} ({card})")
    require(bg["abs_err"] < 0.5 and bg["ess_frac"] > 0.01,
            f"20e: composed |-log Z err| {bg['abs_err']:.4f} < 0.5 and ESS "
            f"{bg['ess_frac']:.4f} > 1%")


def phase_validate(model, rows_kernels, card: str) -> dict:
    """20. B1 and B2 in f32 at F = 256 and the validation CLIs; returns the
    launch counts of the SDE through B2 and of the 10506 batch through B1,
    by kernel."""
    t_phase = time.perf_counter()
    secs = {}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sde = kernels_f256(rows_kernels, card)
    secs["ab"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = profile_10506_f32(card)
    secs["c"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        validate_mdqm9(model, root, card)
        secs["d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        validate_latent_and_bg_ti(root, card)
        secs["e"] = time.perf_counter() - t0
    secs["phase"] = time.perf_counter() - t_phase
    log("[20 validate] " + ", ".join(f"({k}) {v:.1f} s" for k, v in secs.items()) + f" ({card})")
    return {"pair_layer_f256": batch["pair_layer"], "pair_layer_cb_f256": sde["pair_layer_cb"]}
