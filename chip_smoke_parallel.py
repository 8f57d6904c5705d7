"""Phase 17 of chip_smoke.py: the parallel layer (ti_torch.parallel) on one
NVIDIA H100.

``phase_parallel(model, template, card)`` runs after phases 2-16, so the
kernel libraries are built. With one card, NCCL runs at world size 1 (it
refuses two ranks on one device), so what crosses ranks is proven by the
CPU tests on gloo (tests/test_torch_parallel.py); here the same code runs
on the card, through the kernels:

- (a) ``init_distributed`` on NCCL (a ``file://`` store in a temporary
  directory) and ``make_mesh()`` on ``cuda``; ``parallel_sampler`` over the
  main path (``fast_profile(ambient_preset("00031"))``: B1 in f32, B3 in
  bf16_agg) at 128 chains against ``sample_ambient`` unsharded with the
  same seed, at phase 4's bars (samples rtol 1e-4 / atol 1e-5, dlogp rtol
  1e-3; the probes are the same by construction), with exactly 180 B1
  launches from pair_layer_tf32x3 and 40 B3 launches from pair_tangent_mma;
- (b) on the same group, the lane-sharded exact divergence of the
  full-width dense forward at 128 chains against ``divergence_exact``
  (rtol 3e-4, phase 10's bar), and ``parallel_update`` against
  ``make_update_step`` for one dense f32 step at batch 256 (loss rtol
  1e-5, parameters rtol 1e-4 / atol 1e-6);
- (c) the fan-out on the one card: a synthetic MDQM9 workspace in the
  reference's layout and a checkpoint of the smoke's field, then
  ``python -m ti_torch.cli.fanout_driver --num_shards 2 --max_parallel 2
  -- python -m ti_torch.cli.mdqm9_sample_ambient ... --fast_profile`` over
  256 chains, against one unsharded CLI run in this process: merged
  samples equal at phase 4's bars, merged dlogps finite and of the
  unsharded shape, the shards' seeds (and so their probes) different, and
  each shard's 180 B1 and 40 B3 launches. Its wall time beside the
  unsharded run's is a number to record: two processes share one card.

Nothing here is caught and passed over: a failure of NCCL or of a shard
fails the smoke.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CHAINS, N_ATOMS = 128, 19
# where the phase runs and the width it gives the preset: the card and the
# 00031 width here; a rehearsal on the CPU sets "cpu", gloo and a small width
DEVICE, BACKEND, PRESET = "cuda", "nccl", {}
ROOT = os.path.dirname(os.path.abspath(__file__))
# the main path's launches for one batch: GL-8 has 9 trajectory gaps of one
# RK4 step (4 stages) and 8 divergence nodes, one launch a layer of 5
MAIN_PATH_ROUTES = {("pair_layer", "pair_layer_tf32x3"): 9 * 4 * 5,
                    ("pair_tangent", "pair_tangent_mma"): 8 * 5}


def log(*a):
    print(*a, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _main_cfg():
    from ti_torch.config import ambient_preset, fast_profile

    return fast_profile(ambient_preset("00031", **PRESET))


def _routes() -> dict:
    from ti_torch.ops import _build

    return {k: n for k, n in _build.ROUTE_LAUNCHES.items() if n}


def _main_path_sharded(model, template, mesh, card: str) -> dict:
    """(a): ``parallel_sampler`` over the main path against the unsharded run."""
    from ti_torch.ops import _build
    from ti_torch.parallel import parallel_sampler
    from ti_torch.sampling.drivers import _config_sampler, sample_ambient

    cfg = _main_cfg()
    rng = np.random.default_rng(17)
    x0 = (0.1 * rng.standard_normal((CHAINS, N_ATOMS, 3))).astype(np.float32)
    x0 -= x0.mean(axis=1, keepdims=True)
    temps = np.tile(np.array([cfg.sampling_T0, cfg.sampling_T1], np.float32), (CHAINS, 1))
    t0 = time.perf_counter()
    whole = sample_ambient(cfg, model, None, template, x0, save=False, batch_size=CHAINS,
                           device=DEVICE)
    _sync()
    t_whole = time.perf_counter() - t0
    sampler = parallel_sampler(_config_sampler(cfg, model, None, template, torch.device(DEVICE)),
                               mesh)
    _sync()
    _build.reset_launches()
    t0 = time.perf_counter()
    sol = sampler(x0, temps, torch.Generator(device=DEVICE).manual_seed(int(cfg.seed)))
    _sync()
    t_sharded = time.perf_counter() - t0
    launches, routes = dict(_build.LAUNCHES), _routes()
    samples, dlogp = sol.xs.cpu().numpy(), sol.dlogp[:, -1].cpu().numpy()
    s_err = float(np.max(np.abs(samples - whole["samples"])))
    d_err = float(np.max(np.abs(dlogp - whole["dlogps"])))
    log(f"[17a parallel_sampler {BACKEND} world 1] main path, {CHAINS} chains: {t_sharded:.3f} s "
        f"against sample_ambient unsharded {t_whole:.3f} s (host clock, {card}); samples max abs "
        f"diff {s_err:.3e}, dlogp max abs diff {d_err:.3e}; launches by library "
        f"{ {f'{k}:{lib}': n for (k, lib), n in routes.items()} }")
    require(routes == MAIN_PATH_ROUTES, f"the sharded main path launches 180 B1 from "
            f"pair_layer_tf32x3 and 40 B3 from pair_tangent_mma: {routes}")
    require(samples.shape == whole["samples"].shape and np.isfinite(samples).all()
            and np.isfinite(dlogp).all(), "17a: finite samples and dlogp of the unsharded shape")
    require(np.allclose(samples, whole["samples"], rtol=1e-4, atol=1e-5),
            "17a: samples equal the unsharded run's (rtol 1e-4, atol 1e-5)")
    require(np.allclose(dlogp, whole["dlogps"], rtol=1e-3,
                        atol=1e-3 * float(np.max(np.abs(whole["dlogps"])))),
            "17a: dlogp equals the unsharded run's (rtol 1e-3)")
    return launches


def _lane_divergence_and_update(model, template, mesh, card: str) -> None:
    """(b): the lane-sharded exact divergence and the data-parallel step."""
    from ti_torch.data.mdqm9 import make_synthetic_frames, make_synthetic_molecule
    from ti_torch.interpolants import linear
    from ti_torch.losses import molecular_velocity_loss
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops.divergence import divergence_exact
    from ti_torch.parallel import parallel_update
    from ti_torch.sampling.drivers import molecular_v_fn_of
    from ti_torch.train import common

    rng = np.random.default_rng(18)
    x = torch.as_tensor(0.1 * rng.standard_normal((CHAINS, N_ATOMS, 3)), dtype=torch.float32,
                        device=DEVICE)
    temps = torch.tensor([[1000.0, 300.0]], device=DEVICE).expand(CHAINS, 2)
    v = molecular_v_fn_of(model, None, template, device=DEVICE)(temps)
    f = lambda y: v(y, 0.5)  # noqa: E731
    group = mesh.get_group("data")
    secs = {"lanes": [], "plain": []}
    for kind in ("lanes", "plain", "plain", "lanes"):  # in turns, the first pays the warm-up
        t0 = time.perf_counter()
        _, div = divergence_exact(f, x, chunk=N_ATOMS,
                                  axis_name=group if kind == "lanes" else None)
        _sync()
        secs[kind].append(time.perf_counter() - t0)
        if kind == "lanes":
            lanes = div
        else:
            ref = div
    rel = float((lanes - ref).abs().max() / ref.abs().max())
    log(f"[17b lane-sharded exact divergence {BACKEND} world 1] dense f32, {CHAINS} chains, "
        f"{3 * N_ATOMS} lanes in blocks of {N_ATOMS}: "
        f"{' and '.join(f'{t:.3f}' for t in secs['lanes'])} s against divergence_exact's "
        f"{' and '.join(f'{t:.3f}' for t in secs['plain'])} s (in turns, host clock); max |diff| "
        f"/ max |trace| {rel:.3e} (bar 3e-4) ({card})")
    require(torch.isfinite(lanes).all() and rel <= 3e-4,
            "17b: the lane-sharded exact divergence equals divergence_exact (rtol 3e-4)")

    b = 256
    mol = make_synthetic_molecule(N_ATOMS, seed=0)
    idx = rng.choice(2 * b, (2, b))
    frames = np.concatenate([make_synthetic_frames(mol, b, T, seed=T) for T in (1000, 300)])
    batch = [torch.as_tensor(frames[idx[0]], device=DEVICE),
             torch.as_tensor(frames[idx[1]], device=DEVICE),
             torch.tensor([[1000.0, 300.0]], device=DEVICE).expand(b, 2).contiguous()]

    class Cfg:
        train_impl = "dense"
        train_compute_dtype = "f32"

    interp = linear(a=1.0, gamma="sin2")
    got = {}
    for name in ("single", "parallel"):
        m = CPaiNN(model.n_features, model.score_layers, n_atoms=N_ATOMS)
        m.load_state_dict(model.state_dict())
        m.to(DEVICE)
        params = dict(m.named_parameters())
        apply = common.make_batched_apply(Cfg, m, template)
        step = common.make_update_step(
            lambda g, x0, x1, tp, apply=apply, params=params: molecular_velocity_loss(
                apply, params, x0, x1, tp, interp, generator=g),
            common.make_optimizer(list(params.values()), 1e-4))
        if name == "parallel":
            step = parallel_update(step, mesh)
        t0 = time.perf_counter()
        loss = step(torch.Generator(device=DEVICE).manual_seed(0), *batch)
        _sync()
        got[name] = (loss, {k: p.detach().cpu() for k, p in params.items()},
                     time.perf_counter() - t0)
    (l1, p1, s1), (ln, pn, sn) = got["single"], got["parallel"]
    worst = max(((pn[k] - p1[k]).abs() - 1e-4 * p1[k].abs()).max().item() for k in p1)
    log(f"[17b parallel_update {BACKEND} world 1] dense f32 batch {b}: loss {ln:.7f} against "
        f"make_update_step's {l1:.7f}; parameters worst |diff| - 1e-4 |single| {worst:.3e} (bar "
        f"1e-6); {sn:.3f} s against {s1:.3f} s a step, first call (host clock, {card})")
    require(abs(ln - l1) <= 1e-5 * abs(l1) and worst <= 1e-6,
            "17b: parallel_update takes make_update_step's step (loss rtol 1e-5, parameters rtol "
            "1e-4 / atol 1e-6)")


def _fanout(model, card: str) -> None:
    """(c): the fan-out CLI on the one card against one unsharded CLI run."""
    from ti_torch.cli import mdqm9_sample_ambient
    from ti_torch.data.mdqm9 import write_synthetic_workspace
    from ti_torch.train.common import checkpoint_path, save_checkpoint

    n = 2 * CHAINS
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_workspace(root, N_ATOMS, n)
        os.makedirs(os.path.join(root, "models", "smoke"))
        save_checkpoint(checkpoint_path(os.path.join(root, "models", "smoke"), "smoke", 0),
                        {k: t.detach().cpu() for k, t in model.state_dict().items()})
        out = os.path.join(root, "out")
        flags = ["--device", DEVICE, "--preset", "00031:300", "--fast_profile", "--traj_path",
                 os.path.join(root, "trajs"), "--sdf_path", root, "--model_save_path",
                 os.path.join(root, "models"), "--model_save_name", "smoke", "--model_epoch", "0",
                 "--data_save_path", out, "--batch_size", str(CHAINS),
                 *(a for k, v in PRESET.items() for a in (f"--{k}", str(v)))]
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = mdqm9_sample_ambient.main(flags + ["--data_save_name", "whole"])
        t_whole = time.perf_counter() - t0
        require(rc == 0, "17c: the unsharded CLI run exits 0")
        whole = json.loads(text.getvalue().strip().splitlines()[-1])
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "ti_torch.cli.fanout_driver", "--num_shards", "2",
             "--max_parallel", "2", "--data_dir", out, "--", sys.executable, "-m",
             "ti_torch.cli.mdqm9_sample_ambient", *flags, "--data_save_name", "fan"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        t_fan = time.perf_counter() - t0
        logs = {i: open(os.path.join(out, "fanout_logs", f"shard_{i}.log")).read()
                for i in range(2)}
        if res.returncode != 0:
            log(res.stdout[-3000:], res.stderr[-3000:], *(v[-3000:] for v in logs.values()))
        require(res.returncode == 0, f"17c: the fan-out exits 0 (rc {res.returncode})")
        shards = [json.loads(logs[i].strip().splitlines()[-1]) for i in range(2)]
        ref_s = np.load(os.path.join(out, "samples_whole.npy"))
        ref_d = np.load(os.path.join(out, "dlogps_whole.npy"))
        fan_s = np.load(os.path.join(out, "samples_fan.npy"))
        fan_d = np.load(os.path.join(out, "dlogps_fan.npy"))
    s_err = float(np.max(np.abs(fan_s - ref_s)))
    want = {f"{k}:{lib}": c for (k, lib), c in MAIN_PATH_ROUTES.items()}
    log(f"[17c fan-out] 2 shards x {CHAINS} chains on one card: {t_fan:.3f} s for the fan-out "
        f"(two processes, each starting its own CUDA context; their sampling "
        f"{shards[0]['seconds']:.3f} and {shards[1]['seconds']:.3f} s) against {t_whole:.3f} s for "
        f"one unsharded CLI run of {whole['n']} chains in this process (its sampling "
        f"{whole['seconds']:.3f} s) (host clock, {card}); merged samples max abs diff {s_err:.3e}; "
        f"shard seeds {[s['seed'] for s in shards]} against {whole['seed']}; shard launches "
        f"{[s['route_launches'] for s in shards]}")
    require([s["n"] for s in shards] == [CHAINS, CHAINS] and whole["n"] == n,
            "17c: each shard transports its 128 chains")
    require(all(s["route_launches"] == want for s in shards),
            f"17c: each shard launches 180 B1 from pair_layer_tf32x3 and 40 B3 from "
            f"pair_tangent_mma: {[s['route_launches'] for s in shards]}")
    require(len({s["seed"] for s in shards} | {whole["seed"]}) == 3,
            "17c: the shards draw from streams of their own")
    require(fan_s.shape == ref_s.shape == (n, 2, N_ATOMS, 3)
            and np.allclose(fan_s, ref_s, rtol=1e-4, atol=1e-5),
            "17c: the merged samples equal the unsharded run's (rtol 1e-4, atol 1e-5)")
    require(fan_d.shape == ref_d.shape == (n,) and np.isfinite(fan_d).all(),
            "17c: the merged dlogps are finite and of the unsharded shape")
    require(not np.allclose(fan_d, ref_d), "17c: other probe streams, other dlogps")


def phase_parallel(model, template, card: str) -> dict:
    """17. The parallel layer on the card; returns the launch counts of the
    chain-sharded main path (a)."""
    import torch.distributed as dist

    from ti_torch.parallel import init_distributed, make_mesh

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rank, world = init_distributed(BACKEND, device=DEVICE, init_method=f"file://{tmp}/store",
                                       rank=0, world_size=1, local_rank=0, timeout_s=120)
        try:
            require((rank, world, dist.get_backend()) == (0, 1, BACKEND),
                    f"{BACKEND} at world size 1")
            mesh = make_mesh(device_type=DEVICE)
            require(mesh.device_type == DEVICE and mesh.mesh_dim_names == ("data",),
                    f"a 1-D {DEVICE} mesh")
            launches = _main_path_sharded(model, template, mesh, card)
            _lane_divergence_and_update(model, template, mesh, card)
        finally:
            dist.destroy_process_group()
    _fanout(model, card)
    log(f"[17 parallel] phase {time.perf_counter() - t_phase:.3f} s ({card})")
    return launches
