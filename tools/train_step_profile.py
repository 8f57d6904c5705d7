"""Where an ambient training step's time goes, on one CUDA card.

For each training profile at the 00031 width (19 atoms, F = 128, 5 layers;
a fresh model, flax's laws, T0 = 1000 K and T1 = 300 K frames from
``make_synthetic_frames``): edge f32 at batch 12, dense f32 and dense
bf16_agg at batch 256, and dense bf16_agg at batch 64 (the oracle's), it
prints

- the wall time of an update step (host clock around steps that end in the
  optimizer's host sync), split into the loss with its gradients and the
  optimizer step, each synchronised;
- from ``torch.profiler`` over a few steps: the device time summed over
  kernels, so the card's busy share of the wall time, the kernel launches
  a step, and the ops with the most device time.

    python3 tools/train_step_profile.py

The last line of standard output is one JSON object with every number.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_ATOMS, F, LAYERS = 19, 128, 5
PROFILES = (("edge", "f32", 12), ("dense", "f32", 256), ("dense", "bf16_agg", 256),
            ("dense", "bf16_agg", 64))
STEPS, WARM, TRACED = 10, 3, 3


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("train_step_profile: no CUDA device is available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from ti_torch.config import ambient_preset
    from ti_torch.data.mdqm9 import (
        MDQM9AmbientDataset,
        make_synthetic_frames,
        make_synthetic_molecule,
    )
    from ti_torch.interpolants import linear
    from ti_torch.losses import molecular_velocity_loss
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.train import common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    mol = make_synthetic_molecule(N_ATOMS, seed=0)
    frames = np.concatenate([make_synthetic_frames(mol, 1024, T, seed=T) for T in (1000, 300)])
    temps = np.concatenate([np.full(1024, 1000.0), np.full(1024, 300.0)])
    ds = MDQM9AmbientDataset.from_arrays(frames, temps, mol)
    result = {"card": card}

    for impl, dtype, b in PROFILES:
        cfg = ambient_preset("00031", train_impl=impl, train_compute_dtype=dtype)
        model = CPaiNN(F, LAYERS, n_atoms=N_ATOMS,
                       generator=torch.Generator().manual_seed(0)).cuda()
        params = dict(model.named_parameters())
        apply = common.make_batched_apply(cfg, model, ds.template)
        interp = linear(a=cfg.a, gamma=cfg.gamma)
        opt = common.make_optimizer(list(params.values()), 1e-4)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def loss_fn(g, x0, x1, tp):
            return molecular_velocity_loss(apply, params, x0, x1, tp, interp, generator=g)

        step = common.make_update_step(loss_fn, opt)
        x0s, T0 = ds.epoch_batches(torch.Generator().manual_seed(1), b, device="cuda")
        x1s, T1 = ds.epoch_batches(torch.Generator().manual_seed(2), b, device="cuda")
        tps = torch.stack([T0, T1], -1)

        def batch(i):
            i %= len(x0s)
            return x0s[i], x1s[i], tps[i]

        for i in range(WARM):
            step(gen, *batch(i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(STEPS):
            step(gen, *batch(i))
        wall = (time.perf_counter() - t0) / STEPS * 1e3

        # the loss with its gradients, then the optimizer, each synchronised
        grad_ms = opt_ms = 0.0
        for i in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = loss_fn(gen, *batch(i))
            grads = common._grads(loss, opt.params)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            opt.step(loss, grads)
            torch.cuda.synchronize()
            grad_ms += (t1 - t0) / STEPS * 1e3
            opt_ms += (time.perf_counter() - t1) / STEPS * 1e3

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(TRACED):
                step(gen, *batch(i))
            torch.cuda.synchronize()
            traced_wall = (time.perf_counter() - t0) / TRACED * 1e3
        events = prof.key_averages()

        def device_us(e):
            return (getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0))

        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / TRACED
        top = sorted(events, key=device_us, reverse=True)[:8]
        name = f"{impl} {dtype} B={b}"
        row = {"ms_per_step": wall, "molecules_per_s": b / wall * 1e3,
               "loss_and_grad_ms": grad_ms, "optimizer_ms": opt_ms,
               "traced_ms_per_step": traced_wall, "device_ms_per_step": device_ms,
               "device_busy_share": device_ms / traced_wall,
               "kernel_launches_per_step": len(kernels) / TRACED,
               "top_ops_device_ms_per_step": {e.key: device_us(e) / 1e3 / TRACED for e in top}}
        result[name] = row
        print(f"[{name}] {wall:.3f} ms a step ({b / wall * 1e3:.1f} molecules/s): loss and "
              f"gradients {grad_ms:.3f} ms, optimizer {opt_ms:.3f} ms, synchronised; traced: "
              f"{device_ms:.3f} ms of device time in {traced_wall:.3f} ms a step "
              f"({100 * device_ms / traced_wall:.1f}% busy), {len(kernels) / TRACED:.0f} kernel "
              f"launches a step ({card})", flush=True)
        for e in top:
            print(f"    {device_us(e) / 1e3 / TRACED:9.3f} ms  {e.key[:90]}", flush=True)
        del model, params, opt, step, x0s, x1s, prof
        torch.cuda.empty_cache()

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
