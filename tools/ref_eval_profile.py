"""Where one right-hand-side evaluation of the reference's sampler spends
its time: the velocity and its exact divergence (57 forward-mode JVP lanes
under ``torch.func``) of 12 chains at the 00031 width (19 atoms, F = 128,
5 layers, random weights from ``torch.manual_seed(0)``), the unit that
``sample_ambient(ambient_preset("00031"))`` pays about 700 times a chain
and ``bench.py``'s reference shape prices.

1. one evaluation's time, CUDA events over 5 after warm-up, for the dense
   form, the edge form and ``impl="dense_fused"`` (B4, B5), with the lanes
   all at once and in blocks of 19 (``div_chunk``), beside the velocity
   alone;
2. a ``torch.profiler`` trace of one dense evaluation: the device's busy
   share of the window and the kernels that take most of its time;
3. the peak device memory of one dense evaluation.

Needs a card:

    python3 tools/ref_eval_profile.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule  # noqa: E402
from ti_torch.models.cpainn import CPaiNN  # noqa: E402
from ti_torch.sampling.drivers import molecular_v_fn_of  # noqa: E402
from ti_torch.sampling.integrators import _make_rhs_joint  # noqa: E402

N_ATOMS, F, LAYERS, CHAINS = 19, 128, 5, 12


def event_ms(fn, n: int = 5) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_us(event) -> float:
    """An op's own device time in the trace, in µs (the attribute's name
    changed across PyTorch versions)."""
    t = getattr(event, "self_device_time_total", None)
    return t if t is not None else event.self_cuda_time_total


def main() -> int:
    if not torch.cuda.is_available():
        print("ref_eval_profile: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.manual_seed(0)
    model = CPaiNN(F, LAYERS, n_atoms=N_ATOMS)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2)
    rng = np.random.default_rng(11)
    x0 = 0.1 * rng.standard_normal((CHAINS, N_ATOMS, 3))
    x = torch.as_tensor(x0 - x0.mean(1, keepdims=True), dtype=torch.float32, device="cuda")
    temps = torch.tensor([[1000.0, 300.0]] * CHAINS, device="cuda")

    rhs_of = {}
    for impl in ("dense", "edge", "dense_fused"):
        v = molecular_v_fn_of(model, None, template, impl=impl, device="cuda")(temps)
        for chunk in (None, 19):
            rhs_of[impl, chunk] = _make_rhs_joint(v, True, "exact", div_chunk=chunk)
        rhs_of[impl, "velocity"] = _make_rhs_joint(v, False)
    with torch.no_grad():
        times = {key: [] for key in rhs_of}
        for order in (list(rhs_of), list(reversed(list(rhs_of)))):  # in turns
            for key in order:
                times[key].append(event_ms(lambda: rhs_of[key](x, 0.5, 0)))
        for (impl, what), ts in times.items():
            label = ("velocity alone" if what == "velocity" else
                     "velocity + exact divergence, " + ("57 lanes at once" if what is None
                                                         else f"lanes in blocks of {what}"))
            print(f"[{impl}] {label}: " + " and ".join(f"{t:.3f}" for t in ts)
                  + f" ms an evaluation ({card})", flush=True)

        rhs = rhs_of["dense", None]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rhs(x, 0.5, 0)
        torch.cuda.synchronize()
        print(f"[dense] peak device memory of one evaluation: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rhs(x, 0.5, 0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the device's own entries (kernels, copies): an aten op's entry
        # repeats the time of the kernels it launched
        events = [e for e in prof.key_averages()
                  if e.device_type != torch.autograd.DeviceType.CPU]
        dev_us = sum(device_us(e) for e in events)
        print(f"[dense, profiled] one evaluation: {1e3 * wall:.3f} ms of host wall clock, "
              f"{dev_us / 1e3:.3f} ms of device time (busy {dev_us / (1e6 * wall):.1%} of the "
              f"window; {card})", flush=True)
        for e in sorted(events, key=device_us, reverse=True)[:12]:
            print(f"  {e.key[:60]:60s} {device_us(e) / 1e3:9.3f} ms device "
                  f"({device_us(e) / max(dev_us, 1):.1%}), {e.count} calls", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
