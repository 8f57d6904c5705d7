"""Device timing on the card (port of ti_tpu/utils/timing.py).

PyTorch returns from a CUDA call once the work is enqueued, so a host clock
read without a synchronise measures the enqueue, not the work. This module
times the card with CUDA events recorded on the stream around the calls:

- ``device_time(fn, *args, reps)`` records an event, makes ``reps`` calls
  ``fn(*args, i)`` (i = the rep index, so that each call differs), records a
  second event and synchronises; the time between the two events over
  ``reps`` is one run's figure, and the result is the best of 3 runs (the
  repo's best-of-N convention: shared-host wobble inflates means), in
  seconds a call. On the CPU (every tensor argument on the CPU, or
  ``device="cpu"``) the host clock times the calls, which there is the
  device's own clock.
- ``host_round_trip_latency`` is the least time of a tiny op followed by
  ``torch.cuda.synchronize()``: what one host fence costs.
- ``synchronize(dev)`` waits for the card (nothing on the CPU), the fence
  of a host-clock timing.
- ``Stopwatch`` names single-shot stage timings on the host clock;
  ``Stopwatch.fence(x)`` synchronises the card that holds ``x`` (nothing
  on the CPU), so a stage ends when its work does.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from ti_torch import resolve_device

_LATENCY: Dict[str, float] = {}


def synchronize(dev: torch.device) -> None:
    """Wait for the card ``dev`` is (nothing on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_round_trip_latency(refresh: bool = False, device=None) -> float:
    """Least seconds of a tiny op and a synchronise, over 5 tries (cached a
    device). Runs on ``cuda`` unless ``device`` says otherwise."""
    dev = resolve_device(device)
    if refresh or str(dev) not in _LATENCY:
        a = torch.zeros(8, 8, device=dev)
        (a + 1.0).sum()
        synchronize(dev)
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            (a + 1.0).sum()
            synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        _LATENCY[str(dev)] = best
    return _LATENCY[str(dev)]


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def device_time(fn: Callable, *args, reps: int = 8, device=None) -> float:
    """Seconds a call of ``fn(*args, i)``, i = 0..reps-1: CUDA events around
    ``reps`` calls, best of 3 runs after one warm-up call. The device is
    ``device``, else the first tensor argument's, else ``cuda``."""
    if device is None:
        t = _first_tensor(args)
        device = t.device if t is not None else None
    dev = resolve_device(device)
    fn(*args, 0)  # warm-up: builds, caches, allocations
    synchronize(dev)
    best = float("inf")
    for _ in range(3):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(reps):
                fn(*args, i)
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for i in range(reps):
                fn(*args, i)
            synchronize(dev)
            secs = time.perf_counter() - t0
        best = min(best, secs)
    return best / reps


class Stopwatch:
    """Named single-shot stage timings on the host clock.

    >>> sw = Stopwatch()
    >>> with sw("rollout"):
    ...     out = sampler(x0, conds, generator)
    ...     sw.fence(out.xs)          # the stage ends when the card's work does
    >>> print(sw.report())
    """

    def __init__(self):
        self.times: Dict[str, float] = {}
        self._name = None
        self._t0 = 0.0

    def __call__(self, name: str) -> "Stopwatch":
        self._name = name
        return self

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times[self._name] = self.times.get(self._name, 0.0) + (
            time.perf_counter() - self._t0
        )
        return False

    @staticmethod
    def fence(x) -> None:
        """Wait for the card that holds ``x`` (a tensor, or a list, tuple or
        dict holding one); nothing for a CPU tensor."""
        t = _first_tensor(x)
        if t is not None and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

    def report(self) -> str:
        total = sum(self.times.values()) or 1.0
        lines = [
            f"{k:>24s}: {v*1e3:9.2f} ms ({100*v/total:5.1f}%)"
            for k, v in sorted(self.times.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)
