"""Optional Weights & Biases metric logging with a print fallback (copy of
ti_tpu/utils/logging.py's ``MetricLogger``), and ``profile_trace``, a
``torch.profiler`` trace around a region (port of its ``profile_trace``).

wandb if requested and importable, otherwise stdout: the reference's
``use_wandb`` convention.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

from ti_torch import resolve_device


class MetricLogger:
    def __init__(self, use_wandb: bool = False, project: str = "", name: str = ""):
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # noqa: PLC0415

                wandb.init(project=project, name=name)
                self._wandb = wandb
            except Exception as e:  # pragma: no cover - wandb not installed
                print(f"[MetricLogger] wandb unavailable ({e}); falling back to stdout")

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        else:
            parts = " ".join(
                f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in metrics.items()
            )
            print(f"[step {step}] {parts}" if step is not None else parts)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], device=None):
    """A ``torch.profiler`` trace of the region, exported as one Chrome trace
    ``{log_dir}/trace_{pid}_{ns}.pt.trace.json`` (``ti_torch.utils.profiling``
    and ``python -m ti_torch.cli.profile_summary`` read it back). It records
    the CPU and, on the card, CUDA activity, and synchronises the card
    before it stops, so the region's kernels are in the trace. With
    ``log_dir`` falsy it does nothing. Traces ``cuda`` unless ``device``
    says otherwise. Yields the profiler (``key_averages()``), or None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))
