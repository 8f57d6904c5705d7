"""Optional Weights & Biases metric logging with a print fallback (copy of
ti_tpu/utils/logging.py's ``MetricLogger``).

wandb if requested and importable, otherwise stdout: the reference's
``use_wandb`` convention.
"""

from __future__ import annotations

from typing import Dict, Optional


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
