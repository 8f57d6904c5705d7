"""Shared training machinery: optimizer, plateau LR, NaN guard, checkpoints
(port of ti_tpu/train/common.py).

The reference's training semantics:

- Adam with L2 weight decay folded into the gradient BEFORE the moment
  estimates (as ``torch.optim.Adam``'s ``weight_decay``), not decoupled
  AdamW;
- global-norm gradient clipping at 1.0 on the raw gradients, before the
  decay term, as optax's ``clip_by_global_norm`` does it: g·(clip/‖g‖)
  written (g / ‖g‖)·clip, when ‖g‖ >= clip (``clip_grad_norm_`` would divide
  by ‖g‖ + 1e-6 instead);
- the learning rate is a runtime scalar, which ``ReduceLROnPlateau``
  (factor 0.5, patience 10) changes between epochs;
- "safe backprop": a step whose loss is not finite moves no parameter, no
  Adam moment and no step count, and counts the event;
- checkpoints hold the parameters only, as the flax-layout ``.npz`` of
  ``models/convert.save_npz``, which ti_tpu reads through
  ``params_to_flax``/``params_from_flax``.

One host sync a step reads the loss and the gradient norm together: the
NaN guard and the clip decide on the host.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ti_torch.models.convert import load_npz, save_npz


class Optimizer:
    """clip → + wd·θ → Adam → θ −= lr·u over ``params``, in optax's
    arithmetic (b1 0.9, b2 0.999, eps 1e-8).

    Written with ``torch._foreach_*`` ops rather than ``torch.optim.Adam``
    because of the bias corrections: optax forms 1 − b2^count in f32 from
    b2 rounded to f32 (1 − 0.999f = 9.99987e-4, 1.3e-5 off), torch in
    double from the exact b2, so their first update differs by 6.7e-6
    relative. ``mu``, ``nu`` and ``count`` are the moments and the step
    count. It also carries what ti_tpu's ``TrainState`` carries besides the
    parameters: the runtime ``lr`` and ``nan_count``, the number of steps
    the NaN guard skipped.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 weight_decay: float = 0.0, clip: Optional[float] = 1.0):
        self.params: List[torch.Tensor] = list(params)
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)
        self.clip = clip
        self.mu = [torch.zeros_like(p, memory_format=torch.preserve_format) for p in self.params]
        self.nu = [torch.zeros_like(p, memory_format=torch.preserve_format) for p in self.params]
        self.count = 0
        self.nan_count = 0

    def _bias_correction(self, decay: float) -> torch.Tensor:
        """1 − decay^count in f32, as optax forms it."""
        d = torch.tensor(decay, dtype=torch.float32)
        return 1.0 - torch.pow(d, torch.tensor(float(self.count), dtype=torch.float32))

    def step(self, loss: torch.Tensor, grads: List[torch.Tensor]) -> float:
        """Apply ``grads`` unless ``loss`` is not finite; returns the loss.
        ``grads`` is consumed (overwritten in place)."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        loss_v, norm_v = torch.stack([loss.detach().float(), norm.float()]).tolist()
        if not math.isfinite(loss_v):
            self.nan_count += 1
            return loss_v
        with torch.no_grad():
            params = [p.detach() for p in self.params]
            if self.clip is not None and not norm_v < self.clip:
                torch._foreach_div_(grads, norm_v)
                torch._foreach_mul_(grads, float(self.clip))
            if self.weight_decay:
                torch._foreach_add_(grads, torch._foreach_mul(params, self.weight_decay))
            # moments: (1 − b) g + b m and (1 − b2) g² + b2 v
            torch._foreach_mul_(self.mu, self.b1)
            torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - self.b1))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - self.b2)
            torch._foreach_mul_(self.nu, self.b2)
            torch._foreach_add_(self.nu, sq)
            self.count += 1
            bc1, bc2 = self._bias_correction(self.b1), self._bias_correction(self.b2)
            mu_hat = torch._foreach_div(self.mu, bc1.item())
            den = torch._foreach_div(self.nu, bc2.item())
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            torch._foreach_div_(mu_hat, den)  # the update u
            lr = torch.tensor(self.lr, dtype=torch.float32).item()
            torch._foreach_mul_(mu_hat, lr)
            torch._foreach_sub_(params, mu_hat)
        return loss_v


def make_optimizer(params: Sequence[torch.Tensor], lr: float, weight_decay: float = 0.0,
                   clip: Optional[float] = 1.0) -> Optimizer:
    """clip(1.0) → +wd·θ → Adam moments, with ``lr`` a runtime scalar."""
    return Optimizer(params, lr, weight_decay=weight_decay, clip=clip)


def _grads(loss: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def make_update_step(
    loss_fn: Callable[..., torch.Tensor],
    optimizer: Optimizer,
    accum_steps: int = 1,
) -> Callable:
    """Build ``step(generator, *batch) -> loss`` (a float) over
    ``optimizer.params``, with the NaN guard. ``loss_fn(generator, *batch)``
    returns the scalar loss of the live parameters.

    ``accum_steps > 1`` splits the batch into that many microbatches along
    its first axis, each with its own draws from ``generator``, and takes
    ONE optimizer step on the mean of their gradients (the loss is the mean
    of theirs): activation memory stays at the microbatch size.
    """
    params = optimizer.params

    def step(generator, *batch) -> float:
        if accum_steps == 1:
            loss = loss_fn(generator, *batch)
            return optimizer.step(loss, _grads(loss, params))
        micro = [a.reshape(accum_steps, a.shape[0] // accum_steps, *a.shape[1:]) for a in batch]
        grads, loss = None, None
        for i in range(accum_steps):
            l = loss_fn(generator, *(m[i] for m in micro))
            g = _grads(l, params)
            if grads is None:
                grads, loss = g, l.detach()
            else:
                torch._foreach_add_(grads, g)
                loss = loss + l.detach()
        torch._foreach_div_(grads, float(accum_steps))
        return optimizer.step(loss / accum_steps, grads)

    return step


def make_batched_apply(cfg, model, template):
    """The training forward (config ``train_impl`` / ``train_compute_dtype``):
    ``apply(params, x (B,N,3), t (B,), temps (B,K)) -> (B,N,3)``.

    "edge" is ``apply_edge``, the gather/scatter form ti_tpu trains through
    by default, f32 only; "dense" is the dense pair form ``apply_dense`` in
    f32, bf16 or bf16_agg (never ``fused=True``: the fused kernels have no
    backward).
    """
    impl = getattr(cfg, "train_impl", "edge")
    dtype_name = getattr(cfg, "train_compute_dtype", "f32")
    if impl == "edge":
        if dtype_name != "f32":
            raise ValueError(
                "train_compute_dtype != f32 requires train_impl='dense' "
                "(the edge impl has no mixed-precision profile)"
            )
        from ti_torch.models.cpainn import apply_edge as fwd

        compute_dtype = None
    elif impl == "dense":
        from ti_torch.models.cpainn_dense import apply_dense as fwd
        from ti_torch.ops.mlp_block import BF16

        cd = {"f32": None, "bf16": BF16, "bf16_agg": "bf16_agg"}
        if dtype_name not in cd:
            raise ValueError(f"unknown train_compute_dtype {dtype_name!r}")
        compute_dtype = cd[dtype_name]
    else:
        raise ValueError(f"unknown train_impl {impl!r} (use 'edge' or 'dense')")

    def batched_apply(params, x, t, temps):
        return fwd(model, params, x, t, temps, template.atom_ids, template.edges,
                   compute_dtype=compute_dtype)

    return batched_apply


@dataclasses.dataclass
class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (min mode,
    rel threshold): after ``patience`` epochs without a >threshold relative
    improvement, multiply LR by ``factor``."""

    factor: float = 0.5
    patience: int = 10
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = float("inf")
    num_bad: int = 0

    def step(self, metric: float, lr: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = float(metric)
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            lr = max(lr * self.factor, self.min_lr)
            self.num_bad = 0
        return lr


def checkpoint_path(save_dir: str, name: str, epoch) -> str:
    """``{save_dir}/{name}_{epoch}_weights.npz`` (``epoch`` may be "best12")."""
    return os.path.join(save_dir, f"{name}_{epoch}_weights.npz")


def save_checkpoint(path: str, params: Dict[str, torch.Tensor]) -> None:
    """Write a state dict as a flat flax-layout ``.npz``."""
    save_npz(path, params)


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a checkpoint into a state dict (CPU tensors)."""
    return load_npz(path)
