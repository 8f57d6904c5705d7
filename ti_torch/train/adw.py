"""ADW training loop (port of ti_tpu/train/adw.py; reference
adw/train.py:18-110).

Semantics kept from ti_tpu and the reference:
- base samples at ``cfg.beta0s`` and target samples at ``cfg.beta1s``,
  80/10/10 splits, both training streams shuffled each epoch and cut to
  the shorter one's batches;
- the two-sided antithetic velocity loss on ``interpolants.linear(a,
  gamma)``; NaN guard, clip(1.0), Adam with L2 decay ``cfg.wd``;
- a validation pass each epoch, ReduceLROnPlateau(0.5, 10) on its loss;
- one checkpoint an epoch, ``{save_dir}/epoch_{epoch}.npz`` in the flax
  layout (``models/convert.save_npz``), which ti_tpu reads through
  ``params_to_flax``.

``cfg.dtype == "f64"`` is the reference's float64 training (adw/train.py:29)
as a plain torch dtype, on the card as on the CPU.

All draws come from generators seeded by ``cfg.seed``: the initialisation
and the epoch shuffles on the CPU, t and z on the device. ti_tpu shuffles
its validation split with the training keys of the same epoch
(ti_tpu/train/adw.py:124-125); the port cannot share JAX's draws and
shuffles it from its own CPU generator, after the training splits.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ti_torch import interpolants, resolve_device
from ti_torch.config import ADWConfig, clone_config
from ti_torch.data.adw import ADWDataset
from ti_torch.losses import adw_velocity_loss
from ti_torch.models.mlp import FCNetMultiBeta, apply_fcnet, param_dtype
from ti_torch.train import common
from ti_torch.utils.logging import MetricLogger


def build_adw_model(cfg: ADWConfig, generator: Optional[torch.Generator] = None
                    ) -> FCNetMultiBeta:
    """The ADW velocity field of ``cfg`` (1-D, its width, depth and dtype)."""
    return FCNetMultiBeta(in_size=1, out_size=1, hidden_size=cfg.hidden_size,
                          num_layers=cfg.num_layers, dtype=param_dtype(cfg.dtype),
                          generator=generator)


def make_adw_loss(cfg: ADWConfig, model: FCNetMultiBeta, params: Dict[str, torch.Tensor]):
    """``loss(generator, x0, x1, beta0, beta1, t=None, z=None)``: the
    antithetic velocity loss of ``model``'s architecture on ``params`` over
    ``interpolants.linear(cfg.a, cfg.gamma)``, its t and z drawn from
    ``generator`` unless pinned."""
    interp = interpolants.linear(a=cfg.a, gamma=cfg.gamma)

    def apply_fn(p, xt, t, b0, b1):
        return apply_fcnet(model, p, xt, t, b0, b1)

    def loss(generator, x0, x1, beta0, beta1, t=None, z=None):
        return adw_velocity_loss(apply_fn, params, x0, x1, beta0, beta1, interp,
                                 generator=generator, t=t, z=z)

    return loss


def train_adw(
    cfg: ADWConfig,
    base_data: Optional[ADWDataset] = None,
    target_data: Optional[ADWDataset] = None,
    logger: Optional[MetricLogger] = None,
    device=None,
) -> Dict:
    """Train the ADW velocity field; runs on ``cuda`` unless ``device``
    says otherwise.

    Returns ``params`` (the state dict, detached, on the device:
    ``sample_adw`` takes it as it is), ``model``, ``history``
    (``train_loss``, ``val_loss``) and ``state`` (the ``common.Optimizer``:
    lr, nan_count, Adam's moments).
    """
    dev = resolve_device(device)
    dt = param_dtype(cfg.dtype)
    logger = logger or MetricLogger(cfg.use_wandb, cfg.project_name, cfg.model_save_name)

    csv = os.path.join(cfg.traj_path, cfg.traj_filename)
    if base_data is None:
        base_data = ADWDataset.from_csv(csv, cfg.beta0s, cfg.n_samples, seed=cfg.seed)
    if target_data is None:
        target_data = ADWDataset.from_csv(csv, cfg.beta1s, cfg.n_samples, seed=cfg.seed)
    train0, val0, _ = base_data.splits()
    train1, val1, _ = target_data.splits()

    host_gen = torch.Generator().manual_seed(int(cfg.seed))
    model = build_adw_model(cfg, generator=host_gen).to(dev)
    params = dict(model.named_parameters())
    draw_gen = torch.Generator(device=dev).manual_seed(int(cfg.seed) + 1)
    loss_fn = make_adw_loss(cfg, model, params)
    opt = common.make_optimizer(list(params.values()), cfg.lr, weight_decay=cfg.wd, clip=1.0)
    update = common.make_update_step(loss_fn, opt)
    scheduler = common.ReduceLROnPlateau(factor=0.5, patience=10)
    history = {"train_loss": [], "val_loss": []}

    save_dir = os.path.join(cfg.model_save_path, cfg.model_save_name)
    os.makedirs(save_dir, exist_ok=True)
    clone_config(cfg, cfg.model_save_path, cfg.model_save_name)

    def batches(ds0, ds1):
        x0s, b0s = ds0.epoch_batches(host_gen, cfg.batch_size, device=dev, dtype=dt)
        x1s, b1s = ds1.epoch_batches(host_gen, cfg.batch_size, device=dev, dtype=dt)
        nb = min(len(x0s), len(x1s))
        return nb, (x0s, x1s, b0s, b1s)

    for epoch in range(cfg.epochs):
        nb, train = batches(train0, train1)
        losses = [update(draw_gen, *(a[i] for a in train)) for i in range(nb)]
        train_loss = float(np.mean(losses))

        nv, val = batches(val0, val1)
        with torch.no_grad():
            # a validation split smaller than one batch holds no batch: NaN,
            # as the mean over ti_tpu's empty scan gives
            val_loss = torch.stack(
                [loss_fn(draw_gen, *(a[i] for a in val)) for i in range(nv)]
            ).mean().item() if nv else float("nan")

        new_lr = scheduler.step(val_loss, opt.lr)
        opt.lr = new_lr
        history["train_loss"].append(train_loss)
        history["val_loss"].append(val_loss)
        logger.log({"train_loss": train_loss, "val_loss": val_loss, "lr": new_lr,
                    "nan_steps": opt.nan_count}, step=epoch)
        common.save_checkpoint(os.path.join(save_dir, f"epoch_{epoch}.npz"), params)

    logger.finish()
    return {"params": {k: p.detach().clone() for k, p in params.items()}, "model": model,
            "history": history, "state": opt}
