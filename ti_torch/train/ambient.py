"""MDQM9 ambient (T0→T1) training loop (port of ti_tpu/train/ambient.py).

Semantics kept from ti_tpu and the reference:
- two datasets over the T0s and T1s temperature lists, independently
  shuffled each epoch so temperature pairs recombine;
- per-epoch-best parameters by training-batch loss: the loss is that of the
  parameters BEFORE the step, the parameters kept are those AFTER it;
- after each epoch, the train stream re-evaluated on the final parameters;
- NaN guard, clip(1.0), Adam, ReduceLROnPlateau(0.5, 10) on the epoch's
  mean loss;
- last and epoch-best checkpoints every epoch.

The training forward is ``apply_edge`` or ``apply_dense`` under autograd:
no CUDA kernel of the port has a backward, and ti_tpu trains through none
of its Pallas kernels either. One host sync a step (the loss and the
gradient norm) serves the NaN guard, the clip and the best-params check.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ti_torch import interpolants, resolve_device
from ti_torch.config import MDQM9Config, clone_config
from ti_torch.data.mdqm9 import MDQM9AmbientDataset
from ti_torch.losses import molecular_velocity_loss
from ti_torch.models.cpainn import CPaiNN
from ti_torch.train import common
from ti_torch.utils.logging import MetricLogger


def build_ambient_model(cfg: MDQM9Config, n_atoms: Optional[int] = None,
                        generator: Optional[torch.Generator] = None) -> CPaiNN:
    """The ambient CPaiNN of ``cfg``; ``n_atoms`` sizes the atom-id table as
    ti_tpu's ``model.init`` does from the graph."""
    return CPaiNN(
        cfg.n_features,
        cfg.score_layers,
        n_atoms=n_atoms,
        temp_length=cfg.temp_length,
        conditioning="ambient",
        # cutoff >= 1000 is the reference configs' complete-graph sentinel
        cutoff=None if cfg.cutoff >= 1000.0 else float(cfg.cutoff),
        generator=generator,
    )


def _resume_epoch(model_epoch) -> int:
    """The first epoch after checkpoint ``model_epoch`` ("12" or "best12")."""
    try:
        return int(str(model_epoch).removeprefix("best")) + 1
    except ValueError:
        return 0


def train_ambient(
    cfg: MDQM9Config,
    dataset0: Optional[MDQM9AmbientDataset] = None,
    dataset1: Optional[MDQM9AmbientDataset] = None,
    logger: Optional[MetricLogger] = None,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    device=None,
) -> Dict:
    """Train the ambient velocity field; runs on ``cuda`` unless ``device``
    says otherwise.

    Returns ``params`` and ``best_params`` (CPaiNN state dicts, detached, on
    the device: ``sample_ambient`` takes either as it is), ``model``,
    ``template``, ``history`` and ``state`` (the ``common.Optimizer``: lr,
    nan_count, Adam's moments). All draws come from generators seeded by
    ``cfg.seed``: the initialisation and the epoch shuffles on the CPU, t
    and z on the device.
    """
    dev = resolve_device(device)
    logger = logger or MetricLogger(cfg.use_wandb, cfg.project_name, cfg.model_save_name)
    save_dir = os.path.join(cfg.model_save_path, cfg.model_save_name)

    # resume: reload weights and offset the epoch counter
    min_epoch = 0
    if cfg.use_pretrained and init_params is None:
        init_params = common.load_checkpoint(
            common.checkpoint_path(save_dir, cfg.model_save_name, cfg.model_epoch))
        min_epoch = _resume_epoch(cfg.model_epoch)

    def load(Ts):
        return MDQM9AmbientDataset.load(
            cfg.traj_path, cfg.sdf_path, cfg.mdqm9_traj_filename, cfg.sdf_filename,
            split="train", Ts=Ts, scale=cfg.scale_trajs,
        )

    dataset0 = dataset0 if dataset0 is not None else load(cfg.T0s)
    dataset1 = dataset1 if dataset1 is not None else load(cfg.T1s)
    template = dataset0.template

    host_gen = torch.Generator().manual_seed(int(cfg.seed))
    model = build_ambient_model(cfg, template.n_atoms, generator=host_gen)
    if init_params is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in init_params.items()})
    model.to(dev)
    params = dict(model.named_parameters())
    draw_gen = torch.Generator(device=dev).manual_seed(int(cfg.seed) + 1)

    interp = interpolants.linear(a=cfg.a, gamma=cfg.gamma)
    batched_apply = common.make_batched_apply(cfg, model, template)
    remat = bool(getattr(cfg, "loss_remat", False))

    def loss_fn(gen, x0, x1, temps):
        return molecular_velocity_loss(batched_apply, params, x0, x1, temps, interp,
                                       generator=gen, t_distr=cfg.t_distr, remat=remat)

    opt = common.make_optimizer(list(params.values()), cfg.learning_rate,
                                weight_decay=cfg.weight_decay, clip=1.0)
    update = common.make_update_step(loss_fn, opt, accum_steps=getattr(cfg, "grad_accum", 1) or 1)

    scheduler = common.ReduceLROnPlateau(factor=0.5, patience=10)
    history = {"train_loss": [], "last_train_loss": [], "epoch_best_loss": []}
    os.makedirs(save_dir, exist_ok=True)
    clone_config(cfg, cfg.model_save_path, cfg.model_save_name)

    def snapshot():
        return {k: p.detach().clone() for k, p in params.items()}

    best_params = snapshot()
    for epoch in range(min_epoch, min_epoch + cfg.n_epochs):
        x0s, T0 = dataset0.epoch_batches(host_gen, cfg.batch_size, device=dev)
        x1s, T1 = dataset1.epoch_batches(host_gen, cfg.batch_size, device=dev)
        nb = min(len(x0s), len(x1s))
        temps = torch.stack([T0[:nb], T1[:nb]], dim=-1)  # (nb, B, 2)

        best_loss, best_params = float("inf"), snapshot()
        losses = []
        for i in range(nb):
            loss = update(draw_gen, x0s[i], x1s[i], temps[i])
            losses.append(loss)
            if loss < best_loss:  # the loss before the step, the params after it
                best_loss = loss
                torch._foreach_copy_(list(best_params.values()),
                                     [p.detach() for p in params.values()])
        with torch.no_grad():
            last_train_loss = torch.stack(
                [loss_fn(draw_gen, x0s[i], x1s[i], temps[i]) for i in range(nb)]).mean().item()
        train_loss = float(np.mean(losses))

        new_lr = scheduler.step(train_loss, opt.lr)
        opt.lr = new_lr

        history["train_loss"].append(train_loss)
        history["last_train_loss"].append(last_train_loss)
        history["epoch_best_loss"].append(float(best_loss))
        logger.log(
            {
                "train_loss": train_loss,
                "last_model_train_loss": last_train_loss,
                "epoch_best_loss": float(best_loss),
                "lr": new_lr,
                "nan_steps": opt.nan_count,
            },
            step=epoch,
        )
        common.save_checkpoint(common.checkpoint_path(save_dir, cfg.model_save_name, epoch),
                               params)
        common.save_checkpoint(
            common.checkpoint_path(save_dir, cfg.model_save_name, f"best{epoch}"), best_params)

    logger.finish()
    return {
        "params": snapshot(),
        "best_params": best_params,
        "model": model,
        "template": template,
        "history": history,
        "state": opt,
    }
