"""MDQM9 latent (noise→data Boltzmann generator) training loop (port of
ti_tpu/train/latent.py).

Semantics kept from ti_tpu and the reference (mdqm9/train_latent.py):
- one dataset; each epoch pairs the shuffled frames with fresh COM-free
  noise, Kabsch-aligned onto them under ``align``;
- the one-sided linear interpolant x_t = (1 - t) x0 + t x1 and its
  velocity loss;
- the model is conditioned on the temperature ("latent", K = 1) when
  trained on several, else unconditioned ("none", K = 0);
- NaN guard, clip(1.0), Adam, ReduceLROnPlateau(0.5, 10) on the epoch's
  mean loss, and the train stream re-evaluated on the final parameters;
- one checkpoint ``{name}_{epoch}.npz`` a epoch; no epoch-best tracking
  (the reference latent trainer has none).

The forward is ``apply_edge`` or ``apply_dense`` under autograd, as in
``train_ambient``: no CUDA kernel of the port has a backward.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ti_torch import interpolants, resolve_device
from ti_torch.config import MDQM9Config, clone_config
from ti_torch.data.mdqm9 import MDQM9LatentDataset
from ti_torch.losses import molecular_velocity_loss
from ti_torch.models.cpainn import CPaiNN
from ti_torch.train import common
from ti_torch.utils.logging import MetricLogger


def build_latent_model(cfg: MDQM9Config, n_atoms: Optional[int] = None,
                       generator: Optional[torch.Generator] = None) -> CPaiNN:
    """The latent CPaiNN of ``cfg``: conditioned on the temperature, and
    centred and scaled by the temperatures it trains on, when ``cfg.T``
    holds several; unconditioned otherwise. ``n_atoms`` sizes the atom-id
    table as ti_tpu's ``model.init`` does from the graph."""
    multi_t = len(cfg.T) > 1
    kwargs = {"temperatures": tuple(float(t) for t in cfg.T)} if multi_t else {}
    return CPaiNN(
        cfg.n_features,
        cfg.score_layers,
        n_atoms=n_atoms,
        temp_length=cfg.temp_length,
        conditioning="latent" if multi_t else "none",
        # cutoff >= 1000 is the reference configs' complete-graph sentinel
        cutoff=None if cfg.cutoff >= 1000.0 else float(cfg.cutoff),
        generator=generator,
        **kwargs,
    )


def checkpoint_path(save_dir: str, name: str, epoch) -> str:
    """``{save_dir}/{name}_{epoch}.npz``, the latent trainer's checkpoint."""
    return os.path.join(save_dir, f"{name}_{epoch}.npz")


def train_latent(
    cfg: MDQM9Config,
    dataset: Optional[MDQM9LatentDataset] = None,
    logger: Optional[MetricLogger] = None,
    device=None,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict:
    """Train the latent velocity field; runs on ``cuda`` unless ``device``
    says otherwise.

    Returns ``params`` (a CPaiNN state dict, detached, on the device:
    ``sample_latent`` takes it as it is), ``model``, ``template``,
    ``history`` (``train_loss``, ``last_train_loss``) and ``state`` (the
    ``common.Optimizer``). ``init_params`` replaces the fresh
    initialisation. All draws come from generators seeded by ``cfg.seed``:
    the initialisation, the shuffles and the noise on the CPU, t on the
    device.
    """
    dev = resolve_device(device)
    logger = logger or MetricLogger(cfg.use_wandb, cfg.project_name, cfg.model_save_name)
    if dataset is None:
        dataset = MDQM9LatentDataset.load(
            cfg.traj_path, cfg.sdf_path, cfg.mdqm9_traj_filename, cfg.sdf_filename,
            split="train", Ts=cfg.T, scale=cfg.scale_trajs, align=cfg.align,
        )
    template = dataset.template

    host_gen = torch.Generator().manual_seed(int(cfg.seed))
    model = build_latent_model(cfg, template.n_atoms, generator=host_gen)
    if init_params is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in init_params.items()})
    model.to(dev)
    params = dict(model.named_parameters())
    draw_gen = torch.Generator(device=dev).manual_seed(int(cfg.seed) + 1)

    interp = interpolants.one_sided_linear()
    batched_apply = common.make_batched_apply(cfg, model, template)
    remat = bool(getattr(cfg, "loss_remat", False))

    def loss_fn(gen, x0, x1, temps):
        return molecular_velocity_loss(batched_apply, params, x0, x1, temps, interp,
                                       generator=gen, t_distr=cfg.t_distr, remat=remat)

    opt = common.make_optimizer(list(params.values()), cfg.learning_rate,
                                weight_decay=cfg.weight_decay, clip=1.0)
    update = common.make_update_step(loss_fn, opt, accum_steps=getattr(cfg, "grad_accum", 1) or 1)

    scheduler = common.ReduceLROnPlateau(factor=0.5, patience=10)
    history = {"train_loss": [], "last_train_loss": []}
    save_dir = os.path.join(cfg.model_save_path, cfg.model_save_name)
    os.makedirs(save_dir, exist_ok=True)
    clone_config(cfg, cfg.model_save_path, cfg.model_save_name)

    for epoch in range(cfg.n_epochs):
        x0s, x1s, T = dataset.epoch_batches(host_gen, cfg.batch_size, device=dev)
        temps = T[..., None][..., :template.t_cond]  # (nb, B, 0 or 1)
        losses = [update(draw_gen, x0s[i], x1s[i], temps[i]) for i in range(len(x0s))]
        with torch.no_grad():
            last_train_loss = torch.stack(
                [loss_fn(draw_gen, x0s[i], x1s[i], temps[i]) for i in range(len(x0s))]
            ).mean().item()
        train_loss = float(np.mean(losses))

        new_lr = scheduler.step(train_loss, opt.lr)
        opt.lr = new_lr
        history["train_loss"].append(train_loss)
        history["last_train_loss"].append(last_train_loss)
        logger.log(
            {"train_loss": train_loss, "last_model_train_loss": last_train_loss,
             "lr": new_lr, "nan_steps": opt.nan_count},
            step=epoch,
        )
        common.save_checkpoint(checkpoint_path(save_dir, cfg.model_save_name, epoch), params)

    logger.finish()
    return {
        "params": {k: p.detach().clone() for k, p in params.items()},
        "model": model,
        "template": template,
        "history": history,
        "state": opt,
    }
