"""Training: the shared machinery (``common``), the MDQM9 ambient trainer
(``ambient``), the latent Boltzmann-generator trainer (``latent``) and the
ADW trainer (``adw``)."""

from ti_torch.train.adw import build_adw_model, make_adw_loss, train_adw
from ti_torch.train.ambient import build_ambient_model, train_ambient
from ti_torch.train.common import (
    Optimizer,
    ReduceLROnPlateau,
    load_checkpoint,
    make_optimizer,
    save_checkpoint,
)
from ti_torch.train.latent import build_latent_model, train_latent

__all__ = [
    "Optimizer",
    "ReduceLROnPlateau",
    "build_adw_model",
    "build_ambient_model",
    "build_latent_model",
    "load_checkpoint",
    "make_adw_loss",
    "make_optimizer",
    "save_checkpoint",
    "train_adw",
    "train_ambient",
    "train_latent",
]
