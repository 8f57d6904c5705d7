"""Training: the shared machinery (``common``) and the MDQM9 ambient
trainer (``ambient``). The latent and ADW trainers wait for their slices."""

from ti_torch.train.ambient import build_ambient_model, train_ambient
from ti_torch.train.common import (
    Optimizer,
    ReduceLROnPlateau,
    load_checkpoint,
    make_optimizer,
    save_checkpoint,
)

__all__ = [
    "Optimizer",
    "ReduceLROnPlateau",
    "build_ambient_model",
    "load_checkpoint",
    "make_optimizer",
    "save_checkpoint",
    "train_ambient",
]
