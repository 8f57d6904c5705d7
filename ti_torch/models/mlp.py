"""ADW velocity-field MLP (port of ti_tpu/models/mlp.py).

The reference FCNetMultiBeta (adw/thermo/models/simple.py:5-41): an MLP
over [x_t, t, beta_embed], where beta_embed is a small MLP over [beta0,
beta1, t], SiLU between the layers. Submodule names are flax's
(``beta_embed_0..2``, ``dense_0..{num_layers-1}``, ``dense_out``), so a
flax parameter tree maps onto the state dict through
``models/convert.params_from_flax``, and a fresh model draws as flax's
``model.init`` does: lecun-normal kernels, zero biases.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
import torch.nn.functional as F

from ti_torch.models.embeddings import dense_init_


def param_dtype(name: str) -> torch.dtype:
    """The torch dtype of ``ADWConfig.dtype``: "f32" or "f64"."""
    if name in ("f64", "float64"):
        return torch.float64
    if name not in ("f32", "float32"):
        raise ValueError(f"ADWConfig.dtype must be f32 or f64, got {name!r}")
    return torch.float32


class FCNetMultiBeta(nn.Module):
    """b(x_t, t, beta0, beta1) -> velocity, each argument shaped (..., dim)
    or (..., 1). ``dtype`` (torch.float32 or torch.float64) is the
    parameters' type; the reference trains ADW in float64
    (adw/train.py:29)."""

    def __init__(self, in_size: int = 1, out_size: int = 1, hidden_size: int = 256,
                 num_layers: int = 5, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        h = hidden_size
        widths = {"beta_embed_0": (3, h), "beta_embed_1": (h, h), "beta_embed_2": (h, 1)}
        widths.update({f"dense_{i}": (in_size + 2 if i == 0 else h, h)
                       for i in range(num_layers)})
        widths["dense_out"] = (h, out_size)
        for name, (f_in, f_out) in widths.items():
            layer = nn.Linear(f_in, f_out, dtype=dtype)
            dense_init_(layer, generator)
            self.add_module(name, layer)

    def forward(self, xt, t, beta0, beta1) -> torch.Tensor:
        return apply_fcnet(self, dict(self.named_parameters()), xt, t, beta0, beta1)


def apply_fcnet(model: FCNetMultiBeta, params: Dict[str, torch.Tensor], xt, t, beta0,
                beta1) -> torch.Tensor:
    """The forward of ``model``'s architecture on the state dict ``params``
    (as flax's ``model.apply(params, ...)``): concatenations in flax's
    orders, [beta0, beta1, t] for the embedding and [x_t, t, beta_embed]
    for the trunk."""

    def dense(name, h):
        return F.linear(h, params[f"{name}.weight"], params[f"{name}.bias"])

    h = torch.cat([beta0, beta1, t], dim=-1)
    h = F.silu(dense("beta_embed_0", h))
    h = F.silu(dense("beta_embed_1", h))
    z = torch.cat([xt, t, dense("beta_embed_2", h)], dim=-1)
    for i in range(model.num_layers):
        z = F.silu(dense(f"dense_{i}", z))
    return dense("dense_out", z)
