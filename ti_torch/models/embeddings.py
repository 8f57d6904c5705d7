"""Embedding blocks of the velocity field (port of ti_tpu/models/embeddings.py).

Reference: mdqm9/thermo/ambient/models/embedding.py.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F


def positional_encoding(x: torch.Tensor, dim: int, max_length: float) -> torch.Tensor:
    """Sin/cos positional encoding of a scalar feature tensor.

    For ranks r = 1..dim/2, emits (cos(x·rπ/L), sin(x·rπ/L)) interleaved
    per rank, giving shape (*x.shape, dim) — the reference's per-rank
    stack((cos, sin)) + concat.
    """
    if dim % 2:
        raise ValueError("dim must be even for sin/cos positional encoding")
    ranks = torch.arange(1, dim // 2 + 1, dtype=x.dtype, device=x.device)
    ang = (x[..., None] / max_length) * ranks * math.pi  # (..., R)
    enc = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)  # (..., R, 2)
    return enc.reshape(*x.shape, dim)


def temperature_encoding(
    T: torch.Tensor, dim: int, max_length: float, temperatures: Sequence[float]
) -> torch.Tensor:
    """Center by the mean of the training temperatures, scale by their
    range, then positionally encode (reference TemperatureEncoder). The
    statistics are those of the temperatures known at train time, which
    is what makes leave-one-temperature-out extrapolation work."""
    temps = torch.tensor(list(temperatures), dtype=T.dtype, device=T.device)
    x = (T - temps.mean()) / (temps.max() - temps.min())
    return positional_encoding(x, dim, max_length)


class MLP(nn.Module):
    """Linear-LayerNorm-SiLU ×2 -> Linear (reference embedding.MLP).

    Submodule names follow flax's auto-naming (Dense_0, LayerNorm_0, ...)
    so a flax parameter tree maps onto the state dict name by name.
    """

    def __init__(self, f_in: int, f_hidden: int, f_out: int):
        super().__init__()
        self.Dense_0 = nn.Linear(f_in, f_hidden)
        self.LayerNorm_0 = nn.LayerNorm(f_hidden, eps=1e-5)
        self.Dense_1 = nn.Linear(f_hidden, f_hidden)
        self.LayerNorm_1 = nn.LayerNorm(f_hidden, eps=1e-5)
        self.Dense_2 = nn.Linear(f_hidden, f_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.LayerNorm_0(self.Dense_0(x)))
        h = F.silu(self.LayerNorm_1(self.Dense_1(h)))
        return self.Dense_2(h)
