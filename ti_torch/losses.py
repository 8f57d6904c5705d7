"""Antithetic interpolant-regression (velocity) losses (port of
ti_tpu/losses.py).

The quadratic objective:

    L = mean[ 0.5|b_+|^2 - (dtIt + gamma_dot z)·b_+
            + 0.5|b_-|^2 - (dtIt - gamma_dot z)·b_- ]         (two-sided)
    L = mean[ 0.5|b_+|^2 - dtIt·b_+ ]                          (one-sided)

Kept from the reference:
- molecular t is drawn per molecule and shared across its atoms, Uniform or
  Beta(0.5, 0.5) (latent: Beta(2, 1));
- x_t^± are mean-centred over ALL atoms of the whole batch, not per
  molecule;
- the one-sided loss skips the reference's unused forward on x_t^-.

Draws come from an explicit ``torch.Generator``: t first, then z. The
``t=``/``z=`` arguments pin them. A ``ChainShard`` in its place (one rank's
rows of a batch split over a process group, ti_torch.parallel.parallel_update)
draws the whole batch's t and z and keeps its rows, and the molecular loss
then centres x_t^± over the atoms of the whole batch, through a
differentiable all-reduce.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ti_torch.interpolants import Interpolant
from ti_torch.parallel.collectives import ChainShard, all_reduce_sum, batch_draw


def _sample_t(generator: Optional[torch.Generator], shape, t_distr: str, dtype,
              device) -> torch.Tensor:
    """t from one uniform draw: "uniform" U(0, 1); "beta" Beta(1/2, 1/2) as
    sin²(πu/2) (the arcsine law); "beta21" Beta(2, 1) as √u (its CDF is
    t²)."""
    if t_distr not in ("uniform", "beta", "beta21"):
        raise ValueError(f"unknown t distribution {t_distr!r}")
    u = batch_draw(torch.rand, generator, shape, dtype=dtype, device=device)
    if t_distr == "beta":
        return torch.sin(0.5 * math.pi * u) ** 2
    if t_distr == "beta21":
        return torch.sqrt(u)
    return u


def _batch_centre(x: torch.Tensor, generator) -> torch.Tensor:
    """The mean of x (B, N, 3) over all atoms of the batch: of the whole
    batch when ``generator`` is a ``ChainShard`` over a process group."""
    if isinstance(generator, ChainShard) and generator.group is not None:
        return all_reduce_sum(x.reshape(-1, 3).sum(dim=0), generator.group) / (
            generator.total * x.shape[1])
    return x.reshape(-1, 3).mean(dim=0)


def _antithetic_objective(btp, btm, dtIt, gd, z) -> torch.Tensor:
    per = (
        0.5 * torch.sum(btp ** 2, dim=-1)
        - torch.sum((dtIt + gd * z) * btp, dim=-1)
        + 0.5 * torch.sum(btm ** 2, dim=-1)
        - torch.sum((dtIt - gd * z) * btm, dim=-1)
    )
    return per.mean()


def adw_velocity_loss(
    apply_fn: Callable[..., torch.Tensor],
    params,
    x0: torch.Tensor,
    x1: torch.Tensor,
    beta0: torch.Tensor,
    beta1: torch.Tensor,
    interpolant: Interpolant,
    *,
    generator: Optional[torch.Generator] = None,
    t: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Two-sided antithetic velocity loss for the ADW MLP.

    x0, x1: (B, D); beta0, beta1: (B, 1); ``apply_fn(params, x, t, beta0,
    beta1) -> (B, D)``. t ~ U(0, 1) per sample. ``t``/``z`` (shapes (B, 1) /
    (B, D)) pin the draws.
    """
    if t is None:
        t = batch_draw(torch.rand, generator, (x0.shape[0], 1), dtype=x0.dtype, device=x0.device)
    if z is None:
        xtp, xtm, z = interpolant.antithetic_xts(t, x0, x1, generator=generator)
    else:
        It, g = interpolant.It(t, x0, x1), interpolant.gamma(t)
        xtp, xtm = It + g * z, It - g * z

    btp = apply_fn(params, xtp, t, beta0, beta1)
    btm = apply_fn(params, xtm, t, beta0, beta1)
    return _antithetic_objective(btp, btm, interpolant.dtIt(t, x0, x1),
                                 interpolant.gamma_dot(t), z)


def molecular_velocity_loss(
    apply_fn: Callable[..., torch.Tensor],
    params,
    x0: torch.Tensor,
    x1: torch.Tensor,
    temps: torch.Tensor,
    interpolant: Interpolant,
    *,
    generator: Optional[torch.Generator] = None,
    t_distr: str = "uniform",
    remat: bool = False,
    t: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Antithetic velocity loss over a batch of molecules.

    ``apply_fn(params, x (B,N,3), t (B,), temps (B,K)) -> (B,N,3)`` is the
    batched velocity field (``train.common.make_batched_apply``: the edge or
    the dense form; ti_tpu's per-molecule ``apply_fn`` and
    ``batched_apply_fn`` are this one argument). x0, x1: (B, N, 3);
    temps: (B, K) conditioning temperatures (K = 2 ambient, 1 latent).

    Two-sided unless ``interpolant.one_sided``. ``remat`` recomputes the
    forwards in the backward (``torch.utils.checkpoint``), trading one extra
    forward for their activation memory. ``t``/``z`` (shapes (B,) /
    (B, N, 3)) pin the draws; ``z`` is ignored for one-sided interpolants
    (there z := x0).
    """
    b = x0.shape[0]
    if t is None:
        t = _sample_t(generator, (b,), t_distr, x0.dtype, x0.device)  # per molecule
    t3 = t[:, None, None]

    if z is None or interpolant.one_sided:
        xtp, xtm, z = interpolant.antithetic_xts(t3, x0, x1, generator=generator)
    else:
        It, g = interpolant.It(t3, x0, x1), interpolant.gamma(t3)
        xtp, xtm = It + g * z, It - g * z
    # global mean-centring over ALL atoms in the batch
    xtp = xtp - _batch_centre(xtp, generator)
    xtm = xtm - _batch_centre(xtm, generator)

    def bfwd(x_b, t_b, temps_b):
        return apply_fn(params, x_b, t_b, temps_b)

    if remat:
        def fwd(x_b, t_b, temps_b):
            return checkpoint(bfwd, x_b, t_b, temps_b, use_reentrant=False)
    else:
        fwd = bfwd

    btp = fwd(xtp, t, temps)  # (B, N, 3)
    dtIt = interpolant.dtIt(t3, x0, x1)

    if interpolant.one_sided:
        per_atom = 0.5 * torch.sum(btp ** 2, dim=-1) - torch.sum(dtIt * btp, dim=-1)
        return per_atom.mean()

    btm = fwd(xtm, t, temps)
    return _antithetic_objective(btp, btm, dtIt, interpolant.gamma_dot(t3), z)
