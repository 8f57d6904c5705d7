"""Stochastic-interpolant schedules (port of ti_tpu/interpolants.py).

An interpolant is an immutable dataclass of scalar functions of ``t`` that
broadcast over tensors of t. Randomness enters only through an explicit
``torch.Generator`` or an explicit noise tensor ``z``.

Conventions (those of the reference):
    It(t, x0, x1)    = alpha(t) * x0 + beta(t) * x1
    dtIt(t, x0, x1)  = alpha_dot(t) * x0 + beta_dot(t) * x1
    x_t^±            = It ± gamma(t) * z,   z ~ N(0, I)   (two-sided)
    x_t^±            = beta(t) x1 ± alpha(t) x0           (one-sided, x0 = noise)

gamma schedules:
    brownian: gamma(t) = sqrt(a t (1-t))
    sin2:     gamma(t) = sin^2(pi t)
    sig_sum:  scaled sigmoid-sum bump
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

ScalarFn = Callable[[torch.Tensor], torch.Tensor]


def _t(t) -> torch.Tensor:
    t = torch.as_tensor(t)
    return t if t.is_floating_point() else t.to(torch.get_default_dtype())


def _bcast(t, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a scalar/per-sample t against state x (append axes)."""
    t = torch.as_tensor(t, device=x.device)
    while t.ndim < x.ndim:
        t = t[..., None]
    return t


def _noise(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class Interpolant:
    """A two-time-marginal stochastic interpolant.

    All fields are scalar functions of time ``t in [0, 1]``. ``one_sided``
    selects the antithetic construction of the latent pipeline, where x0
    itself is the noise and there is no extra gamma*z term.
    """

    alpha: ScalarFn
    alpha_dot: ScalarFn
    beta: ScalarFn
    beta_dot: ScalarFn
    gamma: ScalarFn
    gamma_dot: ScalarFn
    gg_dot: ScalarFn
    one_sided: bool = False
    name: str = "interpolant"

    def It(self, t, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        t0, t1 = _bcast(t, x0), _bcast(t, x1)
        return self.alpha(t0) * x0 + self.beta(t1) * x1

    def dtIt(self, t, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        t0, t1 = _bcast(t, x0), _bcast(t, x1)
        return self.alpha_dot(t0) * x0 + self.beta_dot(t1) * x1

    def antithetic_xts(
        self, t, x0: torch.Tensor, x1: torch.Tensor, *,
        generator: Optional[torch.Generator] = None, z: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(x_t^+, x_t^-, z) for the antithetic variance-reduced loss.

        Two-sided: x_t^± = It(t) ± gamma(t) z, with z drawn from
        ``generator`` unless given. One-sided: z := x0 and
        x_t^± = beta(t) x1 ± alpha(t) x0 (``z`` and ``generator`` unused).
        """
        tb = _bcast(t, x0)
        if self.one_sided:
            plus = self.beta(tb) * x1 + self.alpha(tb) * x0
            minus = self.beta(tb) * x1 - self.alpha(tb) * x0
            return plus, minus, x0
        if z is None:
            z = _noise(x0, generator)
        g = self.gamma(tb)
        it = self.It(t, x0, x1)
        return it + g * z, it - g * z, z

    def regular_xt(
        self, t, x0: torch.Tensor, x1: torch.Tensor, *,
        generator: Optional[torch.Generator] = None, z: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x_t, z): a single noisy interpolant draw."""
        if self.one_sided:
            return self.It(t, x0, x1), x0
        if z is None:
            z = _noise(x0, generator)
        return self.It(t, x0, x1) + self.gamma(_bcast(t, x0)) * z, z


def _zero(t) -> torch.Tensor:
    return torch.zeros_like(_t(t))


def _gamma_brownian(a: float):
    a = float(a)

    def gamma(t):
        t = _t(t)
        return torch.sqrt(a * t * (1.0 - t))

    def gamma_dot(t):
        # a(1-2t) / (2 sqrt(a t (1-t))); singular at t in {0,1} like the reference
        t = _t(t)
        return a * (1.0 - 2.0 * t) / (2.0 * torch.sqrt(a * t * (1.0 - t)))

    def gg_dot(t):
        return (a / 2.0) * (1.0 - 2.0 * _t(t))

    return gamma, gamma_dot, gg_dot


def _gamma_sin2():
    def gamma(t):
        return torch.sin(math.pi * _t(t)) ** 2

    def gamma_dot(t):
        t = _t(t)
        return 2.0 * math.pi * torch.sin(math.pi * t) * torch.cos(math.pi * t)

    def gg_dot(t):
        return gamma(t) * gamma_dot(t)

    return gamma, gamma_dot, gg_dot


def _gamma_sig_sum(a: float):
    a = float(a)
    scale = 2.2

    def sig(u):
        return torch.sigmoid(torch.as_tensor(u))

    def gamma(t):
        t = _t(t)
        return scale * (
            sig(a * (t - 0.5) + 1.0)
            - sig(a * (t - 0.5) - 1.0)
            - sig(torch.full_like(t, -a / 2.0 + 1.0))
            + sig(torch.full_like(t, -a / 2.0 - 1.0))
        )

    def gamma_dot(t):
        t = _t(t)
        sm = sig(-1.0 + a * (t - 0.5))
        sp = sig(1.0 + a * (t - 0.5))
        return scale * ((-a) * (1.0 - sm) * sm + a * (1.0 - sp) * sp)

    def gg_dot(t):
        return gamma(t) * gamma_dot(t)

    return gamma, gamma_dot, gg_dot


_GAMMAS = {"brownian": _gamma_brownian, "sin2": _gamma_sin2, "sig_sum": _gamma_sig_sum}


def _linear_parts():
    return dict(
        alpha=lambda t: 1.0 - _t(t),
        alpha_dot=lambda t: torch.full_like(_t(t), -1.0),
        beta=_t,
        beta_dot=lambda t: torch.ones_like(_t(t)),
    )


def linear(a: float = 1.0, gamma: str = "brownian") -> Interpolant:
    """Two-sided linear interpolant It = (1-t) x0 + t x1 with a gamma schedule.

    ``gamma`` in {"brownian", "sin2", "sig_sum"}; ``a`` parameterizes
    brownian/sig_sum (ignored by sin2).
    """
    if gamma not in _GAMMAS:
        raise ValueError(f"unknown gamma schedule {gamma!r}; want one of {sorted(_GAMMAS)}")
    maker = _GAMMAS[gamma]
    g, gd, ggd = maker(a) if gamma != "sin2" else maker()
    return Interpolant(**_linear_parts(), gamma=g, gamma_dot=gd, gg_dot=ggd,
                       one_sided=False, name=f"linear/{gamma}")


def one_sided_linear() -> Interpolant:
    """One-sided linear interpolant It = (1-t) x0 + t x1 with x0 ~ N(0, I).

    The latent (noise -> data) pipeline's: the antithetic pair reflects the
    noise x0 itself, and gamma is identically zero.
    """
    return Interpolant(**_linear_parts(), gamma=_zero, gamma_dot=_zero, gg_dot=_zero,
                       one_sided=True, name="one_sided_linear")


def make_interpolant(kind: str = "linear", a: float = 1.0, gamma: str = "brownian") -> Interpolant:
    """Config-string constructor used by the training loops."""
    if kind == "linear":
        return linear(a=a, gamma=gamma)
    if kind in ("one_sided", "one_sided_linear"):
        return one_sided_linear()
    raise ValueError(f"unknown interpolant kind {kind!r}")
