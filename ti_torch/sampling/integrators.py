"""Fixed-step probability-flow integrators and the Euler–Maruyama SDE
(port of the parts of ti_tpu/sampling/integrators.py on the ambient and
SDE paths).

Batched over chains: a velocity ``v_fn(xs, t)`` maps (B, ...) states to
(B, ...) velocities. Python loops take the place of ``lax.scan``. Sign
conventions match ti_tpu: forward transport integrates
d(dlogp)/dt = -div b, so the saved dlogp is log q(x_1) - log p_0(x_0).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch


class ODESolution(NamedTuple):
    """xs: (B, n_save, *state) trajectory at the save points (including
    t0); dlogp: (B, n_save) integrated log-density change; nfe: number of
    right-hand-side evaluations; dlogp_var: optional (B, n_save) variance
    of the stochastic-divergence noise accumulated into dlogp."""

    xs: torch.Tensor
    dlogp: torch.Tensor
    nfe: int
    dlogp_var: Optional[torch.Tensor] = None


def _tableau(method: str):
    """Butcher tableau (c, A, b) of an explicit RK method."""
    if method == "euler":
        return np.zeros(1), np.zeros((1, 1)), np.array([1.0])
    if method == "heun":
        return np.array([0.0, 1.0]), np.array([[0.0, 0.0], [1.0, 0.0]]), np.array([0.5, 0.5])
    if method == "rk4":
        c = np.array([0.0, 0.5, 0.5, 1.0])
        a = np.zeros((4, 4))
        a[1, 0] = 0.5
        a[2, 1] = 0.5
        a[3, 2] = 1.0
        b = np.array([1, 2, 2, 1]) / 6.0
        return c, a, b
    raise ValueError(f"unknown method {method!r}")


def _rk_step(v_fn, x: torch.Tensor, t: float, dt: float, method: str) -> torch.Tensor:
    """One explicit RK step of dx/dt = v_fn(x, t)."""
    cc, aa, bb = _tableau(method)
    ks = []
    for si in range(len(bb)):
        yi = x
        for sj in range(si):
            if aa[si][sj]:
                yi = yi + (dt * aa[si][sj]) * ks[sj]
        ks.append(v_fn(yi, t + cc[si] * dt))
    out = x
    for si in range(len(bb)):
        out = out + (dt * bb[si]) * ks[si]
    return out


def sample_ode(v_fn, x0: torch.Tensor, *, t0: float = 0.0, t1: float = 1.0,
               n_steps: int = 100, n_save: int = 2, method: str = "rk4",
               return_dlogp: bool = False) -> ODESolution:
    """Fixed-step transport of a chain batch x0 (B, ...) from t0 to t1 in
    ``n_steps`` uniform steps, saving ``n_save`` states (n_steps a
    multiple of n_save - 1). Velocity only: dlogp rides the Gauss
    quadrature path of sampling/drivers.py."""
    if return_dlogp:
        raise NotImplementedError(
            "stage-coupled dlogp (divergence inside every RK stage) comes with "
            "the integrators slice; use make_ode_sampler's Gauss quadrature path"
        )
    if n_save < 2 or n_steps % (n_save - 1) != 0:
        raise ValueError("n_steps must be a positive multiple of (n_save - 1)")
    dt = (t1 - t0) / n_steps
    per_save = n_steps // (n_save - 1)
    x = x0
    saves = [x]
    for i in range(n_steps):
        x = _rk_step(v_fn, x, t0 + i * dt, dt, method)
        if (i + 1) % per_save == 0:
            saves.append(x)
    n_stages = len(_tableau(method)[2])
    return ODESolution(xs=torch.stack(saves, dim=1),
                       dlogp=torch.zeros(x0.shape[0], n_save, dtype=x0.dtype, device=x0.device),
                       nfe=n_steps * n_stages)


def sample_sde(
    drift_fn,
    x0: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    g_fn: Union[Callable[[float], float], float] = 0.0,
    t0: float = 0.0,
    t1: float = 1.0,
    n_steps: int = 100,
    n_save: int = 2,
    project_zero_mean: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Euler–Maruyama: dX = b(X, t) dt + g(t) dW. Returns (n_save, *state).

    With g = 0 this is the Euler probability-flow ODE. ``project_zero_mean``
    removes the mean of the injected noise over axis -2 each step — the
    per-structure centre of mass of a (N, 3) or batched (C, N, 3) state.
    The noise of step i is ``noise[i]`` when ``noise`` (n_steps, *state) is
    given (the parity tests pass JAX's draws), else a standard normal draw
    from ``generator``. The one Euler–Maruyama core: the batched molecular
    driver (drivers.sample_molecular_sde) delegates here.
    """
    if n_save < 2 or n_steps % (n_save - 1) != 0:
        raise ValueError("n_steps must be a positive multiple of (n_save - 1)")
    if noise is not None and tuple(noise.shape) != (n_steps, *x0.shape):
        raise ValueError(f"noise must be {(n_steps, *x0.shape)}, got {tuple(noise.shape)}")
    if noise is None and generator is None:
        raise ValueError("sample_sde needs a generator or explicit noise")
    g = g_fn if callable(g_fn) else (lambda t, _g=float(g_fn): _g)
    dt = (t1 - t0) / n_steps
    sqrt_dt = float(np.sqrt(np.float32(abs(dt))))
    per_save = n_steps // (n_save - 1)
    x = x0
    saves = [x]
    for i in range(n_steps):
        t = t0 + i * dt
        if noise is None:
            z = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        else:
            z = noise[i].to(device=x.device, dtype=x.dtype)
        if project_zero_mean:
            z = z - z.mean(dim=-2, keepdim=True)
        x = x + (dt * drift_fn(x, t) + g(t) * sqrt_dt * z).to(x.dtype)
        if (i + 1) % per_save == 0:
            saves.append(x)
    return torch.stack(saves)
