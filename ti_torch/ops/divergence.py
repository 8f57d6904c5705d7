"""Divergence (Jacobian-trace) estimators for probability-flow dlogp
(port of ti_tpu/ops/divergence.py).

The functions here act on a batch of independent chains: ``x`` is
(B, ...) and ``f`` maps a batch to a batch with no coupling between
chains, so the Jacobian is block diagonal and one forward-mode tangent
per lane serves every chain at once. The trace is over each chain's
flattened state (d = prod(x.shape[1:])).

- ``divergence_exact``: trace(J) from d forward-mode JVPs against the
  identity basis (``torch.func.jvp`` under ``vmap``), all at once or in
  ``chunk``-lane blocks.
- ``divergence_hutchinson``: Σ_k w_k z_kᵀ J z_k with rademacher or Haar
  orthogonal probes (``_probe_block``), drawn from a ``torch.Generator``
  or passed in explicitly.
- ``divergence_hutchpp``: Hutch++ (an exact trace over a sketched range of
  J plus Hutchinson on the projected residual), probes drawn or explicit.
- ``value_and_divergence``: dispatch over the three, with the probes drawn
  per chain, shared by every chain (``probe_crn``) or given (``draws``).

Lane sharding over a device mesh (the JAX package's ``axis_name``) belongs
to the parallel slice of the port and raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.func import jvp, vmap


def _probe_block(generator: torch.Generator, k: int, d: int, mode: str, *,
                 shape=(), dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(*shape, k, d) probe rows Z and (*shape, k) weights w with
    E[Zᵀ diag(w) Z] = I, drawn on the generator's device.

    ``rademacher``: iid ±1 rows, w = 1/k. ``orthogonal``: k ≤ d
    Haar-orthonormal rows (QR of a Gaussian, signs fixed so the frame is
    exactly Haar), w = d/k — unbiased for any J and exact at k = d, where
    QᵀQ = I.
    """
    dev = generator.device
    if mode == "rademacher":
        z = torch.randint(0, 2, (*shape, k, d), generator=generator, device=dev)
        return (2 * z - 1).to(dtype), torch.full((*shape, k), 1.0 / k, dtype=dtype, device=dev)
    if mode == "orthogonal":
        if k > d:
            raise ValueError(
                f"orthogonal probe_mode needs num_probes <= dim ({k} > {d}); "
                "use num_probes=dim (exact) or probe_mode='rademacher'"
            )
        # QR in f32 whatever the compute dtype; probes cast back
        g = torch.randn((*shape, d, k), generator=generator, device=dev, dtype=torch.float32)
        q, r = torch.linalg.qr(g)
        q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[..., None, :]
        return q.transpose(-1, -2).to(dtype), torch.full((*shape, k), d / k, dtype=dtype, device=dev)
    raise ValueError(f"unknown probe_mode {mode!r} (rademacher | orthogonal)")


def hutchinson_var_estimate(est: torch.Tensor, w: torch.Tensor, d: int, mode: str) -> torch.Tensor:
    """Plug-in variance of the Hutchinson trace ESTIMATOR from its K
    per-probe contributions ``est`` (..., K) and weights ``w`` (..., K).

    rademacher: the sample variance over K. orthogonal: the iid plug-in
    times the Haar frame's without-replacement factor (d-K)/(d-1) —
    approximate, exact (zero) at K = d."""
    k = est.shape[-1]
    s2 = est.var(dim=-1, unbiased=False) * (k / max(k - 1, 1))
    if mode == "orthogonal":
        fac = (d - k) / max(d - 1, 1)
        return w.sum(-1) ** 2 * s2 / k * fac
    return s2 / k


def _lane_jvps(f, x: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """J·z for each lane z of ``lanes`` (K, B, ...) -> (K, B, ...)."""
    return vmap(lambda z: jvp(f, (x,), (z,))[1])(lanes)


def _no_lane_sharding(axis_name) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            "axis_name lane sharding over a device mesh is not ported yet "
            "(the parallel slice of the port)"
        )


def value_and_divergence(f, x: torch.Tensor, *, mode: str = "exact",
                         generator: Optional[torch.Generator] = None, num_probes: int = 8,
                         chunk: Optional[int] = None, axis_name=None,
                         probe_mode: str = "rademacher", probe_crn: bool = False,
                         return_var: bool = False, draws=None):
    """(f(x), div f(x) per chain[, its Hutchinson probe variance]) with the
    chosen estimator: ``mode`` in {"exact", "hutchinson", "hutchpp"}; the
    stochastic ones draw from ``generator`` (hutchpp takes ``num_probes``
    as its query budget), per chain, or once for every chain with
    ``probe_crn`` (common random numbers), unless ``draws`` gives the
    probes: (z (B, K, d), w (B, K)) for Hutchinson, (S (B, s, d), g (B, m,
    d)) for Hutch++."""
    _no_lane_sharding(axis_name)
    if mode == "exact":
        return divergence_exact(f, x, chunk=chunk)
    if mode in ("hutchinson", "hutchpp") and generator is None and draws is None:
        raise ValueError(f"{mode} mode requires a torch.Generator")
    b, d = x.shape[0], x[0].numel()
    if mode == "hutchinson":
        if draws is not None:
            z, w = draws
        elif probe_crn:
            z, w = _probe_block(generator, num_probes, d, probe_mode)
            z, w = z.expand(b, *z.shape), w.expand(b, *w.shape)
        else:
            z, w = _probe_block(generator, num_probes, d, probe_mode, shape=(b,))
        return divergence_hutchinson(f, x, z=z.to(x.dtype), w=w.to(x.dtype),
                                     probe_mode=probe_mode, return_var=return_var)
    if mode == "hutchpp":
        if draws is None and not probe_crn:
            return divergence_hutchpp(f, x, generator, num_queries=num_probes)
        if draws is None:
            s = max(1, num_probes // 3)
            S = _probe_block(generator, s, d, "rademacher", dtype=x.dtype)[0]
            g = _probe_block(generator, num_probes - 2 * s, d, "rademacher", dtype=x.dtype)[0]
            draws = S.expand(b, *S.shape), g.expand(b, *g.shape)
        return divergence_hutchpp(f, x, S=draws[0].to(x.dtype), g=draws[1].to(x.dtype))
    raise ValueError(f"unknown divergence mode {mode!r}")


def divergence_exact(f, x: torch.Tensor, chunk: Optional[int] = None, axis_name=None):
    """(f(x), trace(J) per chain (B,)) from the d identity-basis JVPs.

    ``chunk`` bounds the lanes evaluated at once: ceil(d/chunk) blocks of
    vmapped JVPs whose partial traces are summed, so memory holds
    ``chunk`` lanes of activations instead of d. None = all d at once."""
    _no_lane_sharding(axis_name)
    b = x.shape[0]
    d = x[0].numel()
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    step = d if chunk is None else max(1, min(chunk, d))
    div = torch.zeros(b, dtype=x.dtype, device=x.device)
    for k0 in range(0, d, step):
        k1 = min(k0 + step, d)
        lanes = eye[k0:k1].reshape(k1 - k0, 1, *x.shape[1:]).expand(k1 - k0, *x.shape)
        jz = _lane_jvps(f, x, lanes).reshape(k1 - k0, b, d)
        rows = torch.arange(k1 - k0, device=x.device)
        div = div + jz[rows, :, k0 + rows].sum(0)
    return f(x), div


def divergence_hutchinson(f, x: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                          num_probes: int = 8, probe_mode: str = "rademacher",
                          return_var: bool = False, z: Optional[torch.Tensor] = None,
                          w: Optional[torch.Tensor] = None):
    """(f(x), Σ_k w_k z_kᵀ J z_k per chain[, its plug-in variance]).

    Probes z (B, K, d) and weights w (B, K) are drawn per chain from
    ``generator`` unless given."""
    b = x.shape[0]
    d = x[0].numel()
    if z is None:
        z, w = _probe_block(generator, num_probes, d, probe_mode, shape=(b,), dtype=x.dtype)
    k = z.shape[1]
    lanes = z.transpose(0, 1).reshape(k, *x.shape)
    jz = _lane_jvps(f, x, lanes).reshape(k, b, d)
    est = (z.transpose(0, 1) * jz).sum(-1).transpose(0, 1)  # (B, K)
    div = (w * est).sum(-1)
    if return_var:
        return f(x), div, hutchinson_var_estimate(est, w, d, probe_mode)
    return f(x), div


def divergence_hutchpp(f, x: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                       num_queries: Optional[int] = None, sketch: Optional[int] = None,
                       S: Optional[torch.Tensor] = None, g: Optional[torch.Tensor] = None):
    """Hutch++ trace estimator (Meyer et al. 2021) per chain:

        tr(J) = tr(Qᵀ J Q) + E_g[gᵀ(I-QQᵀ) J (I-QQᵀ)g],   Q = qr(J S)

    with S an (s, d) Rademacher sketch (s = ``sketch``, default
    num_queries // 3) and m = num_queries - 2s Rademacher probes g
    (``num_queries`` 12 by default). Unbiased for any square J, exact when
    rank(J) <= s. ``S`` (B, s, d) and ``g`` (B, m, d) are passed together or
    not at all: given, s and m are their row counts, held against
    ``sketch`` and ``num_queries`` where those are passed too; not given,
    both are drawn per chain from ``generator``."""
    b = x.shape[0]
    d = x[0].numel()
    if (S is None) != (g is None):
        raise ValueError("pass both S and g, or neither (both are then drawn from generator)")
    if S is None:
        s = sketch if sketch is not None else max(1, (num_queries or 12) // 3)
        m = (num_queries or 12) - 2 * s
    else:
        if S.dim() != 3 or g.dim() != 3 or S.shape[::2] != (b, d) or g.shape[::2] != (b, d):
            raise ValueError(f"S and g must be (B={b}, rows, d={d}), got {tuple(S.shape)} and "
                             f"{tuple(g.shape)}")
        s, m = S.shape[1], g.shape[1]
        if sketch is not None and sketch != s:
            raise ValueError(f"sketch={sketch} but S has {s} rows")
        if num_queries is not None and num_queries != 2 * s + m:
            raise ValueError(f"num_queries={num_queries} but S and g make 2*{s} + {m} queries")
    if m < 1:
        raise ValueError(f"num_queries={2 * s + m} too small for sketch s={s} "
                         "(need num_queries >= 2*s + 1)")
    if S is None:
        S = _probe_block(generator, s, d, "rademacher", shape=(b,), dtype=x.dtype)[0]
        g = _probe_block(generator, m, d, "rademacher", shape=(b,), dtype=x.dtype)[0]

    def jvps(rows):  # (B, k, d) -> (B, k, d): J r for each row r
        k = rows.shape[1]
        lanes = rows.transpose(0, 1).reshape(k, *x.shape)
        return _lane_jvps(f, x, lanes).reshape(k, b, d).transpose(0, 1)

    q, _ = torch.linalg.qr(jvps(S).transpose(1, 2))  # (B, d, s) basis of range(J S)
    qt = q.transpose(1, 2)
    t_sketch = (qt * jvps(qt)).sum((1, 2))  # tr(Qᵀ J Q)
    g_perp = g - (g @ q) @ qt  # (I - QQᵀ) g
    resid = (g_perp * jvps(g_perp)).sum(-1)  # (B, m)
    return f(x), t_sketch + resid.mean(-1)
