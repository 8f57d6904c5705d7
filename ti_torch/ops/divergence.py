"""Divergence (Jacobian-trace) estimators for probability-flow dlogp
(port of ti_tpu/ops/divergence.py).

The functions here act on a batch of independent chains: ``x`` is
(B, ...) and ``f`` maps a batch to a batch with no coupling between
chains, so the Jacobian is block diagonal and one forward-mode tangent
per lane serves every chain at once. The trace is over each chain's
flattened state (d = prod(x.shape[1:])).

- ``divergence_exact``: trace(J) from d forward-mode JVPs against the
  identity basis (``torch.func.jvp`` under ``vmap``), all at once or in
  ``chunk``-lane blocks; ``exact_lane_block`` sizes the block of a node on
  the dense forward from its shape and a share of the card's memory
  (``exact_lane_budget``), after the memory model ``exact_node_bytes``.
- ``divergence_hutchinson``: Σ_k w_k z_kᵀ J z_k with rademacher or Haar
  orthogonal probes (``_probe_block``), drawn from a ``torch.Generator``
  or passed in explicitly.
- ``divergence_hutchpp``: Hutch++ (an exact trace over a sketched range of
  J plus Hutchinson on the projected residual), probes drawn or explicit.
- ``value_and_divergence``: dispatch over the three, with the probes drawn
  per chain, shared by every chain (``probe_crn``) or given (``draws``).

Lane sharding (``axis_name``, a ``torch.distributed`` process group or
the name of a mesh dimension, ti_torch.parallel.collectives.lane_group):
the tangent lanes are independent, so each rank of the group evaluates its
share of them through the same forward and one ``all_reduce`` of the (B,)
partial traces completes the trace. The primal runs on every rank. Exact:
rank r takes rows r·per .. r·per + per - 1 of the identity basis, per =
ceil(d/n) (rows past d contribute exactly 0 and are skipped). Hutchinson:
each rank takes ceil(K/n) probes of its own (the whole group draws an (n,
ceil(K/n)) block of probes a chain from the same generator and rank r keeps
block r, so the ranks' generators stay in step), and the all-reduced sum
is divided by n. Hutch++ and ``return_var`` refuse it, as in ti_tpu.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.func import jvp, vmap

from ti_torch.parallel.collectives import batch_draw, lane_group, unwrap


def _probe_block(generator: torch.Generator, k: int, d: int, mode: str, *,
                 shape=(), dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(*shape, k, d) probe rows Z and (*shape, k) weights w with
    E[Zᵀ diag(w) Z] = I, drawn on the generator's device.

    ``rademacher``: iid ±1 rows, w = 1/k. ``orthogonal``: k ≤ d
    Haar-orthonormal rows (QR of a Gaussian, signs fixed so the frame is
    exactly Haar), w = d/k — unbiased for any J and exact at k = d, where
    QᵀQ = I.

    A ``ChainShard`` generator draws the whole chain batch's block and keeps
    its rows when ``shape`` has a chain axis (axis 0); a draw with no chain
    axis comes from its generator as it is.
    """
    dev = generator.device
    if not shape:
        generator = unwrap(generator)
    if mode == "rademacher":
        z = batch_draw(lambda s, **kw: torch.randint(0, 2, s, **kw), generator, (*shape, k, d),
                       device=dev)
        return (2 * z - 1).to(dtype), torch.full((*shape, k), 1.0 / k, dtype=dtype, device=dev)
    if mode == "orthogonal":
        if k > d:
            raise ValueError(
                f"orthogonal probe_mode needs num_probes <= dim ({k} > {d}); "
                "use num_probes=dim (exact) or probe_mode='rademacher'"
            )
        # QR in f32 whatever the compute dtype; probes cast back
        g = batch_draw(torch.randn, generator, (*shape, d, k), device=dev, dtype=torch.float32)
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


def _lane_split(axis_name, k: int, d: int, probe_mode: str):
    """(group, ranks n, this rank r, probes a rank ceil(k/n)) of a
    lane-sharded Hutchinson estimate; orthogonal frames of more than d rows
    a rank are refused in the caller's terms."""
    group = lane_group(axis_name)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    per = -(-k // n)
    if probe_mode == "orthogonal" and per > d:
        raise ValueError(
            f"orthogonal probe_mode over axis {axis_name!r} draws ceil({k}/{n}) = {per} "
            f"probes per shard but dim is only {d}; use num_probes <= {n * d} (per-shard "
            "frames are orthogonalized locally) or probe_mode='rademacher'")
    return group, n, r, per


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
    d)) for Hutch++. ``axis_name`` shards the lanes over a process group
    (exact and Hutchinson; with it ``draws`` are this rank's probes)."""
    if mode == "exact":
        return divergence_exact(f, x, chunk=chunk, axis_name=axis_name)
    if mode not in ("hutchinson", "hutchpp"):
        raise ValueError(f"unknown divergence mode {mode!r}")
    if mode == "hutchpp" and axis_name is not None:
        raise NotImplementedError(
            "axis_name lane sharding is not implemented for hutchpp "
            "(the sketch QR needs the full query basis)"
        )
    if generator is None and draws is None:
        raise ValueError(f"{mode} mode requires a torch.Generator")
    if draws is None:
        draws = draw_probes(generator, mode, x.shape[0], x[0].numel(), num_probes=num_probes,
                            probe_mode=probe_mode, probe_crn=probe_crn, dtype=x.dtype,
                            axis_name=axis_name)
    a, c = (t.to(x.dtype) for t in draws)
    if mode == "hutchinson":
        return divergence_hutchinson(f, x, z=a, w=c, probe_mode=probe_mode,
                                     return_var=return_var, axis_name=axis_name)
    return divergence_hutchpp(f, x, S=a, g=c)


def draw_probes(generator: torch.Generator, mode: str, b: int, d: int, *, num_probes: int = 8,
                probe_mode: str = "rademacher", probe_crn: bool = False,
                dtype=torch.float32, axis_name=None):
    """The probes ``value_and_divergence`` draws for b chains of dimension
    d, in its order: Hutchinson (z (b, K, d), w (b, K)) in ``probe_mode``;
    Hutch++ (S (b, s, d), g (b, m, d)) Rademacher, s = num_probes // 3 (at
    least 1) and m = num_probes - 2s. Per chain, or one block shared by every
    chain (``probe_crn``). Hutchinson lane-sharded over ``axis_name``: this
    rank's ceil(K/n) probes (z (b, per, d), w (b, per)), block r of the
    (n, per) probes drawn a chain."""
    shape = () if probe_crn else (b,)
    if probe_crn:
        generator = unwrap(generator)
    if mode == "hutchinson":
        if axis_name is None:
            out = _probe_block(generator, num_probes, d, probe_mode, shape=shape)
        else:
            _, n, r, per = _lane_split(axis_name, num_probes, d, probe_mode)
            z, w = _probe_block(generator, per, d, probe_mode, shape=(*shape, n))
            out = (z[..., r, :, :], w[..., r, :])
    else:
        s = max(1, num_probes // 3)
        if num_probes - 2 * s < 1:
            raise ValueError(f"num_queries={num_probes} too small for sketch s={s} "
                             "(need num_queries >= 2*s + 1)")
        out = (_probe_block(generator, s, d, "rademacher", shape=shape, dtype=dtype)[0],
               _probe_block(generator, num_probes - 2 * s, d, "rademacher", shape=shape,
                            dtype=dtype)[0])
    if probe_crn:
        out = tuple(t.expand(b, *t.shape) for t in out)
    return out


def divergence_exact(f, x: torch.Tensor, chunk: Optional[int] = None, axis_name=None):
    """(f(x), trace(J) per chain (B,)) from the d identity-basis JVPs.

    ``chunk`` bounds the lanes evaluated at once: ceil(d/chunk) blocks of
    vmapped JVPs whose partial traces are summed, so memory holds
    ``chunk`` lanes of activations instead of d. None = all d at once.
    ``axis_name`` shards the lanes over a process group (rank r takes rows
    r·per .. r·per + per - 1, per = ceil(d/n)) and all-reduces the partial
    traces; ``chunk`` then bounds the lanes a rank evaluates at once."""
    b = x.shape[0]
    d = x[0].numel()
    lo, hi, group = 0, d, None
    if axis_name is not None:
        group = lane_group(axis_name)
        per = -(-d // dist.get_world_size(group))
        lo = min(d, dist.get_rank(group) * per)
        hi = min(d, lo + per)
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    step = d if chunk is None else max(1, min(chunk, d))
    div = torch.zeros(b, dtype=x.dtype, device=x.device)
    for k0 in range(lo, hi, step):
        k1 = min(k0 + step, hi)
        lanes = eye[k0:k1].reshape(k1 - k0, 1, *x.shape[1:]).expand(k1 - k0, *x.shape)
        jz = _lane_jvps(f, x, lanes).reshape(k1 - k0, b, d)
        rows = torch.arange(k1 - k0, device=x.device)
        div = div + jz[rows, :, k0 + rows].sum(0)
    if group is not None:
        dist.all_reduce(div, group=group)
    return f(x), div


# Peak bytes of one exact node on the dense forward (models/cpainn_dense.py::
# apply_dense under vmap(jvp)), above its inputs, in units of N²·F elements of
# the compute dtype: a part a chain (the primal's pair tensors) and a part a
# lane and chain (the (B·K, N, N, c·F) tangents of one layer, freed before the
# next, so the layer count does not enter). Fit to the peaks
# tools/latent_memory_probe.py measured in bf16 on an H100 at 19 atoms, F =
# 128 and 29 atoms, F = 256 (within 1% of each); f32 peaks sit 38% below the
# model, which only makes its blocks smaller than they need be (PERF.md §6).
NODE_CHAIN_UNITS = 44.8
NODE_LANE_UNITS = 65.0
# The share of the card's total memory an exact node may take: fixed, so that
# one config gives the same blocks, and so the same bits, on every call.
EXACT_LANE_SHARE = 0.6


def _itemsize(compute_dtype) -> int:
    """Bytes an element of the dense forward's compute dtype (None = f32;
    torch.bfloat16, "bf16" and "bf16_agg" are 2)."""
    if compute_dtype in (torch.bfloat16, "bf16", "bfloat16", "bf16_agg"):
        return 2
    if compute_dtype in (None, torch.float32, "f32", "float32", ""):
        return 4
    raise ValueError(f"unknown compute_dtype {compute_dtype!r}")


def exact_node_bytes(batch: int, lanes: int, n_atoms: int, n_features: int,
                     compute_dtype) -> float:
    """The memory model's peak bytes of one exact node of ``batch`` chains
    evaluating ``lanes`` lanes at once on the dense forward."""
    unit = n_atoms * n_atoms * n_features * _itemsize(compute_dtype)
    return batch * unit * (NODE_CHAIN_UNITS + lanes * NODE_LANE_UNITS)


def exact_lane_budget(device) -> Optional[int]:
    """The bytes an exact node may take on ``device``: EXACT_LANE_SHARE of
    the card's total memory (never its free memory, which changes from call
    to call); None on the CPU (no blocking)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(EXACT_LANE_SHARE * torch.cuda.get_device_properties(dev).total_memory)


def exact_lane_block(batch: int, n_atoms: int, n_features: int, n_layers: int, compute_dtype,
                     budget_bytes: Optional[int]) -> Optional[int]:
    """The lanes an exact node of ``batch`` chains evaluates at once on the
    dense forward (``divergence_exact``'s ``chunk``): None when all d =
    3·n_atoms fit in ``budget_bytes`` under ``exact_node_bytes`` (or no
    budget is given), else the largest block that fits, balanced so that
    the ceil(d / k) blocks are near equal, and at least 1. ``n_layers``
    does not enter: the layers run in turn, each freeing its pair tensors
    before the next (one peak at 2 and 5 layers, PERF.md §6). The blocks
    change a node's result only by the order of its sum."""
    if budget_bytes is None:
        return None
    d = 3 * n_atoms
    unit = batch * n_atoms * n_atoms * n_features * _itemsize(compute_dtype)
    fit = int((budget_bytes / unit - NODE_CHAIN_UNITS) // NODE_LANE_UNITS)
    if fit >= d:
        return None
    blocks = -(-d // max(fit, 1))
    return -(-d // blocks)


def divergence_hutchinson(f, x: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                          num_probes: int = 8, probe_mode: str = "rademacher",
                          return_var: bool = False, z: Optional[torch.Tensor] = None,
                          w: Optional[torch.Tensor] = None, axis_name=None):
    """(f(x), Σ_k w_k z_kᵀ J z_k per chain[, its plug-in variance]).

    Probes z (B, K, d) and weights w (B, K) are drawn per chain from
    ``generator`` unless given. ``axis_name`` shards the probes over a
    process group: a rank evaluates ceil(K/n) probes (drawn as
    ``draw_probes`` draws them, or given: this rank's (B, per, d) and (B,
    per)) and the estimate is the all-reduced sum over n."""
    b = x.shape[0]
    d = x[0].numel()
    group = None
    if axis_name is not None:
        if return_var:
            raise NotImplementedError("return_var is not supported with axis_name lane sharding")
        group = lane_group(axis_name)
        if z is None:
            z, w = (t.to(x.dtype) for t in draw_probes(
                generator, "hutchinson", b, d, num_probes=num_probes, probe_mode=probe_mode,
                axis_name=axis_name))
    if z is None:
        z, w = _probe_block(generator, num_probes, d, probe_mode, shape=(b,), dtype=x.dtype)
    k = z.shape[1]
    lanes = z.transpose(0, 1).reshape(k, *x.shape)
    jz = _lane_jvps(f, x, lanes).reshape(k, b, d)
    est = (z.transpose(0, 1) * jz).sum(-1).transpose(0, 1)  # (B, K)
    div = (w * est).sum(-1)
    if group is not None:
        dist.all_reduce(div, group=group)
        div = div / dist.get_world_size(group)
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
