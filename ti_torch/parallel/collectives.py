"""What the samplers, the divergence estimators and the losses need of a
``torch.distributed`` process group.

- ``ChainShard`` stands in for a ``torch.Generator`` on one rank of a run
  whose chain (or sample) batch is split over ranks: ``batch_draw`` makes
  the whole batch's block on every rank and keeps the rank's rows, so a
  sharded run draws for every chain what the unsharded run draws for it.
- ``all_reduce_sum`` is a sum over a group that autograd differentiates
  (the backward sums the cotangents over the same group).
- ``using_mesh`` / ``lane_group`` resolve a mesh dimension's name, the
  ``axis_name``/``div_axis`` of the lane-sharded divergence, to its
  process group, as ``jax.shard_map`` resolves a mesh axis name.
- ``gather_rows`` all-gathers blocks of unequal length in rank order.

Nothing here starts a process group: see ``ti_torch.parallel.mesh``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, List

import torch
import torch.distributed as dist

_MESH = contextvars.ContextVar("ti_torch_mesh", default=None)


class ChainShard:
    """The random stream of a whole batch of ``total`` chains, seen from the
    rank that holds rows [start, stop) of it. ``generator`` is the same
    seeded ``torch.Generator`` on every rank of ``group``, the process group
    the batch is split over (None: a split that needs no collective)."""

    def __init__(self, generator: torch.Generator, start: int, stop: int, total: int,
                 group=None):
        if not 0 <= start <= stop <= total:
            raise ValueError(f"rows [{start}, {stop}) are not a block of {total} chains")
        self.generator = generator
        self.start, self.stop, self.total = start, stop, total
        self.group = group

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def any(self, flag: torch.Tensor) -> bool:
        """True where ``flag`` holds on any rank of the group."""
        if self.group is None:
            return bool(flag)
        t = flag.reshape(1).to(torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())


def unwrap(generator):
    """The ``torch.Generator`` behind ``generator`` (a ChainShard's own)."""
    return generator.generator if isinstance(generator, ChainShard) else generator


def batch_draw(fn: Callable, generator, shape, **kwargs) -> torch.Tensor:
    """``fn(shape, generator=..., **kwargs)`` for a block whose axis 0 is the
    batch axis. Under a ``ChainShard`` the whole batch's block is drawn and
    the rank's rows kept."""
    if not isinstance(generator, ChainShard):
        return fn(tuple(shape), generator=generator, **kwargs)
    rows = generator.stop - generator.start
    if not shape or shape[0] != rows:
        raise ValueError(f"a draw for {rows} chains of a sharded batch has shape {tuple(shape)}")
    full = fn((generator.total, *shape[1:]), generator=generator.generator, **kwargs)
    return full[generator.start:generator.stop]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


@contextlib.contextmanager
def using_mesh(mesh):
    """Resolve mesh dimension names through ``mesh`` inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def lane_group(axis_name):
    """The process group of ``axis_name``: a group as it is, or the name of
    a dimension of the mesh of the enclosing ``using_mesh``."""
    if not isinstance(axis_name, str):
        return axis_name
    mesh = _MESH.get()
    if mesh is None:
        raise ValueError(
            f"axis_name {axis_name!r} names a mesh dimension but no mesh is in use: run the "
            "sampler through ti_torch.parallel.lane_parallel_sampler(sampler, mesh), or pass "
            "a process group")
    return mesh.get_group(axis_name)


def comm_device(group) -> torch.device:
    """Where ``group``'s collectives take their tensors: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_max(value: int, group) -> int:
    t = torch.tensor([int(value)], dtype=torch.int64, device=comm_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def gather_rows(t: torch.Tensor, group, sizes: List[int]) -> torch.Tensor:
    """Every rank's block of ``t`` (rank r holds ``sizes[r]`` rows of axis
    0), concatenated in rank order on every rank."""
    dev = t.device
    x = t.to(comm_device(group))
    width = max(sizes)
    if x.shape[0] < width:
        x = torch.cat([x, x.new_zeros((width - x.shape[0], *x.shape[1:]))])
    parts = [torch.empty_like(x) for _ in sizes]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)]).to(dev)
