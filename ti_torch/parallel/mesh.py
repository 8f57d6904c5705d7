"""Data-parallel training and chain- and lane-parallel sampling over
``torch.distributed`` (port of ti_tpu/parallel/mesh.py).

ti_tpu builds these on a ``jax.sharding.Mesh``: parameters replicated, the
batch split on axis "data", XLA inserting the collectives. Here a
``DeviceMesh`` names the dimensions of the process group the caller has
started (``init_distributed``, or ``torchrun``), and the wrappers place the
collectives themselves:

- ``parallel_sampler``: the chains split over "data", no collective inside
  the rollout (dopri5 with a stochastic divergence aside: its ranks step in
  lockstep), the states and dlogps all-gathered into the unsharded layout.
  The probes are those of the unsharded run, chain for chain: every rank
  draws the whole batch's block from the same seeded generator and keeps
  its rows (``collectives.ChainShard``);
- ``parallel_update``: data-parallel ``train.common.make_update_step``.
  Parameters and optimizer state replicated, the batch split; the loss's t
  and z are the whole batch's draws, sliced, its x_t^± centred over the
  whole batch, and the gradients all-reduced, as the mean weighted by shard
  sizes, before the optimizer's global-norm clip and NaN guard, so one step
  on n ranks is the step of the whole batch on one device;
- ``lane_parallel_sampler``: the divergence's tangent lanes split over
  "lanes" (one all-reduce of the (B,) partial traces a divergence
  evaluation, ops/divergence.py), with ``chain_axis`` the chains over a
  second dimension.

Every wrapper takes the whole batch, as every rank holds it, and returns
the whole result on every rank. The split is ``shard_batch``'s: contiguous
blocks in rank order, earlier ranks taking the remainder
(``fanout.shard_slice``). Weight-matrix and pipeline parallelism stay
absent, as in ti_tpu: the models are small and the axes that matter are the
chains and the lanes.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ti_torch import resolve_device
from ti_torch.parallel.collectives import ChainShard, all_max, gather_rows, using_mesh
from ti_torch.parallel.fanout import shard_slice

# every process group this module makes raises after this long in a
# collective that other ranks never join, rather than stalling the run
DEFAULT_TIMEOUT_S = 300.0


def init_distributed(backend: Optional[str] = None, device=None, init_method: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None) -> tuple:
    """Start this process's default process group; returns (rank,
    world_size).

    ``rank``, ``world_size`` and ``local_rank`` default to torchrun's
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, ``init_method`` to
    ``env://`` (torchrun's ``MASTER_ADDR``/``MASTER_PORT``). On the card
    (the default device) the backend is NCCL and the process takes card
    ``local_rank``; gloo only where the caller names the CPU. Either other
    pairing raises: there is no fallback. Collectives time out after
    ``timeout_s`` seconds."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if (dev.type == "cuda") != (backend == "nccl"):
        raise ValueError(f"backend {backend!r} on device {dev.type!r}: the port runs NCCL on the "
                         "card and gloo on the CPU only")
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", 0)) if local_rank is None else local_rank
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None, axis_name: Union[str, Sequence[str]] = "data", *,
              shape: Optional[Sequence[int]] = None,
              device_type: str = "cuda") -> Optional[DeviceMesh]:
    """A ``DeviceMesh`` over the first ``n_devices`` ranks (all by default)
    of the initialised default process group, one dimension ``axis_name``,
    or the dimensions ``axis_name`` (a tuple) of ``shape``, ranks in
    row-major order. Ranks past ``n_devices`` get None. Device type "cuda"
    unless the caller asks for "cpu". The dimensions' subgroups time out
    after ``DEFAULT_TIMEOUT_S``. Raises when no process group is
    initialised: the port never makes a world of one on its own."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: call "
            "ti_torch.parallel.init_distributed (torch.distributed.init_process_group) first, "
            "or launch with torchrun")
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    world, rank = dist.get_world_size(), dist.get_rank()
    if shape is None:
        shape = (n_devices or world,) if len(names) == 1 else None
    if shape is None or len(shape) != len(names):
        raise ValueError(f"mesh dimensions {names} need a shape of as many sizes, got {shape}")
    n = math.prod(shape)
    if (n_devices is not None and n_devices != n) or n > world:
        raise ValueError(f"a mesh of shape {tuple(shape)} over {n_devices or world} of "
                         f"{world} ranks")
    if len(names) == 1 and n == world:
        return DeviceMesh.from_group(dist.group.WORLD, device_type, mesh_dim_names=names)
    grid = torch.arange(n).reshape(tuple(shape))
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    groups = []
    for d, size in enumerate(shape):
        mine = None
        for line in grid.movedim(d, -1).reshape(-1, size).tolist():
            group = dist.new_group(line, timeout=timeout)  # every rank joins every new_group
            if rank in line:
                mine = group
        groups.append(mine)
    if rank >= n:
        return None
    return DeviceMesh.from_group(groups if len(groups) > 1 else groups[0], device_type,
                                 mesh=grid, mesh_dim_names=names)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a batch lives on a mesh: on every rank (``axis_name`` None), or
    split along its leading axis over the ranks of mesh dimension
    ``axis_name``. ti_tpu's ``NamedSharding`` of the same name."""

    mesh: DeviceMesh
    axis_name: Optional[str] = None

    @property
    def group(self):
        return None if self.axis_name is None else self.mesh.get_group(self.axis_name)

    def sizes(self, n: int) -> list:
        """The rows of an n-row batch each rank of the dimension holds."""
        if self.axis_name is None:
            return [n]
        k = self.mesh.size(self.mesh.mesh_dim_names.index(self.axis_name))
        return [hi - lo for lo, hi in (shard_slice(n, r, k) for r in range(k))]

    def rows(self, n: int) -> tuple:
        """[start, stop) of this rank's rows of an n-row batch."""
        if self.axis_name is None:
            return 0, n
        k = self.mesh.size(self.mesh.mesh_dim_names.index(self.axis_name))
        return shard_slice(n, self.mesh.get_local_rank(self.axis_name), k)

    def block(self, tree):
        """This rank's rows of every leaf (tensor or array) of ``tree``."""
        if isinstance(tree, dict):
            return {k: self.block(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.block(v) for v in tree)
        lo, hi = self.rows(len(tree))
        return tree[lo:hi]


def replicated(mesh: DeviceMesh) -> Placement:
    return Placement(mesh)


def batch_sharded(mesh: DeviceMesh, axis_name: str = "data") -> Placement:
    return Placement(mesh, axis_name)


def shard_batch(tree, mesh: DeviceMesh, axis_name: str = "data"):
    """This rank's contiguous block of every leaf's leading axis, ranks in
    order and earlier ranks taking the remainder, so that gathering the
    blocks in rank order puts the batch back in place."""
    return batch_sharded(mesh, axis_name).block(tree)


def parallel_update(update_fn, mesh: DeviceMesh, axis_name: str = "data") -> Callable:
    """Data-parallel ``update_fn`` (a ``train.common.make_update_step``):
    ``step(generator, *batch) -> loss``, the whole batch on every rank.

    Each rank runs ``update_fn.loss_fn`` on its rows, with a ``ChainShard``
    for the generator (the whole batch's draws, sliced; the molecular loss
    centres over the whole batch). With ``accum_steps`` A each rank splits
    its rows into A microbatches (``shard_slice``): microbatch i of every
    rank makes the batch's microbatch i, whose loss is the mean over its
    rows, and the step's gradient is the mean over the A microbatches, as
    ``make_update_step`` takes it on one device for the batch laid out
    microbatch after microbatch. The weighted gradients and loss are
    all-reduced in one flat buffer before ``Optimizer.step``, so the clip,
    the NaN guard and the parameters are the same on every rank. Every
    rank's parameters are set to group rank 0's here."""
    from ti_torch.train.common import accumulate

    place = batch_sharded(mesh, axis_name)
    group = place.group
    opt, a = update_fn.optimizer, update_fn.accum_steps
    params = opt.params
    with torch.no_grad():
        for p in params:
            dist.broadcast(p.data, src=dist.get_global_rank(group, 0), group=group)
    me = mesh.get_local_rank(axis_name)

    def step(generator, *batch) -> float:
        sizes = place.sizes(len(batch[0]))
        if min(sizes) < a:
            raise ValueError(f"a batch of {len(batch[0])} over {len(sizes)} ranks in {a} "
                             f"microbatches leaves a rank an empty microbatch")
        micro = [[hi - lo for lo, hi in (shard_slice(s, i, a) for i in range(a))] for s in sizes]
        lo0, _ = place.rows(len(batch[0]))
        parts = []
        for i in range(a):
            lo, hi = shard_slice(sizes[me], i, a)
            width = sum(m[i] for m in micro)
            start = sum(m[i] for m in micro[:me])
            parts.append(((hi - lo) / (width * a),
                          ChainShard(generator, start, start + hi - lo, width, group),
                          [x[lo0 + lo:lo0 + hi] for x in batch]))
        loss, grads = accumulate(update_fn.loss_fn, params, parts)
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1).to(grads[0].dtype)])
        dist.all_reduce(flat, group=group)
        grads = [f.view_as(g) for f, g in zip(flat[:-1].split([g.numel() for g in grads]), grads)]
        return opt.step(flat[-1], grads)

    return step


def _gather_solution(sol, group, sizes):
    """The whole batch's ``ODESolution`` from every rank's rows; the NFE is
    the batch's (per chain for dopri5, else the largest)."""
    nfe = sol.nfe
    if isinstance(nfe, torch.Tensor) and nfe.ndim:
        nfe = gather_rows(nfe, group, sizes)
    else:
        nfe = all_max(int(nfe), group)
    return type(sol)(
        xs=gather_rows(sol.xs, group, sizes),
        dlogp=gather_rows(sol.dlogp, group, sizes),
        nfe=nfe,
        dlogp_var=None if sol.dlogp_var is None else gather_rows(sol.dlogp_var, group, sizes),
    )


def parallel_sampler(sampler_fn: Callable, mesh: DeviceMesh, axis_name: str = "data") -> Callable:
    """Chain-parallel sampling: ``sampler(x0s, conds, generator)`` with the
    whole chain batch on every rank runs ``sampler_fn`` on this rank's
    chains and returns the whole batch's ``ODESolution`` on every rank, its
    draws those of the unsharded run chain for chain."""
    place = batch_sharded(mesh, axis_name)
    group = place.group

    def sampler(x0s, conds, generator: Optional[torch.Generator] = None):
        n = len(x0s)
        sizes = place.sizes(n)
        if min(sizes) == 0:
            raise ValueError(f"{n} chains over {len(sizes)} ranks leave a rank none")
        lo, hi = place.rows(n)
        gen = None if generator is None else ChainShard(generator, lo, hi, n, group)
        with using_mesh(mesh):
            sol = sampler_fn(x0s[lo:hi], conds[lo:hi], gen)
        return _gather_solution(sol, group, sizes)

    return sampler


def lane_parallel_sampler(sampler_fn: Callable, mesh: DeviceMesh, *,
                          chain_axis: Optional[str] = None, lane_axis: str = "lanes") -> Callable:
    """Lane- (and with ``chain_axis`` chain-) sharded sampling.

    ``sampler_fn(x0s, conds, generator) -> ODESolution`` must be built with
    ``div_axis=lane_axis`` (``sampling.drivers.make_ode_sampler``): every
    divergence evaluation takes this rank's share of the tangent lanes and
    completes the trace with one all-reduce over the lane group. The primal
    and the trajectory run on every lane rank. With ``chain_axis`` the
    chains are split over that mesh dimension as ``parallel_sampler``
    splits them (a 2-D chains x lanes mesh). Takes the whole batch, returns
    the whole result on every rank."""
    if lane_axis not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh {mesh.mesh_dim_names} has no lane dimension {lane_axis!r}")
    inner = parallel_sampler(sampler_fn, mesh, chain_axis) if chain_axis else sampler_fn

    def sampler(x0s, conds, generator: Optional[torch.Generator] = None):
        with using_mesh(mesh):
            return inner(x0s, conds, generator)

    return sampler
