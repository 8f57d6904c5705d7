from ti_torch.parallel.mesh import (
    batch_sharded,
    init_distributed,
    lane_parallel_sampler,
    make_mesh,
    parallel_sampler,
    parallel_update,
    replicated,
    shard_batch,
)

__all__ = [
    "make_mesh",
    "replicated",
    "batch_sharded",
    "shard_batch",
    "parallel_sampler",
    "parallel_update",
    "lane_parallel_sampler",
    "init_distributed",
]
