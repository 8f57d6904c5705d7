"""Run a function on the ranks of a CPU gloo world of spawned processes.

``run_ranks(fn, world, args)`` spawns ``world`` processes; each starts a
gloo process group through ``init_distributed`` (a ``file://`` store in a
fresh directory, so concurrent worlds never share a port), calls ``fn(rank,
world, *args)`` and leaves the group. ``fn`` must be importable by name
from a module that the children can import (spawned children import it
afresh). A rank that raises ends the run with its traceback within
``timeout_s``; a world that does not finish by then is killed. For the CPU
tests of the parallel layer and for rehearsing a multi-rank run without
cards.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
import time
import traceback
from typing import Callable, Sequence


def _rank_main(fn, rank: int, world: int, args, store: str, err_dir: str,
               timeout_s: float) -> None:
    import torch
    import torch.distributed as dist

    from ti_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    try:
        init_distributed("gloo", device="cpu", init_method=f"file://{store}", rank=rank,
                         world_size=world, timeout_s=timeout_s)
        fn(rank, world, *args)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(err_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, world: int, args: Sequence = (), *, timeout_s: float = 120.0,
              collective_timeout_s: float = 60.0) -> None:
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; raises
    RuntimeError naming the ranks that failed (with their tracebacks), or
    TimeoutError when the world is not done within ``timeout_s``."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ti_torch_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, tuple(args), store, tmp,
                                                      collective_timeout_s), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                failed = [p for p in procs if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        errors = {r: open(os.path.join(tmp, f"rank{r}.err")).read()
                  for r in range(world) if os.path.exists(os.path.join(tmp, f"rank{r}.err"))}
        codes = [p.exitcode for p in procs]
        if errors or any(c != 0 for c in codes):
            detail = "\n".join(f"--- rank {r} ---\n{e}" for r, e in sorted(errors.items()))
            if not errors and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks not done within {timeout_s} s "
                                   f"(exit codes {codes})")
            raise RuntimeError(f"ranks failed (exit codes {codes}):\n{detail}")
