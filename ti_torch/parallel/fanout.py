"""Multi-host fan-out for embarrassingly parallel sampling shards (a copy
of ti_tpu/parallel/fanout.py: numpy only, so the port does not import the
JAX package).

Sampling chains are independent, so each process runs a disjoint shard and
only the final statistics stage touches all artifacts. This module does
that as artifact-level sharding, in the reference's .npy pipeline shape
(samples_*/dlogps_* files, mdqm9/sample_ambient.py:85-101):

- ``shard_config(cfg, shard, num_shards)`` derives a per-shard config:
  disjoint RNG stream (seed folded with a large odd stride) and
  ``data_save_name`` suffixed ``_shard{i}of{K}`` so shards never collide;
- ``shard_slice(n, shard, num_shards)`` splits a workload contiguously;
- ``merge_shards(data_dir, num_shards)`` concatenates every sharded
  artifact family back into the unsharded filenames the analysis layer
  expects.

Launch shape: ``python -m ti_torch.cli.mdqm9_sample_ambient --config c.json
--shard $i --num_shards K`` on each host or card (any scheduler, or
``python -m ti_torch.cli.fanout_driver`` on one machine), then ``python -m
ti_torch.cli.merge_shards <data_dir> <K>`` once. No process group is
needed: each process uses only its own card.
"""

from __future__ import annotations

import dataclasses
import glob
import os

from typing import Dict, List, Tuple

import numpy as np

_SEED_STRIDE = 7919  # large odd stride keeps per-shard PRNG streams apart

def shard_slice(n: int, shard: int, num_shards: int) -> Tuple[int, int]:
    """Contiguous [start, stop) of a length-n workload for this shard."""
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} not in [0, {num_shards})")
    base, rem = divmod(n, num_shards)
    start = shard * base + min(shard, rem)
    stop = start + base + (1 if shard < rem else 0)
    return start, stop

def shard_config(cfg, shard: int, num_shards: int):
    """Per-shard copy of a sampling config (no-op when num_shards == 1).

    Folds the seed (disjoint PRNG streams) and, where the config names its
    artifacts via ``data_save_name`` (MDQM9), suffixes it with the shard
    token. The ADW artifact tag gets its token inside sample_adw (its
    filenames are epoch-keyed, drivers.py)."""
    if num_shards == 1:
        return cfg
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} not in [0, {num_shards})")
    kwargs = dict(
        seed=cfg.seed + _SEED_STRIDE * (shard + 1),
        shard=shard,
        num_shards=num_shards,
    )
    if hasattr(cfg, "data_save_name"):
        kwargs["data_save_name"] = f"{cfg.data_save_name}_shard{shard}of{num_shards}"
    return dataclasses.replace(cfg, **kwargs)

def merge_shards(
    data_dir: str, num_shards: int, delete: bool = False
) -> Dict[str, List[str]]:
    """Concatenate every ``*_shard0of{K}*`` artifact family in data_dir.

    The chain axis is 0 for the molecular artifacts and 1 for the ADW
    ``samples_/dlogps_/initial...`` layout ((n_save, n_chains), kept for
    reference parity — adw/sample.py:63-69); initial_samples is 1-D. The
    axis is inferred per family from the shard-0 array rank/prefix.
    Returns {merged_path: [shard paths]}. Raises if any family is missing a
    shard (a crashed host shows up as an explicit error, not silent data
    loss)."""
    token0 = f"_shard0of{num_shards}"
    merged: Dict[str, List[str]] = {}
    for f0 in sorted(glob.glob(os.path.join(data_dir, f"*{token0}*.npy"))):
        parts = []
        for i in range(num_shards):
            fi = f0.replace(token0, f"_shard{i}of{num_shards}")
            if not os.path.exists(fi):
                raise FileNotFoundError(f"missing shard artifact: {fi}")
            parts.append(fi)
        arrays = [np.load(p) for p in parts]
        # chain axis: 0 everywhere except the ADW time-major 2-D layout
        # (samples/dlogps of shape (n_save, n_chains))
        name = os.path.basename(f0)
        axis = (
            1
            if arrays[0].ndim == 2 and name.startswith(("samples_", "dlogps_"))
            else 0
        )
        out_path = f0.replace(token0, "")
        np.save(out_path, np.concatenate(arrays, axis=axis))
        merged[out_path] = parts
        if delete:
            for p in parts:
                os.remove(p)
    if not merged:
        raise FileNotFoundError(
            f"no '*{token0}*.npy' artifacts found in {data_dir}"
        )
    return merged
