"""Sample the trained ambient model T0->T1 with dlogp on the card (port of
scripts/mdqm9_sample_ambient.py; reference: python mdqm9/sample_ambient.py),
with the optional BG->TI composition from latent trajectories.

Takes ``mdqm9_train_ambient``'s arguments plus ``--shard i --num_shards K``
(``ti_torch.parallel.fanout``): shard i transports its contiguous block of
the test split on its own RNG stream into ``*_shard{i}of{K}`` artifacts,
which ``merge_shards`` joins. Prints one JSON line: the chains, the NFE,
the seed, the seconds, and the launches of kernels B1 and B3 in this process by
kernel and by library (``ti_torch.ops._build``).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    from ti_torch.cli.mdqm9_train_ambient import parse, split_device
    from ti_torch.data.mdqm9 import MDQM9AmbientDataset
    from ti_torch.ops import _build
    from ti_torch.parallel.fanout import shard_config, shard_slice
    from ti_torch.sampling.drivers import sample_ambient
    from ti_torch.train.ambient import build_ambient_model
    from ti_torch.train.common import checkpoint_path, load_checkpoint

    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    cfg = parse(rest)
    ds = MDQM9AmbientDataset.load(
        cfg.traj_path, cfg.sdf_path, cfg.mdqm9_traj_filename, cfg.sdf_filename,
        split="test", Ts=[cfg.sampling_T0], scale=cfg.scale_trajs,
    )
    model = build_ambient_model(cfg, ds.template.n_atoms)
    params = load_checkpoint(checkpoint_path(os.path.join(cfg.model_save_path,
                                                          cfg.model_save_name),
                                             cfg.model_save_name, cfg.model_epoch))
    latent_z = latent_dlogp = None
    if cfg.latent_traj_path:
        stem = cfg.mdqm9_traj_filename.split(".")[0]
        latent = np.load(os.path.join(
            cfg.latent_traj_path, f"samples_mol_{stem}_{cfg.sampling_T0}k_forward.npy"
        ))[: cfg.n_latent_samples]
        latent_z = latent[:, 0]
        x0 = latent[:, -1]
        latent_dlogp = np.load(os.path.join(
            cfg.latent_traj_path, f"dlogps_mol_{stem}_{cfg.sampling_T0}k_forward.npy"
        ))[: cfg.n_latent_samples]
    else:
        x0 = ds.frames

    if cfg.num_shards > 1:  # fan-out (parallel/fanout.py)
        lo, hi = shard_slice(len(x0), cfg.shard, cfg.num_shards)
        x0 = x0[lo:hi]
        if latent_z is not None:
            latent_z, latent_dlogp = latent_z[lo:hi], latent_dlogp[lo:hi]
        cfg = shard_config(cfg, cfg.shard, cfg.num_shards)

    _build.reset_launches()
    t0 = time.perf_counter()
    out = sample_ambient(cfg, model, params, ds.template, x0, latent_z, latent_dlogp,
                         device=device)
    seconds = time.perf_counter() - t0
    print(json.dumps({
        "n": len(out["samples"]), "nfe": out["nfe"], "seed": cfg.seed, "shard": cfg.shard,
        "num_shards": cfg.num_shards, "seconds": seconds,
        "launches": {k: _build.LAUNCHES[k] for k in ("pair_layer", "pair_tangent")},
        "route_launches": {f"{k}:{lib}": n for (k, lib), n in _build.ROUTE_LAUNCHES.items()
                           if k in ("pair_layer", "pair_tangent")},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
