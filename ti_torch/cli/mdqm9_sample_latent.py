"""Generate conformations from noise with the trained latent model on the card
(port of scripts/mdqm9_sample_latent.py; reference: python
mdqm9/sample_latent.py).

Takes ``mdqm9_train_latent``'s arguments (``--preset mol[:T]``,
``--fast_profile``, ``--key value`` overrides, ``--device``), reads
``{model_save_path}/{name}/{name}_{model_epoch}.npz`` and writes
``samples_{data_save_name}_forward.npy`` and ``dlogps_..._forward.npy``.
With ``--traj_forward_impl pair_kernel --div_forward_impl pair_tangent
--compute_dtype f32`` it is the latent kernel route: kernel B1 on the
trajectory and B3's full frame at the divergence nodes. ``--shard i
--num_shards K`` generates shard i's block of ``n_latent_samples`` on its
own RNG stream into ``*_shard{i}of{K}`` artifacts (``merge_shards`` joins
them). Prints one JSON line: the chains, the NFE, the seed, the seconds and
the launches of kernels B1 and B3 by kernel and by library.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main(argv=None) -> int:
    from ti_torch import resolve_device
    from ti_torch.cli.mdqm9_sample_ambient import kernel_launches
    from ti_torch.cli.mdqm9_train_ambient import split_device
    from ti_torch.cli.mdqm9_train_latent import parse
    from ti_torch.data.mdqm9 import MDQM9LatentDataset
    from ti_torch.ops import _build
    from ti_torch.parallel.fanout import shard_config, shard_slice
    from ti_torch.sampling.drivers import sample_latent
    from ti_torch.train.common import load_checkpoint
    from ti_torch.train.latent import build_latent_model, checkpoint_path

    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    device = resolve_device(device)  # no card and no --device: raise before any work
    cfg = parse(rest)
    ds = MDQM9LatentDataset.load(
        cfg.traj_path, cfg.sdf_path, cfg.mdqm9_traj_filename, cfg.sdf_filename,
        split="test", Ts=cfg.T, scale=cfg.scale_trajs, align=cfg.align,
    )
    model = build_latent_model(cfg, ds.template.n_atoms)
    params = load_checkpoint(checkpoint_path(os.path.join(cfg.model_save_path,
                                                          cfg.model_save_name),
                                             cfg.model_save_name, cfg.model_epoch))
    n_samples = None
    if cfg.num_shards > 1:  # fan-out (parallel/fanout.py)
        lo, hi = shard_slice(cfg.n_latent_samples, cfg.shard, cfg.num_shards)
        n_samples = hi - lo
        cfg = shard_config(cfg, cfg.shard, cfg.num_shards)

    _build.reset_launches()
    t0 = time.perf_counter()
    out = sample_latent(cfg, model, params, ds.template, n_samples=n_samples, device=device)
    seconds = time.perf_counter() - t0
    print(json.dumps({
        "n": len(out["samples"]), "nfe": out["nfe"], "seed": cfg.seed, "shard": cfg.shard,
        "num_shards": cfg.num_shards, "seconds": seconds, **kernel_launches(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
