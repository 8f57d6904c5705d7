"""SDE (Euler–Maruyama) transport of the trained ambient model T0->T1 on the
card, with no dlogp (port of scripts/mdqm9_sample_sde.py; the reference's
sampler is ODE-only).

Takes ``mdqm9_train_ambient``'s arguments (``--device`` among them), reads
the ambient checkpoint ``{model_save_path}/{name}/{name}_{model_epoch}_weights.npz``
and transports the test split at ``sampling_T0``, writing
``initial_samples_{data_save_name}_sde.npy`` and ``samples_..._sde.npy``
(C, n_save, N, 3) beside the ODE sampler's artifacts; the "_sde" suffix
comes before the fan-out's shard token (``--shard i --num_shards K``), so
``merge_shards`` matches the family.

Config keys (all also flags): ``sde_g`` (noise scale), ``n_steps``,
``compute_dtype`` (the dense drift's), ``sde_forward_impl`` ("dense" |
"pair_kernel": kernel B1 in f32, one launch a layer a step, as the JAX
script passes no ``chain_block``). Prints one JSON line: the chains, the
steps, the seconds and the launches of kernels B1 and B3 by kernel and by
library.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    import torch

    from ti_torch import resolve_device
    from ti_torch.cli.mdqm9_sample_ambient import kernel_launches
    from ti_torch.cli.mdqm9_train_ambient import parse, split_device
    from ti_torch.data.mdqm9 import MDQM9AmbientDataset
    from ti_torch.ops import _build
    from ti_torch.parallel.fanout import shard_config, shard_slice
    from ti_torch.sampling.drivers import _compute_dtype, sample_molecular_sde
    from ti_torch.train.ambient import build_ambient_model
    from ti_torch.train.common import checkpoint_path, load_checkpoint

    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    cfg = parse(rest)
    # "_sde" before shard_config, so that the shard token lands last
    cfg = dataclasses.replace(cfg, data_save_name=f"{cfg.data_save_name}_sde")
    ds = MDQM9AmbientDataset.load(
        cfg.traj_path, cfg.sdf_path, cfg.mdqm9_traj_filename, cfg.sdf_filename,
        split="test", Ts=[cfg.sampling_T0], scale=cfg.scale_trajs,
    )
    model = build_ambient_model(cfg, ds.template.n_atoms)
    params = load_checkpoint(checkpoint_path(os.path.join(cfg.model_save_path,
                                                          cfg.model_save_name),
                                             cfg.model_save_name, cfg.model_epoch))
    x0 = ds.frames
    if cfg.num_shards > 1:  # fan-out (parallel/fanout.py)
        lo, hi = shard_slice(len(x0), cfg.shard, cfg.num_shards)
        x0 = x0[lo:hi]
        cfg = shard_config(cfg, cfg.shard, cfg.num_shards)

    temps = np.tile(np.array([float(cfg.sampling_T0), float(cfg.sampling_T1)], np.float32),
                    (len(x0), 1))
    impl = cfg.sde_forward_impl
    _build.reset_launches()
    t0 = time.perf_counter()
    out = sample_molecular_sde(
        model, params, ds.template, x0, temps, torch.Generator(device=dev).manual_seed(cfg.seed),
        g_fn=cfg.sde_g, n_steps=cfg.n_steps,
        compute_dtype=None if impl == "pair_kernel" else _compute_dtype(cfg),
        forward_impl=impl, device=dev,
    )
    samples = out.cpu().numpy()  # (C, n_save, N, 3)
    seconds = time.perf_counter() - t0

    os.makedirs(cfg.data_save_path, exist_ok=True)
    name = cfg.data_save_name
    np.save(os.path.join(cfg.data_save_path, f"initial_samples_{name}.npy"), np.asarray(x0))
    np.save(os.path.join(cfg.data_save_path, f"samples_{name}.npy"), samples)
    print(json.dumps({
        "n": len(samples), "n_steps": cfg.n_steps, "g": cfg.sde_g, "impl": impl,
        "seed": cfg.seed, "seconds": seconds,
        "out": os.path.join(cfg.data_save_path, f"samples_{name}.npy"), **kernel_launches(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
