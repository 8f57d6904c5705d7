"""Sample the trained ADW model with dlogp on the card (port of
scripts/adw_sample.py; reference: python adw/sample.py).

Takes ``adw_train``'s arguments (``--device`` among them), reads
``{model_save_path}/{name}/epoch_{sampling_epoch}.npz`` (the last epoch when
``sampling_epoch`` is -1) and transports the test split from its beta0 to
``beta1s[0]``, writing ``{data_save_path}/{name}/beta_{b0}_to_{b1}/
{initial_samples,samples,dlogps}_epoch_{sampling_epoch}.npy``. ``--shard i
--num_shards K`` takes shard i's block of the split on its own RNG stream.
Prints one JSON line: the chains, the NFE, the seed and the seconds.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main(argv=None) -> int:
    from ti_torch import resolve_device
    from ti_torch.cli.adw_train import parse
    from ti_torch.cli.mdqm9_train_ambient import split_device
    from ti_torch.data.adw import ADWDataset
    from ti_torch.parallel.fanout import shard_config, shard_slice
    from ti_torch.sampling.drivers import sample_adw
    from ti_torch.train.adw import build_adw_model
    from ti_torch.train.common import load_checkpoint

    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    cfg = parse(rest)
    model = build_adw_model(cfg)
    epoch = cfg.sampling_epoch if cfg.sampling_epoch >= 0 else cfg.epochs - 1
    params = {k: v.to(dev) for k, v in load_checkpoint(os.path.join(
        cfg.model_save_path, cfg.model_save_name, f"epoch_{epoch}.npz")).items()}
    csv = os.path.join(cfg.traj_path, cfg.traj_filename)
    dataset = ADWDataset.from_csv(csv, cfg.beta0s, cfg.n_samples, seed=cfg.seed)
    _, _, test = dataset.splits()
    x, beta = test.x, test.beta.reshape(-1)
    if cfg.num_shards > 1:  # fan-out (parallel/fanout.py)
        lo, hi = shard_slice(len(x), cfg.shard, cfg.num_shards)
        x, beta = x[lo:hi], beta[lo:hi]
        cfg = shard_config(cfg, cfg.shard, cfg.num_shards)
    t0 = time.perf_counter()
    out = sample_adw(cfg, model, params, x, beta, device=dev)
    seconds = time.perf_counter() - t0
    print(json.dumps({"n": int(out["samples"].shape[1]), "nfe": out["nfe"], "seed": cfg.seed,
                      "seconds": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
