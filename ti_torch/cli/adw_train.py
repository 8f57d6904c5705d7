"""Train the ADW velocity field on the card (port of scripts/adw_train.py;
reference entry: python adw/train.py).

Usage: python -m ti_torch.cli.adw_train [--config path.json] [--key value ...]
[--device cpu]. Writes ``{model_save_path}/{name}/epoch_{n}.npz`` every epoch
and prints one JSON line: the epochs and the last epoch's losses.
"""

from __future__ import annotations

import argparse
import json
import sys

from ti_torch.config import ADWConfig, load_config


def parse(argv):
    """The ``ADWConfig`` of a command line: ``--config`` (or the defaults),
    then ``--key value`` overrides."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    known, rest = ap.parse_known_args(argv)
    overrides = {}
    it = iter(rest)
    for k in it:
        overrides[k.lstrip("-")] = next(it)
    if known.config:
        return load_config(known.config, ADWConfig, **overrides)
    cfg = ADWConfig()
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        setattr(cfg, k, type(cur)(v) if not isinstance(cur, list) else json.loads(v))
    return cfg


def main(argv=None) -> int:
    from ti_torch.cli.mdqm9_train_ambient import split_device
    from ti_torch.train.adw import train_adw

    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    out = train_adw(parse(rest), device=device)
    print(json.dumps({"epochs": len(out["history"]["train_loss"]),
                      "train_loss": out["history"]["train_loss"][-1],
                      "val_loss": out["history"]["val_loss"][-1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
