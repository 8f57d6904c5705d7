"""Train the MDQM9 ambient (T0->T1) cPaiNN model on the card (port of
scripts/mdqm9_train_ambient.py; reference: python mdqm9/train_ambient.py).

Usage: python -m ti_torch.cli.mdqm9_train_ambient --preset 00031:300
   or: python -m ti_torch.cli.mdqm9_train_ambient --config path.json
with ``--key value`` overrides of any ``MDQM9Config`` field,
``--fast_profile`` and ``--device`` (default: the card).
"""

from __future__ import annotations

import argparse
import json
import sys

from ti_torch.config import MDQM9Config, ambient_preset, fast_profile, load_config


def parse(argv):
    """The ``MDQM9Config`` of a command line: ``--config`` or ``--preset
    mol:T`` (or the defaults), then ``--key value`` overrides, then
    ``--fast_profile`` with the explicit overrides kept."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--preset", default=None, help="mol:leave_out_T, e.g. 00031:300")
    ap.add_argument("--fast_profile", action="store_true",
                    help="apply the physics-qualified throughput profile "
                         "(rk4 + GL-8 dlogp, bf16_agg, hutchinson with the "
                         "scale-qualified probe count — config.fast_profile)")
    known, rest = ap.parse_known_args(argv)
    overrides = {}
    it = iter(rest)
    for k in it:
        overrides[k.lstrip("-")] = next(it)
    if known.config:
        cfg = load_config(known.config, MDQM9Config, **overrides)
    elif known.preset:
        mol, t = known.preset.split(":")
        cfg = ambient_preset(mol, int(t), **overrides)
    else:
        cfg = MDQM9Config()
        for k, v in overrides.items():
            cur = getattr(cfg, k)
            setattr(cfg, k, type(cur)(v) if not isinstance(cur, list) else json.loads(v))
    if known.fast_profile:
        # explicit flags already applied above stay (re-passed as overrides)
        cfg = fast_profile(cfg, **{k: getattr(cfg, k) for k in overrides if hasattr(cfg, k)})
    return cfg


def split_device(argv):
    """(``--device`` or None for the card, the other arguments)."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--device", default=None)
    known, rest = ap.parse_known_args(argv)
    return known.device, rest


def main(argv=None) -> int:
    from ti_torch.train.ambient import train_ambient

    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    out = train_ambient(parse(rest), device=device)
    print(json.dumps({"epochs": len(out["history"]["train_loss"]),
                      "train_loss": out["history"]["train_loss"][-1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
