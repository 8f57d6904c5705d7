"""Train the MDQM9 latent Boltzmann generator on the card (port of
scripts/mdqm9_train_latent.py; reference: python mdqm9/train_latent.py).

Usage: python -m ti_torch.cli.mdqm9_train_latent --preset 00031[:T]
   or: python -m ti_torch.cli.mdqm9_train_latent --config path.json
with ``--key value`` overrides of any ``MDQM9Config`` field,
``--fast_profile`` (the latent family's) and ``--device`` (default: the
card). Writes ``{model_save_path}/{name}/{name}_{epoch}.npz`` every epoch
and prints one JSON line: the epochs and the last epoch's loss.
"""

from __future__ import annotations

import argparse
import json
import sys

from ti_torch.config import MDQM9Config, fast_profile, latent_preset, load_config


def parse(argv):
    """The ``MDQM9Config`` of a command line: ``--config`` or ``--preset
    mol[:T]`` (or the defaults), then ``--key value`` overrides, then
    ``--fast_profile`` (family "latent") with the explicit overrides kept."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--preset", default=None, help="mol[:T], e.g. 00031 or 00031:800")
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
        parts = known.preset.split(":")
        Ts = [int(parts[1])] if len(parts) > 1 else None
        cfg = latent_preset(parts[0], Ts=Ts, **overrides)
    else:
        cfg = MDQM9Config()
        for k, v in overrides.items():
            cur = getattr(cfg, k)
            setattr(cfg, k, type(cur)(v) if not isinstance(cur, list) else json.loads(v))
    if known.fast_profile:
        cfg = fast_profile(cfg, family="latent", **{
            k: getattr(cfg, k) for k in overrides if hasattr(cfg, k)
        })
    return cfg


def main(argv=None) -> int:
    from ti_torch.cli.mdqm9_train_ambient import split_device
    from ti_torch.train.latent import train_latent

    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    out = train_latent(parse(rest), device=device)
    print(json.dumps({"epochs": len(out["history"]["train_loss"]),
                      "train_loss": out["history"]["train_loss"][-1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
