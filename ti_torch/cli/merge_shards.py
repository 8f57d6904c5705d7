"""Merge sharded sampling artifacts back into the unsharded filenames
(port of scripts/merge_shards.py).

Usage: python -m ti_torch.cli.merge_shards <data_dir> <num_shards> [--delete]
See ti_torch/parallel/fanout.py for the fan-out launch shape.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from ti_torch.parallel.fanout import merge_shards

    argv = sys.argv[1:] if argv is None else argv
    data_dir, k = argv[0], int(argv[1])
    merged = merge_shards(data_dir, k, delete="--delete" in argv)
    for out, parts in merged.items():
        print(f"{out} <- {len(parts)} shards")
    return 0


if __name__ == "__main__":
    sys.exit(main())
