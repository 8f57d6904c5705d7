"""Summarise a trace offline (port of scripts/profile_summary.py; no
TensorBoard needed).

Usage:
  python -m ti_torch.cli.profile_summary <logdir-or-trace> [--top N] [--lane SUBSTR]

<logdir> is what was passed to ``ti_torch.utils.logging.profile_trace``: the
newest ``*.pt.trace.json`` there is summarised (a JAX profiler log
directory works too). ``--lane`` filters timeline lanes by substring of
"process / thread": ``--lane cuda`` keeps the card's lanes, the kernels
and copies ``torch.profiler`` recorded there. See ti_torch/utils/profiling.py.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from ti_torch.utils.profiling import summarize

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("logdir")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--lane", default="")
    args = ap.parse_args(argv)
    print(summarize(args.logdir, top=args.top, lane_filter=args.lane))
    return 0


if __name__ == "__main__":
    sys.exit(main())
