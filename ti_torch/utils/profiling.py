"""Offline summariser of Chrome traces (copy of ti_tpu/utils/profiling.py,
which is stdlib only): the traces ``torch.profiler`` exports
(``ti_torch.utils.logging.profile_trace`` writes ``*.pt.trace.json``) and
the JAX package's ``*.trace.json.gz``.

It reduces a trace to the table that matters for kernel work: per lane (a
(process, thread) pair; torch.profiler puts the card's kernels on lanes
of their own, one a CUDA stream), each op's total time and call count, and
the lane's busy share of its span (nested spans merged).

Pure stdlib (json + gzip): it runs anywhere, the card's machine and the CPU
tests alike.
"""

from __future__ import annotations

import glob
import gzip
import json
import os

from collections import defaultdict
from typing import Dict, List, NamedTuple


class OpStat(NamedTuple):
    name: str
    count: int
    total_us: float

    @property
    def avg_us(self) -> float:
        return self.total_us / max(self.count, 1)


class LaneSummary(NamedTuple):
    """One timeline lane: a (process, thread) pair of the trace."""

    process: str
    thread: str
    ops: List[OpStat]          # sorted by total (inclusive) time, descending
    busy_us: float             # union of event intervals (nested spans merged)
    span_us: float             # last end - first start on this lane


# the "cat" of the events torch.profiler records on the card's own lanes
DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
TRACE_PATTERNS = ("*.pt.trace.json", "*.pt.trace.json.gz", "*.trace.json.gz")


def find_trace_file(logdir: str) -> str:
    """The trace under ``logdir``: a file path as it is; else the newest
    ``*.trace.json.gz`` under logdir/plugins/profile/<run>/ (the JAX
    profiler's layout); else the newest of ``TRACE_PATTERNS`` in logdir
    (``torch.profiler``'s ``*.pt.trace.json``)."""
    if os.path.isfile(logdir):
        return logdir
    pattern = os.path.join(logdir, "plugins", "profile", "*", "*.trace.json.gz")
    files = sorted(glob.glob(pattern), key=os.path.getmtime)
    if not files:
        files = sorted((f for p in TRACE_PATTERNS for f in glob.glob(os.path.join(logdir, p))),
                       key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no trace ({', '.join(TRACE_PATTERNS)}) under {logdir!r}")
    return files[-1]


def load_trace(path_or_logdir: str) -> dict:
    path = (
        path_or_logdir
        if os.path.isfile(path_or_logdir)
        else find_trace_file(path_or_logdir)
    )
    # a trace may be gzipped or not whatever its name: sniff the magic
    with open(path, "rb") as f:
        is_gz = f.read(2) == b"\x1f\x8b"
    opener = gzip.open if is_gz else open
    with opener(path, "rt") as f:
        return json.load(f)


def summarize_lanes(trace: dict) -> List[LaneSummary]:
    """Aggregate complete ("ph": "X") events per (process, thread) lane. A
    lane that holds the card's own events (``DEVICE_CATEGORIES``:
    torch.profiler's kernels, copies and sets) has " [cuda]" after its
    process name, so that ``lane_filter="cuda"`` selects the device lanes."""
    proc_names: Dict[int, str] = {}
    thread_names: Dict[tuple, str] = {}
    events = trace.get("traceEvents", [])
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            proc_names[e["pid"]] = e.get("args", {}).get("name", str(e["pid"]))
        elif e.get("ph") == "M" and e.get("name") == "thread_name":
            thread_names[(e["pid"], e.get("tid"))] = e.get("args", {}).get(
                "name", str(e.get("tid"))
            )

    device_lanes = {(e["pid"], e.get("tid")) for e in events
                    if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES}
    agg: Dict[tuple, Dict[str, List[float]]] = defaultdict(
        lambda: defaultdict(lambda: [0, 0.0])
    )
    intervals: Dict[tuple, List[tuple]] = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        key = (e["pid"], e.get("tid"))
        dur = float(e.get("dur", 0.0))
        ts = float(e.get("ts", 0.0))
        cell = agg[key][e.get("name", "?")]
        cell[0] += 1
        cell[1] += dur
        intervals[key].append((ts, ts + dur))

    lanes = []
    for key, by_name in agg.items():
        ops = sorted(
            (OpStat(n, int(c), t) for n, (c, t) in by_name.items()),
            key=lambda o: -o.total_us,
        )
        # busy time = UNION of the lane's intervals: host lanes nest spans
        # (parent + children overlap), so summing durations would
        # double-count and report >100% busy
        ivs = sorted(intervals[key])
        busy = 0.0
        cur_lo, cur_hi = ivs[0]
        for lo, hi in ivs[1:]:
            if lo > cur_hi:
                busy += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        busy += cur_hi - cur_lo
        lanes.append(
            LaneSummary(
                process=proc_names.get(key[0], str(key[0]))
                + (" [cuda]" if key in device_lanes else ""),
                thread=thread_names.get(key, str(key[1])),
                ops=ops,
                busy_us=busy,
                span_us=max(hi for _, hi in ivs) - ivs[0][0],
            )
        )
    lanes.sort(key=lambda l: -l.busy_us)
    return lanes


def format_summary(
    lanes: List[LaneSummary], top: int = 15, lane_filter: str = ""
) -> str:
    """Human-readable per-lane op tables (filter by substring on
    'process/thread'; device lanes sort first by busy time)."""
    out = []
    for lane in lanes:
        label = f"{lane.process} / {lane.thread}"
        if lane_filter and lane_filter.lower() not in label.lower():
            continue
        busy_pct = 100.0 * lane.busy_us / lane.span_us if lane.span_us else 0.0
        out.append(
            f"== {label}: {lane.busy_us/1e3:.2f} ms busy over "
            f"{lane.span_us/1e3:.2f} ms span ({busy_pct:.0f}%), "
            f"{len(lane.ops)} distinct ops"
        )
        out.append(f"{'total ms':>10} {'count':>7} {'avg us':>9}  op")
        for op in lane.ops[:top]:
            out.append(
                f"{op.total_us/1e3:10.3f} {op.count:7d} {op.avg_us:9.1f}  {op.name[:90]}"
            )
        rest = lane.ops[top:]
        if rest:
            out.append(
                f"{sum(o.total_us for o in rest)/1e3:10.3f} {sum(o.count for o in rest):7d}"
                f" {'':>9}  (+{len(rest)} more ops)"
            )
        out.append("")
    return "\n".join(out)


def summarize(logdir: str, top: int = 15, lane_filter: str = "") -> str:
    return format_summary(summarize_lanes(load_trace(logdir)), top, lane_filter)
