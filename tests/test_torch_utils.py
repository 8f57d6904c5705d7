"""The port's utilities against ti_tpu's: the trace summariser
(ti_torch.utils.profiling) on one synthetic Chrome trace, a
``profile_trace`` CPU trace read back, and the timers (ti_torch.utils.timing)
on the CPU. The card's side (CUDA events, the device lanes of a
``torch.profiler`` trace) runs in chip_smoke_cli.py."""

import gzip
import json
import os

import pytest
import torch

from ti_tpu.utils import profiling as jax_profiling
from ti_torch.cli import profile_summary
from ti_torch.utils import profiling, timing
from ti_torch.utils.logging import profile_trace


def _trace():
    """Two lanes: a host thread with nested spans (a parent holding two
    children, then a gap) and a device stream, with their metadata."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "python"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 11, "args": {"name": "main"}},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7"}},
        {"ph": "X", "name": "step", "pid": 1, "tid": 11, "ts": 0.0, "dur": 100.0},
        {"ph": "X", "name": "aten::mm", "pid": 1, "tid": 11, "ts": 10.0, "dur": 30.0},
        {"ph": "X", "name": "aten::mm", "pid": 1, "tid": 11, "ts": 50.0, "dur": 20.0},
        {"ph": "X", "name": "aten::add", "pid": 1, "tid": 11, "ts": 150.0, "dur": 10.0},
        {"ph": "X", "name": "gemm", "pid": 0, "tid": 7, "ts": 20.0, "dur": 40.0},
        {"ph": "X", "name": "gemm", "pid": 0, "tid": 7, "ts": 70.0, "dur": 40.0},
        {"ph": "X", "name": "add_kernel", "pid": 0, "tid": 7, "ts": 155.0, "dur": 5.0},
        {"ph": "i", "name": "marker", "pid": 1, "tid": 11, "ts": 5.0},
    ]
    return {"traceEvents": ev}


def test_summary_matches_jax():
    trace = _trace()
    ours, ref = profiling.summarize_lanes(trace), jax_profiling.summarize_lanes(trace)
    assert ours == ref
    host = next(l for l in ours if l.thread == "main")
    assert host.busy_us == 110.0 and host.span_us == 160.0  # nested spans merged
    assert [(o.name, o.count) for o in host.ops] == [("step", 1), ("aten::mm", 2),
                                                     ("aten::add", 1)]
    for top, lane in ((15, ""), (1, "stream"), (2, "GPU")):
        assert profiling.format_summary(ours, top, lane) == \
            jax_profiling.format_summary(ref, top, lane)


def test_device_lanes_are_tagged(tmp_path, capsys):
    """A lane holding torch.profiler's device events ("cat": "kernel")
    carries " [cuda]", so ``--lane cuda`` keeps it alone; a gzipped
    ``*.pt.trace.json.gz`` is found and read."""
    trace = _trace()
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e["pid"] == 0:
            e["cat"] = "kernel"
    with gzip.open(tmp_path / "w.1.pt.trace.json.gz", "wt") as f:
        json.dump(trace, f)
    lanes = profiling.summarize_lanes(profiling.load_trace(str(tmp_path)))
    assert sorted(l.process for l in lanes) == ["GPU 0 [cuda]", "python"]
    assert profile_summary.main([str(tmp_path), "--lane", "cuda"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("== GPU 0 [cuda] / stream 7: 0.09 ms busy over 0.14 ms span (61%)")
    assert "gemm" in out and "aten::mm" not in out


def test_find_trace_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="no trace"):
        profiling.find_trace_file(str(tmp_path))
    jax_run = tmp_path / "plugins" / "profile" / "run1"
    jax_run.mkdir(parents=True)
    (jax_run / "host.trace.json.gz").write_bytes(b"")
    (tmp_path / "a.pt.trace.json").write_text("{}")
    # the JAX profiler's layout first, as ti_tpu's; then torch.profiler's files
    assert profiling.find_trace_file(str(tmp_path)) == str(jax_run / "host.trace.json.gz")
    assert profiling.find_trace_file(str(tmp_path / "a.pt.trace.json")) == \
        str(tmp_path / "a.pt.trace.json")
    other = tmp_path / "torch_only"
    other.mkdir()
    (other / "old.pt.trace.json").write_text("{}")
    (other / "new.pt.trace.json").write_text("{}")
    os.utime(other / "old.pt.trace.json", (1, 1))
    assert profiling.find_trace_file(str(other)) == str(other / "new.pt.trace.json")


def test_profile_trace_on_the_cpu(tmp_path, capsys):
    """One Chrome trace of the region is exported, found and summarised,
    and lists the region's ``aten::mm``; a falsy log_dir traces nothing."""
    a = torch.randn(32, 32)
    with profile_trace(str(tmp_path), device="cpu") as prof:
        (a @ a).sum()
    assert prof is not None
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    ops = {o.name for l in profiling.summarize_lanes(profiling.load_trace(str(tmp_path)))
           for o in l.ops}
    assert "aten::mm" in ops
    assert profile_summary.main([str(tmp_path), "--top", "40"]) == 0
    assert "aten::mm" in capsys.readouterr().out
    with profile_trace("", device="cpu") as none:
        assert none is None
    with profile_trace(None) as none:  # no card needed when it does nothing
        assert none is None


def test_profile_trace_needs_the_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profile_trace(str(tmp_path)):
            pass
    assert not os.listdir(tmp_path)


def test_timing_on_the_cpu(monkeypatch):
    """``device_time`` hands ``fn`` the rep index and times ``reps`` calls
    (best of 3 after one warm-up); ``Stopwatch`` accumulates by name and
    ``fence`` does nothing on a CPU tensor; ``host_round_trip_latency`` is
    cached a device."""
    calls = []

    def fn(x, i):
        calls.append(i)
        return x @ x

    x = torch.randn(16, 16)
    secs = timing.device_time(fn, x, reps=4)
    assert secs > 0.0 and calls == [0] + [0, 1, 2, 3] * 3
    calls.clear()
    assert timing.device_time(fn, x, reps=2, device="cpu") > 0.0 and len(calls) == 7
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.device_time(lambda i: None, reps=1)  # no tensor, no device: the card
    lat = timing.host_round_trip_latency(device="cpu")
    assert lat >= 0.0 and timing.host_round_trip_latency(device="cpu") == lat

    sw = timing.Stopwatch()
    for _ in range(2):
        with sw("mm"):
            y = x @ x
            sw.fence([y, {"unused": 1}])
    with sw("add"):
        sw.fence({"y": y + 1})
    assert set(sw.times) == {"mm", "add"} and all(v >= 0 for v in sw.times.values())
    report = sw.report()
    assert "mm" in report and "add" in report and "%" in report
