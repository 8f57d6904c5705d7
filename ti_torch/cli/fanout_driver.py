"""Launch an embarrassingly parallel sampling fan-out and merge the shards
(port of scripts/fanout_driver.py).

The single-machine counterpart of the multi-host launch shape of
ti_torch/parallel/fanout.py: ``python -m ti_torch.cli.mdqm9_sample_ambient``
accepts ``--shard i --num_shards K`` and writes disjoint
``*_shard{i}of{K}*`` artifacts, so a fan-out is K processes plus one merge.
On a cluster each host runs its own shard through any scheduler; this
driver runs the same flow on one machine: K processes, one a card with
``--env CUDA_VISIBLE_DEVICES={shard}`` (``{shard}`` in an ``--env`` value
becomes the shard's index), or several on one card.

Usage:
  python -m ti_torch.cli.fanout_driver --num_shards 4 --data_dir results/00031 \
      [--max_parallel 4] [--env KEY=VAL ...] [--no_merge] [--fail_fast] [--delete] \
      -- python -m ti_torch.cli.mdqm9_sample_ambient --config cfg.json ...

The command after ``--`` is launched once per shard with
``--shard i --num_shards K`` appended. Shard stdout/stderr stream to
``<data_dir>/fanout_logs/shard_{i}.log``. Any nonzero shard exit aborts the
merge and reports per-shard status (a crashed shard is an explicit error,
never silent data loss: merge_shards re-checks completeness too);
``--fail_fast`` kills the running shards at the first failure.
"""
import argparse
import os
import subprocess
import sys
import time

from ti_torch.parallel.fanout import merge_shards


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--num_shards", type=int, required=True)
    ap.add_argument("--data_dir", required=True, help="artifact dir to merge")
    ap.add_argument(
        "--max_parallel", type=int, default=0,
        help="max concurrent shard processes (0 = all at once)",
    )
    ap.add_argument(
        "--env", action="append", default=[], metavar="KEY=VAL",
        help="extra environment for every shard (repeatable); {shard} in VAL "
        "becomes the shard's index",
    )
    ap.add_argument("--no_merge", action="store_true", help="launch only")
    ap.add_argument(
        "--fail_fast", action="store_true",
        help="on the first nonzero shard exit, stop dispatching pending "
        "shards and kill running ones instead of letting the doomed "
        "fan-out run to completion",
    )
    ap.add_argument(
        "--delete", action="store_true", help="remove shard artifacts after merge"
    )
    ap.add_argument(
        "cmd", nargs=argparse.REMAINDER,
        help="-- followed by the sampling command to shard",
    )
    args = ap.parse_args(argv)

    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("missing sharded command (after --)")
    k = args.num_shards
    if k < 1:
        ap.error("--num_shards must be >= 1")

    extra = [kv.partition("=")[::2] for kv in args.env]

    def env_of(shard):
        env = dict(os.environ)
        env.update({key: val.replace("{shard}", str(shard)) for key, val in extra})
        return env

    log_dir = os.path.join(args.data_dir, "fanout_logs")
    os.makedirs(log_dir, exist_ok=True)

    width = args.max_parallel or k
    pending = list(range(k))
    running = {}  # shard -> (Popen, log file handle)
    codes = {}
    try:
        while pending or running:
            while pending and len(running) < width:
                i = pending.pop(0)
                log_path = os.path.join(log_dir, f"shard_{i}.log")
                log = open(log_path, "w")
                shard_cmd = cmd + ["--shard", str(i), "--num_shards", str(k)]
                print(f"[fanout] shard {i}/{k}: {' '.join(shard_cmd)} > {log_path}")
                running[i] = (
                    subprocess.Popen(shard_cmd, stdout=log, stderr=subprocess.STDOUT,
                                     env=env_of(i)),
                    log,
                )
            done = [i for i, (p, _) in running.items() if p.poll() is not None]
            if not done:
                # poll rather than wait on any single child: with
                # max_parallel < num_shards a freed slot must refill as soon
                # as ANY shard exits, not a specific one
                time.sleep(0.2)
                continue
            for i in done:
                p, log = running.pop(i)
                log.close()
                codes[i] = p.returncode
                print(f"[fanout] shard {i} exited {p.returncode}")
            if args.fail_fast and any(c != 0 for c in codes.values()):
                if pending or running:
                    print(
                        f"[fanout] --fail_fast: abandoning {len(pending)} "
                        f"pending and killing {len(running)} running shards",
                        file=sys.stderr,
                    )
                pending.clear()
                for i, (p, log) in list(running.items()):
                    p.kill()
                    p.wait()
                    log.close()
                    codes[i] = p.returncode
                    running.pop(i)
    finally:
        for i, (p, log) in running.items():
            p.kill()
            log.close()

    failed = sorted(i for i, c in codes.items() if c != 0)
    if failed:
        for i in failed:
            print(f"[fanout] FAILED shard {i}: see {log_dir}/shard_{i}.log", file=sys.stderr)
        return 1
    if args.no_merge:
        return 0
    merged = merge_shards(args.data_dir, k, delete=args.delete)
    for out, parts in merged.items():
        print(f"[fanout] merged {out} <- {len(parts)} shards")
    return 0


if __name__ == "__main__":
    sys.exit(main())
