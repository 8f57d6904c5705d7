"""Peak memory and time of the latent family's divergence nodes on one card.

The published latent profile (``fast_profile(latent_preset("00031",
Ts=[300]), family="latent")``: bf16, the dense forward, the exact
divergence as 57 forward-mode lanes at once) evaluates every Gauss node
over the whole chain batch. This script measures one such node, and one
trajectory forward, at a few chain counts (peak memory after a reset,
CUDA-event time after a warm-up) and fits the peak as a line in the chain
count, which gives the largest batch that fits in the card's memory. It
also times one exact f32 node at 128 chains on the routes the quadrature
samplers can take: the dense forward in blocks of 19 lanes, and
``impl="dense_fused"`` (kernels B4, B5).

    python3 tools/latent_memory_probe.py [--chains 16,32,64] [--out chiprun_out/latent_probe.json]

Random weights from seed 0 with PyTorch's default laws (chip_smoke.py's
field), 19 atoms, F = 128, 5 layers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import card_line, torch_default_weights_  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chains", default="16,32,64")
    ap.add_argument("--budget_gib", type=float, default=76.0)
    ap.add_argument("--out", default="chiprun_out/latent_probe.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("latent_memory_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from ti_torch.config import fast_profile, latent_preset
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.ops.divergence import value_and_divergence
    from ti_torch.sampling.drivers import _compute_dtype, molecular_v_fn_of
    from ti_torch.train.latent import build_latent_model

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    cfg = fast_profile(latent_preset("00031", Ts=[300]), family="latent")
    n = 19
    model = torch_default_weights_(build_latent_model(cfg, n))
    template = graph_template(make_synthetic_molecule(n, seed=0), t_cond=0)
    result = {"card": card, "profile": {k: getattr(cfg, k) for k in (
        "compute_dtype", "divergence", "dlogp_quad_points", "n_steps", "batch_size")}}

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    v_of = molecular_v_fn_of(model, None, template, compute_dtype=_compute_dtype(cfg),
                             device="cuda")
    rows = []
    for b in [int(c) for c in args.chains.split(",")]:
        x = 0.5 * torch.randn(b, n, 3, device="cuda")
        x = x - x.mean(dim=1, keepdim=True)
        v = v_of(torch.zeros(b, 0, device="cuda"))
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            node_ms = timed(lambda: value_and_divergence(lambda y: v(y, 0.5), x, mode="exact"))
            peak = torch.cuda.max_memory_allocated() - base
            fwd_ms = timed(lambda: v(x, 0.5), reps=10)
        rows.append({"chains": b, "node_ms": node_ms, "node_peak_gib": peak / 2 ** 30,
                     "forward_ms": fwd_ms})
        print(f"[published latent node] {b} chains: one exact node (57 lanes at once, bf16) "
              f"{node_ms:.1f} ms, peak {peak / 2 ** 30:.2f} GiB above the inputs; one "
              f"trajectory forward {fwd_ms:.2f} ms ({card})", flush=True)
    cs = np.array([r["chains"] for r in rows], float)
    ps = np.array([r["node_peak_gib"] for r in rows])
    slope, icpt = np.polyfit(cs, ps, 1)
    fits = int(max(0.0, (args.budget_gib - icpt) / slope))
    result.update(rows=rows, gib_per_chain=float(slope), gib_fixed=float(icpt),
                  peak_at_256_gib=float(icpt + 256 * slope), largest_batch=fits,
                  budget_gib=args.budget_gib)
    print(f"[published latent node] peak = {icpt:.3f} + {slope:.4f} x chains GiB: "
          f"{icpt + 256 * slope:.1f} GiB at 256 chains; the largest batch within "
          f"{args.budget_gib} GiB is {fits}", flush=True)

    # one exact f32 node at 128 chains on the quadrature samplers' routes
    b = 128
    x = 0.5 * torch.randn(b, n, 3, device="cuda")
    x = x - x.mean(dim=1, keepdim=True)
    for impl, chunk in (("dense", 19), ("dense_fused", None)):
        v = molecular_v_fn_of(model, None, template, impl=impl, device="cuda")(
            torch.zeros(b, 0, device="cuda"))
        with torch.no_grad():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ms = timed(lambda: value_and_divergence(lambda y: v(y, 0.5), x, mode="exact",
                                                    chunk=chunk))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        result[f"f32_node_{impl}"] = {"chains": b, "chunk": chunk, "ms": ms, "peak_gib": peak,
                                      "seconds_with_warmup": time.perf_counter() - t0}
        print(f"[f32 exact node {impl}] {b} chains, chunk {chunk}: {ms:.1f} ms, peak "
              f"{peak:.2f} GiB ({card})", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
