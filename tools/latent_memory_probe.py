"""Peak memory and time of the latent family's exact divergence nodes on one card.

The published latent profiles (``fast_profile(latent_preset(mol,
Ts=[300]), family="latent")``: bf16, the dense forward, the exact
divergence as d = 3N forward-mode lanes) evaluate every Gauss node over the
whole chain batch, in the lane blocks ``exact_lane_block`` sizes from the
batch, the shape and the card's total memory (``ti_torch/ops/divergence.py``).
For each molecule asked for, this script measures one node at a grid of
(chains, lanes at once) (peak memory above the inputs after a reset,
CUDA-event time after a warm-up) beside the memory model's peak
(``exact_node_bytes``), fits the model's two constants to every row of the
run by least squares, then times the node the rule blocks at ``--chains``
chains. ``--batch`` also runs one whole published-profile batch of
``--chains`` chains through ``sample_latent``: its seconds, samples/s and
peak memory. With 00031 it also times one exact f32 node at 128 chains on
the routes the quadrature samplers can take (the dense forward in blocks of
19 lanes, ``impl="dense_fused"``: kernels B4, B5).

    python3 tools/latent_memory_probe.py [--mol 00031,10506] [--chains 256] [--batch]
        [--grid 00031=16x57,32x57 ...] [--out chiprun_out/latent_probe.json]

A grid row is CHAINSxLANES, optionally with :f32 (the compute dtype, bf16
otherwise) and :L (layers, 5 otherwise). Random weights from seed 0 with
PyTorch's default laws (chip_smoke.py's field): 00031 is 19 atoms at F =
128, 10506 29 atoms at F = 256, 5 layers each.
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

ATOMS = {"00031": 19, "10506": 29}
GRID = {
    # bf16 at 5 layers, lanes at once and in blocks; an f32 row and a 2-layer
    # row at 00031 hold the model's element size and its layer count
    "00031": "16x57,32x57,64x57,64x19,128x10,32x57:f32,32x19:f32,32x57:2",
    "10506": "4x87,8x87,16x87,32x29,64x9",
}


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


def parse_row(spec: str):
    head, *opts = spec.split(":")
    b, k = (int(v) for v in head.split("x"))
    dtype, layers = "bf16", 5
    for o in opts:
        if o == "f32":
            dtype = "f32"
        else:
            layers = int(o)
    return b, k, dtype, layers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mol", default="00031")
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--grid", nargs="*", default=[], help="MOL=CHAINSxLANES[:f32][:L],...")
    ap.add_argument("--batch", action="store_true")
    ap.add_argument("--out", default="chiprun_out/latent_probe.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("latent_memory_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from ti_torch.config import fast_profile, latent_preset
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.ops import divergence as dv
    from ti_torch.sampling.drivers import molecular_v_fn_of, sample_latent
    from ti_torch.train.latent import build_latent_model

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    total = torch.cuda.get_device_properties(0).total_memory
    budget = dv.exact_lane_budget("cuda")
    grid = dict(GRID, **dict(g.split("=", 1) for g in args.grid))
    result = {"card": card, "total_memory": total, "budget_bytes": budget,
              "share": dv.EXACT_LANE_SHARE,
              "model_units": [dv.NODE_CHAIN_UNITS, dv.NODE_LANE_UNITS], "mols": {}}
    print(f"[probe] {card}: total memory {total} bytes ({total / 2 ** 30:.3f} GiB), node "
          f"budget {budget} bytes ({dv.EXACT_LANE_SHARE} of it)", flush=True)
    fit_rows = []
    for mol in args.mol.split(","):
        n = ATOMS[mol]
        cfg = fast_profile(latent_preset(mol, Ts=[300]), family="latent")
        f = cfg.n_features
        template = graph_template(make_synthetic_molecule(n, seed=0), t_cond=0)
        models = {}

        def model_of(layers):
            if layers not in models:
                models[layers] = torch_default_weights_(
                    build_latent_model(latent_preset(mol, Ts=[300], score_layers=layers), n))
            return models[layers]

        def node_fn(b, dtype, layers):
            v = molecular_v_fn_of(model_of(layers), None, template, device="cuda",
                                  compute_dtype=torch.bfloat16 if dtype == "bf16" else None)
            return v(torch.zeros(b, 0, device="cuda"))

        def inputs(b):
            x = 0.5 * torch.randn(b, n, 3, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(b))
            return x - x.mean(dim=1, keepdim=True)

        def measure(b, k, dtype="bf16", layers=5, reps=3):
            v, x = node_fn(b, dtype, layers), inputs(b)
            with torch.no_grad():
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                ms = timed(lambda: dv.divergence_exact(lambda y: v(y, 0.5), x, chunk=k),
                           reps=reps)
                peak = torch.cuda.max_memory_allocated() - base
            return ms, peak

        rows = []
        for spec in grid[mol].split(","):
            b, k, dtype, layers = parse_row(spec)
            ms, peak = measure(b, k, dtype, layers)
            model = dv.exact_node_bytes(b, k, n, f, dtype)
            unit = b * n * n * f * dv._itemsize(dtype)
            rows.append({"chains": b, "lanes": k, "dtype": dtype, "layers": layers,
                         "node_ms": ms, "peak_bytes": peak, "peak_gib": peak / 2 ** 30,
                         "model_gib": model / 2 ** 30, "model_err": peak / model - 1.0})
            if (dtype, layers) == ("bf16", 5):
                fit_rows.append((unit, unit * k, peak))
            print(f"[{mol} exact node] {b} chains x {k} lanes at once ({dtype}, {layers} "
                  f"layers): {ms:.1f} ms, peak {peak / 2 ** 30:.3f} GiB above the inputs, "
                  f"model {model / 2 ** 30:.3f} GiB ({peak / model - 1.0:+.3%}) ({card})",
                  flush=True)
        b = args.chains
        block = dv.exact_lane_block(b, n, f, cfg.score_layers, cfg.compute_dtype, budget)
        ms, peak = measure(b, block, reps=1)
        model = dv.exact_node_bytes(b, block or 3 * n, n, f, cfg.compute_dtype)
        blocked = {"chains": b, "block": block, "blocks": -(-3 * n // (block or 3 * n)),
                   "node_ms": ms, "peak_gib": peak / 2 ** 30, "model_gib": model / 2 ** 30}
        print(f"[{mol} blocked node] {b} chains, lane block {block} of {3 * n} "
              f"({blocked['blocks']} blocks): {ms:.1f} ms, peak {peak / 2 ** 30:.3f} GiB, model "
              f"{model / 2 ** 30:.3f} GiB ({card})", flush=True)
        out = {"atoms": n, "features": f, "gl_points": cfg.dlogp_quad_points, "rows": rows,
               "blocked_node": blocked}
        if args.batch:
            z = inputs(b).cpu().numpy()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = sample_latent(cfg, model_of(5), None, template, noise=z, save=False, batch_size=b,
                                device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            ok = bool(np.isfinite(res["samples"]).all() and np.isfinite(res["dlogps"]).all())
            out["batch"] = {"chains": b, "seconds": secs, "samples_per_s": b / secs,
                            "peak_gib": peak, "finite": ok, "nfe": res["nfe"],
                            "dlogp_mean": float(res["dlogps"].mean())}
            print(f"[{mol} published batch] {b} chains through sample_latent (bf16, GL-"
                  f"{cfg.dlogp_quad_points}, lane block {block}) in {secs:.3f} s, "
                  f"{b / secs:.3f} samples/s, peak allocated {peak:.2f} GiB, finite {ok} (host "
                  f"clock, "
                  f"{card})", flush=True)
        if mol == "00031":  # one exact f32 node at 128 chains on the quadrature routes
            x = inputs(128)
            for impl, chunk in (("dense", 19), ("dense_fused", None)):
                v = molecular_v_fn_of(model_of(5), None, template, impl=impl, device="cuda")(
                    torch.zeros(128, 0, device="cuda"))
                with torch.no_grad():
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    ms = timed(lambda: dv.divergence_exact(lambda y: v(y, 0.5), x, chunk=chunk))
                    peak = torch.cuda.max_memory_allocated() / 2 ** 30
                out[f"f32_node_{impl}"] = {"chains": 128, "chunk": chunk, "ms": ms,
                                           "peak_gib": peak}
                print(f"[f32 exact node {impl}] 128 chains, chunk {chunk}: {ms:.1f} ms, peak "
                      f"{peak:.2f} GiB ({card})", flush=True)
        result["mols"][mol] = out
    if len(fit_rows) >= 2:  # peak = chain_units·unit + lane_units·unit·lanes, relative error
        a = np.array([[u / pk, ul / pk] for u, ul, pk in fit_rows], float)
        (cu, lu), *_ = np.linalg.lstsq(a, np.ones(len(fit_rows)), rcond=None)
        result["fit_units"] = [float(cu), float(lu)]
        print(f"[probe] least-squares fit of the relative error over {len(fit_rows)} bf16 "
              f"5-layer rows: "
              f"NODE_CHAIN_UNITS {cu:.3f}, NODE_LANE_UNITS {lu:.3f} "
              f"(the module's: {dv.NODE_CHAIN_UNITS}, {dv.NODE_LANE_UNITS})", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
