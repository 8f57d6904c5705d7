"""Microbenchmark: 10506-scale ODE+dlogp throughput over chains x probes x
trajectory impl x divergence-node impl (port of scripts/large_scale_scan.py).

The large-molecule regime (29 atoms, cPaiNN F=256 x 5 — the capacity of
the reference's 10506 configs, mdqm9/config/ambient/10506_settings_no_300
.json) is where the reference's 3N-backward-pass divergence hurts most
(mdqm9/thermo/ambient/models/ode_wrapper.py:60-91). This scan measures the
10506 fast profile (RK4-16 trajectory + Gauss-Legendre-8 decoupled
Hutchinson dlogp, bf16_agg) through ``make_ode_sampler`` across:

  - chain batch (16 was the JAX package's unchunked sweet spot),
  - Hutchinson probe count (the physics-qualified count is 32),
  - trajectory impl (``traj_drift``): ``default`` (the dense forward),
    ``pair_kernel`` (kernel B1 in f32, csrc/pair_layer_tf32x3.cu; at F = 256
    the library pair_layer_tf32x3_f256) or ``pair_kernel_bf16`` (B1 in
    bf16_agg, csrc/pair_layer_mma.cu; at F = 256 the library
    pair_layer_mma_f256),
  - divergence-node impl (``div_drift``): ``default`` (forward-mode JVPs of
    the dense forward), ``pair_tangent`` / ``pair_tangent_bf16`` (kernel B3
    in f32 / bf16_agg, ``pair_tangent_div_fn``; at F = 256 the libraries
    pair_tangent_tf32x3_f256 / pair_tangent_mma_f256).

At F = 256, at F = 128 (``--atoms 19 --features 128``) and at F = 64 (the
``_f64`` builds of the same sources) every impl runs its kernel; at another
width a kernel row reports the width refusal (``WidthRefusal``, naming the
widths that run and their routes) as an ``error`` row
and the scan goes on, never running the plain version in its place. On the
CPU every wrapper takes its plain version.

Timing: the whole rollout fenced by ``torch.cuda.synchronize()`` on the
host clock, best of ``--reps`` after one warm-up run. Each row carries the
launches of each kernel library in one run (``launches``). Throughput
only: the matching physics (dF err / ESS) comes from the 10506 oracle
(tools/torch_ambient_oracle.py --atoms 29 --features 256).

Usage:
    python -m ti_torch.cli.large_scale_scan                      # full grid
    python -m ti_torch.cli.large_scale_scan --chains 16 --probes 32 \\
        --impls default,pair_kernel_bf16
Runs on the card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--atoms", type=int, default=29)
    p.add_argument("--features", type=int, default=256)
    p.add_argument("--layers", type=int, default=5)
    p.add_argument("--steps", type=int, default=16, help="RK4 trajectory steps")
    p.add_argument("--gl_points", type=int, default=8)
    p.add_argument("--probe_mode", default="rademacher",
                   help="rademacher is the qualified 10506 mode "
                        "(orthogonal measured no-benefit at d=87)")
    p.add_argument("--compute_dtype", choices=["f32", "bf16", "bf16_agg"],
                   default="bf16_agg")
    p.add_argument("--steps_per_dispatch", type=int, default=25)
    p.add_argument("--reps", type=int, default=2, help="best-of-N timed reps")
    p.add_argument("--chains", default="16,24,32",
                   help="comma-separated chain batch sizes")
    p.add_argument("--probes", default="24,32,48",
                   help="comma-separated Hutchinson probe counts")
    p.add_argument("--impls", default="default,pair_kernel_bf16",
                   help="comma subset of {default,pair_kernel,pair_kernel_bf16}")
    p.add_argument("--div_impls", default="default",
                   help="comma subset of {default,pair_tangent,"
                        "pair_tangent_bf16}: divergence-node estimator impl "
                        "(kernel B3, ops/pair_tangent_kernel.py); crossed with --impls")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    impls = [s for s in args.impls.split(",") if s]
    known = {"default", "pair_kernel", "pair_kernel_bf16"}
    unknown = [i for i in impls if i not in known]
    if unknown:
        p.error(f"unknown impls {unknown}; choose from {sorted(known)}")
    div_impls = [s for s in args.div_impls.split(",") if s]
    known_d = {"default", "pair_tangent", "pair_tangent_bf16"}
    unknown = [i for i in div_impls if i not in known_d]
    if unknown:
        p.error(f"unknown div_impls {unknown}; choose from {sorted(known_d)}")

    import torch

    from ti_torch import resolve_device
    from ti_torch.cli.sde_scan import data_point_errors
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops import _build
    from ti_torch.ops.pair_layer_kernel import pair_kernel_drift
    from ti_torch.ops.pair_tangent_kernel import pair_tangent_div_fn
    from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of
    from ti_torch.utils.timing import synchronize

    dev = resolve_device(args.device)
    caught = data_point_errors()
    mol = make_synthetic_molecule(n_atoms=args.atoms, seed=0)
    template = graph_template(mol, t_cond=2)
    model = CPaiNN(args.features, args.layers, n_atoms=args.atoms, temp_length=100.0,
                   conditioning="ambient", generator=torch.Generator().manual_seed(0))
    params = {k: t.detach().to(dev) for k, t in model.state_dict().items()}
    # the repo's dtype convention (sde_scan, drivers._compute_dtype)
    cd = {"f32": None, "bf16": torch.bfloat16, "bf16_agg": "bf16_agg"}[args.compute_dtype]
    v_fn_of = molecular_v_fn_of(model, params, template, compute_dtype=cd, device=dev)

    drifts = {"default": None}
    if "pair_kernel" in impls:
        drifts["pair_kernel"] = pair_kernel_drift(model, params, template, device=dev)
    if "pair_kernel_bf16" in impls:
        drifts["pair_kernel_bf16"] = pair_kernel_drift(
            model, params, template, compute_dtype="bf16_agg", device=dev)

    chain_list = [int(c) for c in args.chains.split(",")]
    probe_list = [int(k) for k in args.probes.split(",")]

    def div_drift_for(dimpl, probes):
        if dimpl == "default":
            return None
        return pair_tangent_div_fn(
            model, params, template, num_probes=probes, probe_mode=args.probe_mode,
            compute_dtype="bf16_agg" if dimpl.endswith("bf16") else None, device=dev,
        )

    for impl in impls:
        for dimpl in div_impls:
            for probes in probe_list:
                sampler = make_ode_sampler(
                    v_fn_of, solver="rk4", n_steps=args.steps, n_save=2,
                    return_dlogp=True, divergence="hutchinson",
                    num_probes=probes, probe_mode=args.probe_mode,
                    dlogp_quad_points=args.gl_points, dlogp_quad="gauss",
                    steps_per_dispatch=args.steps_per_dispatch,
                    traj_drift=drifts[impl],
                    div_drift=div_drift_for(dimpl, probes), device=dev,
                )
                for chains in chain_list:
                    g = torch.Generator(device=dev).manual_seed(42)
                    x0 = 0.1 * torch.randn(chains, args.atoms, 3, generator=g, device=dev)
                    x0 = x0 - x0.mean(dim=1, keepdim=True)
                    tl = torch.tensor([[1000.0, 300.0]], device=dev).repeat(chains, 1)

                    def run(seed):
                        _build.reset_launches()
                        with torch.no_grad():
                            sampler(x0, tl, torch.Generator(device=dev).manual_seed(seed))
                        synchronize(dev)

                    try:
                        run(0)  # warm: builds the kernels at first use
                        best = 0.0
                        for i in range(args.reps):
                            t0 = time.perf_counter()
                            run(i + 1)
                            best = max(best, chains / (time.perf_counter() - t0))
                    except caught as e:
                        print(json.dumps({"impl": impl, "div_impl": dimpl,
                                          "probes": probes, "chains": chains,
                                          "error": f"{type(e).__name__}: {e}"[:200]}))
                        continue
                    print(json.dumps({
                        "impl": impl, "div_impl": dimpl, "probes": probes,
                        "chains": chains, "samples_per_sec": round(best, 3),
                        "launches": _build.route_counts(),
                    }))
                    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
