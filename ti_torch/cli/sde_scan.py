"""Microbenchmark: SDE (Euler-Maruyama) sampling throughput, chains x dtype
x impl x chain block (port of scripts/sde_scan.py).

The SDE path (``sample_molecular_sde``; the reference has no SDE sampler,
its rollout is ODE-through-torchdiffeq only) has no dlogp, so its cost is
n_steps batched dense-pair forwards: throughput scales with the chain
batch until memory bandwidth saturates. This scan finds the card's sweet
spot over (chains, compute_dtype, impl, chain_block) at the bench config.
``dense`` is the plain dense forward; ``pair_kernel`` runs the message
layers in kernel B1 (``chain_block`` 1) or B2 (above 1), f32 in
csrc/pair_layer_tf32x3.cu and ``bf16_agg`` in csrc/pair_layer_mma.cu
(built at F = 128 and, as pair_layer_tf32x3_f256 and pair_layer_mma_f256,
at F = 256, and as pair_layer_tf32x3_f64 and pair_layer_mma_f64 at F = 64;
plain ``bf16`` has no kernel and is skipped for it).

Timing: the whole rollout, fenced by ``torch.cuda.synchronize()``, on the
host clock; best of ``--reps`` after one warm-up run. Each row carries the
launches of each kernel library in one run (``launches``,
``"kernel:library": n``). A row that runs out of device memory, or whose
kernel refuses the width (``WidthRefusal``), is printed as ``FAILED`` and
the scan goes on; any other error stops it.

Usage (defaults = the JAX package's round-2 scan):
    python -m ti_torch.cli.sde_scan
    python -m ti_torch.cli.sde_scan --chains 2048 --dtypes f32,bf16_agg \\
        --impls dense,pair_kernel --chain_blocks 1,4 --steps 20 --reps 2
Runs on the card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

_DTYPE_NAMES = ("bf16", "bf16_agg", "f32")


def data_point_errors() -> tuple:
    """The errors a scan records as a data row and passes over: running out
    of device memory, and a kernel's refusal of the width. Any other error
    propagates."""
    import torch

    from ti_torch.ops.pair_layer_kernel import WidthRefusal

    return (torch.cuda.OutOfMemoryError, WidthRefusal)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--atoms", type=int, default=19)
    p.add_argument("--features", type=int, default=128)
    p.add_argument("--layers", type=int, default=5)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--g", type=float, default=0.1)
    p.add_argument("--reps", type=int, default=3, help="best-of-N timed reps")
    p.add_argument(
        "--chains", type=str, default="512,1024,2048,4096",
        help="comma-separated chain batch sizes",
    )
    p.add_argument(
        "--dtypes", type=str, default="f32,bf16,bf16_agg",
        help=f"comma-separated subset of {sorted(_DTYPE_NAMES)}",
    )
    p.add_argument(
        "--impls", type=str, default="dense",
        help="comma-separated subset of {dense,pair_kernel}; pair_kernel "
        "(kernel B1, or B2 above chain_block 1) takes f32 and bf16_agg, so "
        "plain bf16 is skipped for it",
    )
    p.add_argument(
        "--chain_blocks", type=str, default="1",
        help="comma-separated chain blocks for pair_kernel (min(C, 3) 64-row "
        "tiles a CTA in bf16_agg, min(C, 4) at F = 64, B1's tiles in f32; dense "
        "ignores it)",
    )
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    chain_list = [int(c) for c in args.chains.split(",")]
    dtype_list = args.dtypes.split(",")
    unknown = [d for d in dtype_list if d not in _DTYPE_NAMES]
    if unknown:
        p.error(f"unknown dtypes {unknown}; choose from {sorted(_DTYPE_NAMES)}")
    impl_list = args.impls.split(",")
    unknown = [i for i in impl_list if i not in ("dense", "pair_kernel")]
    if unknown:
        p.error(f"unknown impls {unknown}; choose from ['dense', 'pair_kernel']")
    cb_list = [int(cb) for cb in args.chain_blocks.split(",")]

    import torch

    from ti_torch import resolve_device
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops import _build
    from ti_torch.sampling.drivers import sample_molecular_sde
    from ti_torch.utils.timing import synchronize

    dev = resolve_device(args.device)
    dtypes = {"f32": None, "bf16": torch.bfloat16, "bf16_agg": "bf16_agg"}
    caught = data_point_errors()
    mol = make_synthetic_molecule(n_atoms=args.atoms, seed=0)
    template = graph_template(mol, t_cond=2)
    model = CPaiNN(args.features, args.layers, n_atoms=args.atoms, temp_length=100.0,
                   conditioning="ambient", generator=torch.Generator().manual_seed(0))
    params = {k: t.detach().to(dev) for k, t in model.state_dict().items()}
    print(
        f"SDE scan: {args.atoms} atoms, F={args.features} x {args.layers}, "
        f"{args.steps} steps, g={args.g}, best-of-{args.reps}",
        file=sys.stderr,
        flush=True,
    )

    results = []
    for chains in chain_list:
        g = torch.Generator(device=dev).manual_seed(1)
        x0 = 0.1 * torch.randn(chains, args.atoms, 3, generator=g, device=dev)
        x0 = x0 - x0.mean(dim=1, keepdim=True)
        temps = torch.tensor([[1000.0, 300.0]], device=dev).repeat(chains, 1)
        for impl in impl_list:
            for cb in (cb_list if impl == "pair_kernel" else [1]):
                for dname in dtype_list:
                    if impl == "pair_kernel" and dname not in ("f32", "bf16_agg"):
                        continue
                    tag = f"{dname}/{impl}" if len(impl_list) > 1 else dname
                    if cb != 1:
                        tag += f"/cb{cb}"

                    def run(seed, impl=impl, cb=cb, cd=dtypes[dname]):
                        _build.reset_launches()
                        sample_molecular_sde(
                            model, params, template, x0, temps,
                            torch.Generator(device=dev).manual_seed(seed),
                            g_fn=args.g, n_steps=args.steps, compute_dtype=cd,
                            forward_impl=impl, chain_block=cb, device=dev,
                        )
                        synchronize(dev)

                    try:
                        t0 = time.perf_counter()
                        run(0)
                        print(f"  chains={chains} {tag}: warmup "
                              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
                        best = 0.0
                        for i in range(args.reps):
                            t0 = time.perf_counter()
                            run(i + 1)
                            best = max(best, chains / (time.perf_counter() - t0))
                    except caught as e:  # OOM at large chain counts is a data point
                        print(
                            f"chains={chains:5d} {tag:14s}: FAILED "
                            f"({type(e).__name__}: {str(e)[:120]})",
                            flush=True,
                        )
                        continue
                    results.append(
                        {"chains": chains, "dtype": dname, "impl": impl,
                         "chain_block": cb, "samples_per_s": best,
                         "launches": _build.route_counts()}
                    )
                    print(
                        f"chains={chains:5d} {tag:14s}: {best:9.1f} samples/s",
                        flush=True,
                    )

    if results:
        top = max(results, key=lambda r: r["samples_per_s"])
        print("best: " + json.dumps(top), flush=True)
    print("rows: " + json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
