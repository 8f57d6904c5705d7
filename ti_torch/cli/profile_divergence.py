"""Microbenchmark: where does the divergence-node time go on the card?
(port of scripts/profile_divergence.py)

Times, for the dense-pair cPaiNN at the bench config (19 atoms, F=128 x 5,
a random-init field from seed 0):
  1. the primal forward (batched over chains), unfused vs fused
     (``apply_dense(fused=True)``: the message MLPs in kernel B4); beside
     them the fully fused forward (``fused_velocity_fn``: B4 and the
     combine, update and readout MLPs in kernel B6);
  2. one exact-divergence node (forward-mode JVPs against the identity
     basis): in lane chunks of 16, unchunked, in bf16 and bf16_agg, and
     through ``impl="dense_fused"`` (B4 for the primal, B5 for the
     tangents); the Hutchinson node at K = 16 and 32, rademacher against
     the orthogonal frame; the hand-propagated tangent ``dense_divergence``
     unchunked and at 19 lanes a chunk;
  3. the implied full-bench cost (the JAX script's formula: 400 forwards
     and 10 nodes a sample).

Timing: ``ti_torch.utils.timing.device_time`` (CUDA events around ``reps``
calls, best of 3, after a warm-up call; the host clock on the CPU), which
replaces the JAX script's device-side ``lax.scan`` and its one host read;
``host_round_trip_latency`` is printed beside it. On the card the fused
rows run through their kernels; on the CPU through their plain versions.
The last line, ``rows: {...}``, holds each row's ms and the launches of
each kernel library in one call.

Usage: python -m ti_torch.cli.profile_divergence [chains] [--device cpu]
Runs on the card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("chains", type=int, nargs="?", default=64)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch
    from torch.func import vmap

    from ti_torch import resolve_device
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.models.cpainn_dense import apply_dense, pack_message_layers
    from ti_torch.models.cpainn_fused import fused_velocity_fn
    from ti_torch.ops import _build
    from ti_torch.ops.dense_divergence import dense_divergence
    from ti_torch.ops.divergence import divergence_exact, divergence_hutchinson
    from ti_torch.sampling.drivers import molecular_v_fn_of
    from ti_torch.utils.timing import device_time, host_round_trip_latency, synchronize

    dev = resolve_device(args.device)
    n_atoms, chains = 19, args.chains
    mol = make_synthetic_molecule(n_atoms=n_atoms, seed=0)
    template = graph_template(mol, t_cond=2)
    model = CPaiNN(128, 5, n_atoms=n_atoms, temp_length=100.0, conditioning="ambient",
                   generator=torch.Generator().manual_seed(0))
    params = {k: t.detach().to(dev) for k, t in model.state_dict().items()}
    g = torch.Generator(device=dev).manual_seed(1)
    x = 0.1 * torch.randn(chains, n_atoms, 3, generator=g, device=dev)
    temps = torch.tensor([[1000.0, 300.0]], device=dev).repeat(chains, 1)
    t = torch.full((chains,), 0.5, device=dev)
    atom_ids = torch.as_tensor(template.atom_ids, device=dev)

    print(f"round-trip latency: {host_round_trip_latency(device=dev)*1e3:.1f} ms")

    ms, launches = {}, {}

    def timed(label, fn, reps):
        """Seconds a call of fn(x, i); one call's launches by library."""
        _build.reset_launches()
        with torch.no_grad():
            fn(x, 0)
        synchronize(dev)
        launches[label] = _build.route_counts()
        with torch.no_grad():
            secs = device_time(fn, x, reps=reps)
        ms[label] = secs * 1e3
        return secs

    packed = pack_message_layers(model, params, dev)

    def fwd(fused):
        def f(xx, i):
            return apply_dense(model, params, xx + 1e-3 * i, t, temps, atom_ids,
                               template.edges, fused=fused, packed=packed)
        return f

    t_fwd = timed("primal fwd", fwd(False), 32)
    print(f"primal fwd    batch={chains}: {t_fwd*1e3:8.2f} ms  ({t_fwd/chains*1e6:7.1f} us/chain)")
    t_fwd_fused = timed("primal fused", fwd(True), 16)
    print(f"primal fused  batch={chains}: {t_fwd_fused*1e3:8.2f} ms  ({t_fwd/t_fwd_fused:.2f}x vs unfused)")
    drift = fused_velocity_fn(model, params, template, device=dev)
    t_fwd_mlp = timed("primal fused+mlp", lambda xx, i: drift(xx + 1e-3 * i, 0.5, temps), 16)
    print(f"primal fused+mlp batch={chains}: {t_fwd_mlp*1e3:8.2f} ms  ({t_fwd/t_fwd_mlp:.2f}x vs unfused; B4 and B6)")

    def div(impl, chunk, compute_dtype=None):
        v = molecular_v_fn_of(model, params, template, impl=impl, compute_dtype=compute_dtype,
                              device=dev)(temps)

        def f(xx, i):
            return divergence_exact(lambda y: v(y, 0.5), xx + 1e-3 * i, chunk=chunk)[1]

        return f

    t_div = timed("div chunk16", div("dense", 16), 4)
    print(f"div chunk16   batch={chains}: {t_div*1e3:8.2f} ms  (= {t_div/t_fwd:6.1f}x primal)")
    t_div_nc = timed("div nochunk", div("dense", None), 4)
    print(f"div nochunk   batch={chains}: {t_div_nc*1e3:8.2f} ms")
    t_div_bf = timed("div bf16", div("dense", None, torch.bfloat16), 4)
    print(f"div bf16      batch={chains}: {t_div_bf*1e3:8.2f} ms  ({t_div_nc/t_div_bf:.2f}x vs f32; headline path)")
    t_div_agg = timed("div bf16agg", div("dense", None, "bf16_agg"), 4)
    print(f"div bf16agg   batch={chains}: {t_div_agg*1e3:8.2f} ms  ({t_div_bf/t_div_agg:.2f}x vs bf16; bf16 dot outputs)")
    t_div_f = timed("div fused", div("dense_fused", None), 4)
    print(f"div fused     batch={chains}: {t_div_f*1e3:8.2f} ms  ({t_div_nc/t_div_f:.2f}x vs nochunk)")

    # stochastic nodes at the qualified probe counts: rademacher vs the
    # orthogonal Haar frame (same lane count + one (d, K) QR a chain)
    def div_hutch(k, mode):
        v = molecular_v_fn_of(model, params, template, impl="dense", device=dev)(temps)
        gen = torch.Generator(device=dev).manual_seed(1)

        def f(xx, i):
            return divergence_hutchinson(lambda y: v(y, 0.5), xx + 1e-3 * i, gen,
                                         num_probes=k, probe_mode=mode)[1]

        return f

    for k in (16, 32):
        t_r = timed(f"div hutch-{k} rademacher", div_hutch(k, "rademacher"), 4)
        t_o = timed(f"div hutch-{k} orthogonal", div_hutch(k, "orthogonal"), 4)
        print(f"div hutch-{k:2d}  batch={chains}: rademacher {t_r*1e3:8.2f} ms | "
              f"orthogonal {t_o*1e3:8.2f} ms ({t_r/max(t_o,1e-9):.2f}x)")

    def div_hand(chunk):
        def one(xc, tempc, i):
            return dense_divergence(model, params, xc + 1e-3 * i, torch.tensor(0.5, device=dev),
                                    tempc, template.atom_ids, template.edges,
                                    lane_chunk=chunk)[1]

        def f(xx, i):
            return vmap(lambda xc, tc: one(xc, tc, i))(xx, temps)

        return f

    t_div_h = timed("div hand-jvp", div_hand(None), 4)
    print(f"div hand-jvp  batch={chains}: {t_div_h*1e3:8.2f} ms  ({t_div_nc/t_div_h:.2f}x vs nochunk)")
    t_div_h8 = timed("div hand c19", div_hand(19), 4)
    print(f"div hand c19  batch={chains}: {t_div_h8*1e3:8.2f} ms")

    best_div = min(t_div, t_div_nc, t_div_f, t_div_h, t_div_h8)
    best_fwd = min(t_fwd, t_fwd_fused)
    full_cost = 400 * best_fwd / chains + 10 * best_div / chains  # GL-10 nodes
    print(
        f"\nimplied full-bench cost/sample (best paths): {full_cost*1e3:.1f} ms "
        f"-> {1/full_cost:.2f} samples/s/chip "
        f"(traj {400*best_fwd/chains*1e3:.1f} ms, dlogp {10*best_div/chains*1e3:.1f} ms)"
    )
    print("rows: " + json.dumps({"chains": chains, "device": str(dev), "ms": ms,
                                 "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
