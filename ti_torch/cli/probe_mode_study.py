"""Microbenchmark/study: Hutchinson probe distributions on the velocity
field (port of scripts/probe_mode_study.py).

Compares the stochastic-divergence estimators per probe budget at states
along a short transport trajectory of the bench-scale cPaiNN field:

  - rademacher  : iid +-1 probes (the classic Hutchinson draw; production)
  - orthogonal  : Haar-orthonormal probe frame scaled by d/K — unbiased for
                  any J, EXACT at K = dim (ops/divergence.py::_probe_block)

For each (mode, K) it reports the per-node estimator rms error and bias
against the exact trace over ``--keys`` independent draws (the trace of
the d identity-basis JVPs, ``divergence_exact``, is the ground truth at
every node). The draws of node i come from a ``torch.Generator`` seeded
``1000 * seed + i`` (``draw_probes``), one probe block a key, all keys of
a node at once.

The field: a random-init cPaiNN (flax's laws, seed 0; ratios indicative),
or ``--params``, a port checkpoint (``.npz``, ``save_npz``) whose ``arch``
(atoms, features, layers, temp_length) is honoured over the flags, or
``--oracle``: train the CPU-sized harmonic-well oracle with
``train_ambient`` and compare end-to-end TFEP dF error and Kish ESS per
(probe_mode, K) on RK4-16 with Gauss-Legendre-8 Hutchinson dlogp.

Usage:
    python -m ti_torch.cli.probe_mode_study --keys 32 --probes 8,16,32
    python -m ti_torch.cli.probe_mode_study --params oracle.npz
    python -m ti_torch.cli.probe_mode_study --oracle --atoms 6 --features 32 --layers 2
Runs on the card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

ORACLE_DIR = os.path.join(tempfile.gettempdir(), "probe_mode_oracle")


def _oracle_study(args, dev):
    """End-to-end ESS/dF comparison on a trained harmonic-well oracle:
    train the transport field, then sample with GL-quadrature Hutchinson
    dlogp per (probe_mode, K) and report the TFEP dF error against the
    closed form and the Kish ESS."""
    import torch

    from ti_torch.analysis import oracles
    from ti_torch.analysis.free_energy import calc_phis_tfep, calc_tfep_dF
    from ti_torch.analysis.weights import calc_ess
    from ti_torch.config import MDQM9Config
    from ti_torch.data.mdqm9 import (
        MDQM9AmbientDataset,
        make_synthetic_frames,
        make_synthetic_molecule,
    )
    from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of
    from ti_torch.train import common as train_common
    from ti_torch.train.ambient import build_ambient_model, train_ambient

    T0, T1, jitter = 1000, 300, 0.4

    def sig(T):
        return oracles.well_sigma(T, jitter)

    n = args.atoms
    d = 3 * n
    mol = make_synthetic_molecule(n_atoms=n, seed=0)
    p_eq = (mol.positions - mol.positions.mean(axis=0, keepdims=True)).astype(np.float32)

    def energy(x, T):
        return oracles.well_energy(x, sig(T), p_eq)

    frames = {T: make_synthetic_frames(mol, 1024, T, seed=T, jitter=jitter) for T in (T0, T1)}
    stack = np.concatenate([frames[T0], frames[T1]])
    temps = np.concatenate([np.full(1024, float(T0)), np.full(1024, float(T1))])
    cfg = MDQM9Config(
        n_features=args.features, score_layers=args.layers, batch_size=64,
        n_epochs=args.train_epochs, learning_rate=2e-3, gamma="brownian",
        a=0.1, temp_length=8.0, scale_trajs=False, T0s=[T0, T1], T1s=[T0, T1],
        model_save_path=os.path.join(ORACLE_DIR, "models"),
        data_save_path=os.path.join(ORACLE_DIR, "out"),
    )
    # --reuse: the oracle is deterministic in (atoms, features, layers,
    # epochs), so the trained params are cached under those
    dataset = MDQM9AmbientDataset.from_arrays(stack, temps, mol)
    ckpt = os.path.join(ORACLE_DIR, f"ckpt_a{n}_f{args.features}_l{args.layers}"
                                    f"_e{args.train_epochs}.npz")
    if args.reuse and os.path.exists(ckpt):
        print(f"reusing the trained oracle at {ckpt}", file=sys.stderr, flush=True)
        model = build_ambient_model(cfg, n)
        res = {"model": model, "params": train_common.load_checkpoint(ckpt),
               "template": dataset.template}
    else:
        print(f"training the harmonic oracle: {n} atoms (d={d}), "
              f"F={args.features} x {args.layers}, {args.train_epochs} epochs",
              file=sys.stderr, flush=True)
        res = train_ambient(cfg, dataset, dataset, device=dev)
        if args.reuse:
            os.makedirs(ORACLE_DIR, exist_ok=True)
            train_common.save_checkpoint(ckpt, res["params"])
    v_of = molecular_v_fn_of(res["model"], res["params"], res["template"], device=dev)

    n_chains = args.chains
    x0 = make_synthetic_frames(mol, n_chains, T0, seed=999, jitter=jitter)
    tt = np.tile(np.array([float(T0), float(T1)], np.float32), (n_chains, 1))
    dF_exact = oracles.tfep_dF_exact(n, sig(T0), sig(T1))

    def run(divergence, k=None, mode="rademacher", crn=False):
        sampler = make_ode_sampler(
            v_of, solver="rk4", n_steps=16, n_save=2, return_dlogp=True,
            divergence=divergence, num_probes=k or 8, probe_mode=mode,
            probe_crn=crn, dlogp_quad_points=8, dlogp_quad="gauss", device=dev,
        )
        with torch.no_grad():
            sol = sampler(x0, tt, torch.Generator(device=dev).manual_seed(args.seed))
        x1 = sol.xs[:, -1].cpu().numpy()
        dlogp = sol.dlogp[:, -1].cpu().numpy()
        phis, _ = calc_phis_tfep(energy(x0, T0), energy(x1, T1), dlogp)
        log_w = -phis
        w = np.exp(log_w - log_w.max())
        return (float(abs(calc_tfep_dF(phis) - dF_exact)),
                100.0 * float(calc_ess(w)) / n_chains,
                float(np.std(dlogp)))

    err, ess, _ = run("exact")
    print(f"exact       : dF err {err:7.4f}  ESS {ess:5.1f}%  (dF_exact={dF_exact:.3f})",
          flush=True)
    rows = [{"mode": "exact", "K": d, "dF_err": err, "ess_pct": ess}]
    for k in [int(s) for s in args.probes.split(",")]:
        for mode in ("rademacher", "orthogonal"):
            if mode == "orthogonal" and k > d:
                continue
            for crn in ((False, True) if args.crn else (False,)):
                err, ess, sd = run("hutchinson", k, mode, crn)
                tag = f"{mode}{'+crn' if crn else ''}"
                rows.append({"mode": tag, "K": k, "dF_err": err, "ess_pct": ess})
                print(f"{tag:15s} K={k:3d}: dF err {err:7.4f}  ESS {ess:5.1f}%  "
                      f"dlogp std {sd:6.3f}", flush=True)
    print("rows: " + json.dumps(rows), flush=True)
    return rows


def build_field(args, dev):
    """(model, params, template, label) of the study: ``--params``' weights
    under their recorded arch (which updates ``args``), or a random-init
    cPaiNN (flax's laws from seed 0)."""
    import torch

    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.convert import load_npz_arch
    from ti_torch.models.cpainn import CPaiNN

    temp_length = 100.0
    params = None
    if args.params:
        params, arch = load_npz_arch(args.params)
        if arch is not None:
            atoms, features = int(arch["atoms"]), int(arch["features"])
            layers, temp_length = int(arch["layers"]), float(arch["temp_length"])
            if (atoms, features, layers) != (args.atoms, args.features, args.layers):
                print(f"[probe_mode_study] using the checkpoint's arch "
                      f"(atoms={atoms}, F={features}, layers={layers}, "
                      f"temp_length={temp_length:g}) over the CLI flags",
                      file=sys.stderr, flush=True)
            args.atoms, args.features, args.layers = atoms, features, layers
    mol = make_synthetic_molecule(n_atoms=args.atoms, seed=0)
    template = graph_template(mol, t_cond=2)
    model = CPaiNN(args.features, args.layers, n_atoms=args.atoms, temp_length=temp_length,
                   conditioning="ambient",
                   generator=None if params is not None else torch.Generator().manual_seed(0))
    if params is None:
        params = {k: t.detach() for k, t in model.state_dict().items()}
    return model, {k: t.to(dev) for k, t in params.items()}, template, (
        "trained" if args.params else "random-init")


def node_states(v, atoms: int, nodes: int, seed: int, dev):
    """(xs (nodes, N, 3), ts (nodes,)): states along a short velocity-only
    RK4 rollout from a small centred draw, the quadrature-node stand-ins."""
    import torch

    from ti_torch.sampling.integrators import sample_ode

    g = torch.Generator(device=dev).manual_seed(seed)
    x0 = 0.1 * torch.randn(1, atoms, 3, generator=g, device=dev)
    x0 = x0 - x0.mean(dim=1, keepdim=True)
    with torch.no_grad():
        sol = sample_ode(v, x0, n_steps=nodes * 2, n_save=nodes + 1, method="rk4",
                         return_dlogp=False)
    return sol.xs[0, 1:], np.linspace(0.0, 1.0, nodes + 1)[1:]  # skip the start state


def exact_traces(v, xs, ts) -> np.ndarray:
    """The exact trace of the velocity's Jacobian at each node."""
    import torch

    from ti_torch.ops.divergence import divergence_exact

    with torch.no_grad():
        return np.array([float(divergence_exact(lambda y, t=float(t): v(y, t), x[None])[1][0])
                         for x, t in zip(xs, ts)])


def estimator_rows(v_of, temps, xs, ts, exact, probe_list, keys: int, seed: int, dev):
    """Per (mode, K): rms error and bias of the Hutchinson estimate against
    ``exact`` over ``keys`` draws at every node."""
    import torch

    from ti_torch.ops.divergence import divergence_hutchinson, draw_probes

    d = xs[0].numel()
    v = v_of(temps.expand(keys, -1))
    rows = []
    for mode in ("rademacher", "orthogonal"):
        for k in probe_list:
            if mode == "orthogonal" and k > d:
                continue
            errs = []
            for i, (x, t) in enumerate(zip(xs, ts)):
                g = torch.Generator(device=dev).manual_seed(1000 * seed + i)
                z, w = draw_probes(g, "hutchinson", keys, d, num_probes=k, probe_mode=mode)
                with torch.no_grad():
                    est = divergence_hutchinson(lambda y, t=float(t): v(y, t),
                                                x.expand(keys, *x.shape).contiguous(), z=z, w=w)[1]
                errs.append(est.double().cpu().numpy() - exact[i])
            errs = np.concatenate(errs)
            rows.append({
                "mode": mode, "K": k,
                "rms_err": float(np.sqrt(np.mean(errs ** 2))),
                "bias": float(np.mean(errs)),
            })
            print(f"{mode:11s} K={k:3d}: rms err {rows[-1]['rms_err']:8.4f} "
                  f"(bias {rows[-1]['bias']:+.4f})", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--atoms", type=int, default=19)
    ap.add_argument("--features", type=int, default=128)
    ap.add_argument("--layers", type=int, default=5)
    ap.add_argument("--params", default=None,
                    help="port checkpoint (.npz, save_npz) with its arch dict")
    ap.add_argument("--keys", type=int, default=32,
                    help="independent probe draws per (mode, K, node)")
    ap.add_argument("--probes", default="8,16,32",
                    help="comma-separated probe budgets K")
    ap.add_argument("--nodes", type=int, default=4,
                    help="trajectory states (quadrature-node stand-ins)")
    ap.add_argument("--oracle", action="store_true",
                    help="train the CPU-sized harmonic oracle and compare "
                    "end-to-end TFEP dF/ESS per probe mode instead of raw "
                    "estimator rms")
    ap.add_argument("--train_epochs", type=int, default=60)
    ap.add_argument("--reuse", action="store_true",
                    help="(--oracle) cache/reload the trained oracle params "
                    "under probe_mode_oracle in the temporary directory, keyed on "
                    "the arch flags")
    ap.add_argument("--chains", type=int, default=512)
    ap.add_argument("--crn", action="store_true",
                    help="(--oracle) also report probe_crn=True rows — the "
                    "common-random-numbers interplay per probe mode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.oracle and args.params:
        ap.error(
            "--oracle trains its own closed-form harmonic field and "
            "cannot evaluate an external checkpoint; use this "
            "script's --params mode (raw estimator rms) for a trained field."
        )
    import torch

    from ti_torch import resolve_device
    from ti_torch.sampling.drivers import molecular_v_fn_of

    dev = resolve_device(args.device)
    if args.oracle:
        _oracle_study(args, dev)
        return 0

    model, params, template, field = build_field(args, dev)
    v_of = molecular_v_fn_of(model, params, template, device=dev)
    temps = torch.tensor([[1000.0, 300.0]], device=dev)
    v = v_of(temps)
    xs, ts = node_states(v, args.atoms, args.nodes, args.seed, dev)

    d = args.atoms * 3
    probe_list = [int(k) for k in args.probes.split(",")]
    print(f"probe-mode study: {args.atoms} atoms (d={d}), F={args.features} x "
          f"{args.layers}, {field} field, {args.keys} keys x {args.nodes} nodes",
          file=sys.stderr, flush=True)
    exact = exact_traces(v, xs, ts)
    print(f"exact div per node: {np.array2string(exact, precision=3)}",
          file=sys.stderr, flush=True)
    rows = estimator_rows(v_of, temps, xs, ts, exact, probe_list, args.keys, args.seed, dev)

    # headline ratio at each shared budget
    for k in probe_list:
        r = {x["mode"]: x for x in rows if x["K"] == k}
        if len(r) == 2 and r["orthogonal"]["rms_err"] > 0:
            print(f"K={k:3d}: orthogonal/rademacher rms ratio = "
                  f"{r['orthogonal']['rms_err'] / max(r['rademacher']['rms_err'], 1e-12):.3f}",
                  flush=True)
    print("rows: " + json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
