"""The rank side of the parallel layer's CPU tests, and the tests that need
no JAX.

``scenarios`` runs on every rank of the 4-rank gloo world that
``tests/test_torch_parallel.py`` spawns through
``ti_torch.parallel.launch.run_ranks``: it reads the inputs the parent
wrote, runs every sharded case and writes what it got to
``results_{rank}.npz``. Spawned children import this module afresh, so it
imports neither JAX nor ``tests/conftest.py``.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ti_torch.config import ambient_preset, fast_profile
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.interpolants import linear
from ti_torch.losses import molecular_velocity_loss
from ti_torch.models.convert import load_npz
from ti_torch.models.cpainn import CPaiNN
from ti_torch.ops.divergence import divergence_exact, divergence_hutchinson, value_and_divergence
from ti_torch.parallel import (
    lane_parallel_sampler,
    make_mesh,
    parallel_sampler,
    parallel_update,
    shard_batch,
)
from ti_torch.parallel.collectives import lane_group
from ti_torch.parallel.launch import run_ranks
from ti_torch.sampling.drivers import _config_sampler, make_ode_sampler, molecular_v_fn_of
from ti_torch.train import common

N_ATOMS, F, LAYERS = 4, 16, 1
GAUSS = dict(solver="rk4", n_steps=8, n_save=2, return_dlogp=True, dlogp_quad_points=4,
             dlogp_quad="gauss", device="cpu")
TEMPS = (700.0, 300.0)
EXACT_CASES = ((7, None), (16, None), (16, 1))  # (d, chunk); d = 7 pads the last rank


def toy_field(x):
    """The nonlinear toy field of tests/test_parallel.py, chain by chain."""
    return torch.sin(x) * torch.roll(x, 1, dims=-1) + 0.3 * x ** 2


def small_model(weights: str):
    model = CPaiNN(F, LAYERS, n_atoms=N_ATOMS)
    params = load_npz(weights)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2)
    return model, params, template


def temps_of(b: int) -> np.ndarray:
    return np.tile(np.array(TEMPS, np.float32), (b, 1))


def main_path_cfg():
    """``fast_profile(ambient_preset("00031"))`` at the tests' width: the
    main path's route (B1 on the trajectory, B3 in bf16_agg at the nodes,
    orthogonal Hutchinson), here through the plain versions."""
    return fast_profile(ambient_preset("00031", n_features=F, score_layers=LAYERS),
                        num_probes=6, n_steps=8)


def chain_samplers(model, params, template) -> dict:
    """The chain-sharded cases, one for each of the 4 ranks to also run
    unsharded: RK4-8 with GL-4 dlogp, exact and orthogonal Hutchinson;
    dopri5 with Rademacher Hutchinson (its chains take different step
    counts); and the main path's route."""
    v_of = molecular_v_fn_of(model, params, template, device="cpu")
    return {
        "gauss_exact": make_ode_sampler(v_of, divergence="exact", **GAUSS),
        "gauss_orthogonal": make_ode_sampler(v_of, divergence="hutchinson", num_probes=4,
                                             probe_mode="orthogonal", **GAUSS),
        "dopri5_rademacher": make_ode_sampler(v_of, solver="dopri5", n_save=2, atol=1e-2,
                                              rtol=1e-2, divergence="hutchinson",
                                              num_probes=2, device="cpu"),
        "main_path": _config_sampler(main_path_cfg(), model, params, template,
                                     torch.device("cpu")),
    }


def dense_loss_step(model, params, template, lr: float = 1e-3, accum: int = 1):
    """``make_update_step`` over the dense f32 molecular loss, as
    ``train_ambient`` builds it for ``train_impl="dense"``."""

    class Cfg:
        train_impl = "dense"
        train_compute_dtype = "f32"

    model.load_state_dict(params)
    live = dict(model.named_parameters())
    batched = common.make_batched_apply(Cfg, model, template)
    interp = linear(a=1.0, gamma="sin2")

    def loss_fn(gen, x0, x1, temps):
        return molecular_velocity_loss(batched, live, x0, x1, temps, interp, generator=gen)

    opt = common.make_optimizer(list(live.values()), lr, clip=1.0)
    return common.make_update_step(loss_fn, opt, accum_steps=accum), live


def _raises(exc, fn) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


def scenarios(rank: int, world: int, workdir: str) -> None:
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    model, params, template = small_model(os.path.join(workdir, "weights.npz"))
    out = {}
    data = make_mesh(device_type="cpu")
    group = data.get_group("data")

    # exact lane-sharded divergence over the world group
    for d, chunk in EXACT_CASES:
        x = torch.as_tensor(inp[f"toy_x{d}"])
        y, div = divergence_exact(toy_field, x, chunk=chunk, axis_name=group)
        out[f"exact_y_{d}_{chunk}"], out[f"exact_div_{d}_{chunk}"] = y.numpy(), div.numpy()
    # Hutchinson lane-sharded: this rank's probes pinned (ti_tpu's draws),
    # then the port's own draws (24 orthogonal probes over 4 ranks at d = 6)
    x6 = torch.as_tensor(inp["toy_x6"])
    for mode in ("rademacher", "orthogonal"):
        z, w = (torch.as_tensor(inp[f"hutch_{k}_{mode}"][rank]) for k in ("z", "w"))
        _, est = divergence_hutchinson(toy_field, x6, z=z, w=w, probe_mode=mode,
                                       axis_name=group)
        out[f"hutch_{mode}"] = est.numpy()
    gen = torch.Generator().manual_seed(3)
    _, est = value_and_divergence(toy_field, x6, mode="hutchinson", generator=gen, num_probes=24,
                                  probe_mode="orthogonal", axis_name=group)
    out["hutch_own_orthogonal"] = est.numpy()

    # the refusals, in ti_tpu's terms
    v_of = molecular_v_fn_of(model, params, template, device="cpu")
    out["guard_return_var"] = _raises(NotImplementedError, lambda: divergence_hutchinson(
        toy_field, x6, gen, num_probes=8, return_var=True, axis_name=group))
    out["guard_hutchpp"] = _raises(NotImplementedError, lambda: value_and_divergence(
        toy_field, x6, mode="hutchpp", generator=gen, num_probes=6, axis_name=group))
    out["guard_orthogonal"] = _raises(ValueError, lambda: divergence_hutchinson(
        toy_field, x6, gen, num_probes=28, probe_mode="orthogonal", axis_name=group))
    out["guard_sampler_hutchpp"] = _raises(NotImplementedError, lambda: make_ode_sampler(
        v_of, divergence="hutchpp", num_probes=6, div_axis=group, **GAUSS))
    out["guard_div_drift"] = _raises(ValueError, lambda: make_ode_sampler(
        v_of, divergence="hutchinson", steps_per_dispatch=4, div_axis=group,
        div_drift=lambda *a: None, **GAUSS))
    out["guard_unresolved_name"] = _raises(ValueError, lambda: lane_group("lanes"))

    # chain-sharded samplers: 16 chains over 4 ranks
    x16, gen_seed = inp["x16"], 5
    t16 = temps_of(len(x16))
    for i, (name, sampler) in enumerate(chain_samplers(model, params, template).items()):
        sol = parallel_sampler(sampler, data)(x16, t16, torch.Generator().manual_seed(gen_seed))
        out[f"chain_{name}_xs"], out[f"chain_{name}_dlogp"] = sol.xs.numpy(), sol.dlogp.numpy()
        out[f"chain_{name}_nfe"] = np.asarray(sol.nfe)
        if i == rank:  # and one case unsharded, the ranks' four in parallel
            sol = sampler(x16, t16, torch.Generator().manual_seed(gen_seed))
            out["unsharded_xs"], out["unsharded_dlogp"] = sol.xs.numpy(), sol.dlogp.numpy()
            out["unsharded_nfe"] = np.asarray(sol.nfe)

    # lane-sharded samplers: 4 lane ranks, then 2 x 2 (chains x lanes)
    lane_sampler = make_ode_sampler(v_of, divergence="exact", div_axis="lanes", **GAUSS)
    lanes = make_mesh(axis_name="lanes", device_type="cpu")
    sol = lane_parallel_sampler(lane_sampler, lanes)(inp["x2"], temps_of(2))
    out["lanes_xs"], out["lanes_dlogp"] = sol.xs.numpy(), sol.dlogp.numpy()
    mesh2d = make_mesh(axis_name=("data", "lanes"), shape=(2, 2), device_type="cpu")
    sol = lane_parallel_sampler(lane_sampler, mesh2d, chain_axis="data")(inp["x4"], temps_of(4))
    out["mesh2d_xs"], out["mesh2d_dlogp"] = sol.xs.numpy(), sol.dlogp.numpy()

    # data-parallel training: 16 molecules over the 4 ranks, then over 3 of
    # them with 2 microbatches a rank
    batch = [torch.as_tensor(inp[k]) for k in ("dp_x0", "dp_x1", "dp_temps")]
    step, live = dense_loss_step(model, params, template)
    out["dp_loss"] = np.float64(parallel_update(step, data)(torch.Generator().manual_seed(11),
                                                            *batch))
    for k, p in live.items():
        out[f"dp_param_{k}"] = p.detach().numpy().copy()
    mesh3 = make_mesh(3, device_type="cpu")
    if mesh3 is not None:
        step, live = dense_loss_step(model, params, template, accum=2)
        out["dp3_loss"] = np.float64(parallel_update(step, mesh3)(
            torch.Generator().manual_seed(11), *batch))
        for k, p in live.items():
            out[f"dp3_param_{k}"] = p.detach().numpy().copy()
        out["dp3_block"] = shard_batch(batch[0], mesh3).numpy()
    np.savez(os.path.join(workdir, f"results_{rank}.npz"), **out)


def _fails_on_rank_1(rank: int, world: int) -> None:
    if rank == 1:
        raise ValueError("rank 1 stops here")
    dist.barrier()  # never completed: rank 1 does not come


def _finishes(rank: int, world: int, workdir: str) -> None:
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    np.save(os.path.join(workdir, f"sum_{rank}.npy"), x.numpy())


def test_launcher_runs_a_world(tmp_path):
    run_ranks(_finishes, 2, (str(tmp_path),), timeout_s=60)
    assert [float(np.load(tmp_path / f"sum_{r}.npy")[0]) for r in range(2)] == [3.0, 3.0]


def test_launcher_surfaces_a_failing_rank_within_its_timeout():
    """A rank that raises ends the run with its traceback, though the other
    rank waits in a collective it will never complete."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 stops here"):
        run_ranks(_fails_on_rank_1, 2, timeout_s=60, collective_timeout_s=30)
    assert time.monotonic() - t0 < 60


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device_type="cpu")


def test_init_distributed_never_falls_back():
    from ti_torch.parallel import init_distributed

    with pytest.raises(ValueError, match="NCCL on the card and gloo on the CPU"):
        init_distributed("nccl", device="cpu", rank=0, world_size=1)
    assert not dist.is_initialized()
