"""The parallel layer (ti_torch.parallel) on a CPU gloo world of 4 ranks,
against ti_tpu's shard_map and jit-sharded runs on the 8 virtual CPU
devices of tests/conftest.py, and against the port's own unsharded runs.

One world is spawned for the whole file (``world``): its ranks run
``test_torch_parallel_ranks.scenarios`` on inputs written here and hand
back one npz each; the tests read them case by case. Bars are ti_tpu's
own (tests/test_parallel.py): lane-sharded exact divergence rtol 1e-5,
samplers rtol 2e-5 / atol 2e-6 (dlogp atol 1e-5 on the lane samplers), the
data-parallel step loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from test_torch_parallel_ranks import (
    EXACT_CASES,
    GAUSS,
    N_ATOMS,
    F,
    LAYERS,
    dense_loss_step,
    scenarios,
    temps_of,
)
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.convert import params_to_flax, save_npz
from ti_torch.models.cpainn import CPaiNN
from ti_torch.parallel.fanout import shard_slice
from ti_torch.parallel.launch import run_ranks
from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.ops.divergence import _probe_block, divergence_exact, divergence_hutchinson
from ti_tpu.parallel.mesh import lane_parallel_sampler as jax_lane_parallel_sampler
from ti_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ti_tpu.parallel.mesh import shard_batch as jax_shard_batch
from ti_tpu.sampling.drivers import make_ode_sampler as jax_make_ode_sampler
from ti_tpu.sampling.drivers import molecular_v_fn_of as jax_v_fn_of

WORLD = 4
HUTCH = {"rademacher": 8, "orthogonal": 24}  # probes at d = 6 over 4 ranks
JAX_GAUSS = {k: v for k, v in GAUSS.items() if k != "device"}


def _jax_toy(x):
    return jnp.sin(x) * jnp.roll(x, 1) + 0.3 * x ** 2


def _chain_keys(n):
    return [jax.random.PRNGKey(100 + b) for b in range(n)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Write the inputs, run the 4-rank world once, return (inputs, the
    ranks' results, (the JAX model, its params, its template), the port's
    weights)."""
    work = tmp_path_factory.mktemp("torch_parallel")
    rng = np.random.default_rng(0)
    # a fresh CPaiNN draws flax's laws; the JAX side takes its weights as they are
    state = {k: v.detach() for k, v in CPaiNN(F, LAYERS, n_atoms=N_ATOMS, generator=torch.Generator(
        ).manual_seed(0)).state_dict().items()}
    save_npz(str(work / "weights.npz"), state)
    jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=2)
    jm = JaxCPaiNN(n_features=F, score_layers=LAYERS, conditioning="ambient")
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_flax(state))

    def frames(b, scale=0.2):
        x = (scale * rng.standard_normal((b, N_ATOMS, 3))).astype(np.float32)
        return x - x.mean(axis=1, keepdims=True)

    inp = {f"toy_x{d}": rng.standard_normal((3, d)).astype(np.float32) for d in (6, 7, 16)}
    keys = _chain_keys(3)
    for mode, k in HUTCH.items():
        per = -(-k // WORLD)
        blocks = [[_probe_block(jax.random.fold_in(key, r), per, 6, jnp.float32, mode)
                   for key in keys] for r in range(WORLD)]
        inp[f"hutch_z_{mode}"] = np.asarray([[np.asarray(z) for z, _ in row] for row in blocks])
        inp[f"hutch_w_{mode}"] = np.asarray([[np.asarray(w) for _, w in row] for row in blocks])
    inp.update(x16=frames(16), x2=frames(2), x4=frames(4), dp_x0=frames(16, 0.3),
               dp_x1=frames(16, 0.3), dp_temps=temps_of(16))
    np.savez(work / "inputs.npz", **inp)
    run_ranks(scenarios, WORLD, (str(work),), timeout_s=240)
    results = [dict(np.load(work / f"results_{r}.npz")) for r in range(WORLD)]
    return inp, results, (jm, jp, jt), state


def test_every_rank_holds_the_same_result(world):
    """The gathered samples, the lane-reduced traces and the updated
    parameters are replicated: every rank ends with rank 0's, to the bit."""
    results = world[1]
    for r in range(1, WORLD):
        for k, v in results[0].items():
            if not k.startswith(("dp3_", "hutch_", "guard_", "unsharded_")):
                np.testing.assert_array_equal(results[r][k], v, err_msg=k)
    for r in range(1, 3):
        for k, v in results[0].items():
            if k.startswith("dp3_param"):
                np.testing.assert_array_equal(results[r][k], v, err_msg=k)


@pytest.mark.parametrize("d,chunk", EXACT_CASES)
def test_lane_sharded_exact_divergence_matches_jax(world, d, chunk):
    inp, results = world[:2]
    x = inp[f"toy_x{d}"]
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    body = jax.jit(jax.shard_map(
        lambda xx: divergence_exact(_jax_toy, xx, chunk=chunk, axis_name="data"), mesh=mesh,
        in_specs=P(), out_specs=(P(), P()), check_vma=False))
    ref = [body(jnp.asarray(xb)) for xb in x]
    plain = [divergence_exact(_jax_toy, jnp.asarray(xb)) for xb in x]
    out_y, out_div = results[0][f"exact_y_{d}_{chunk}"], results[0][f"exact_div_{d}_{chunk}"]
    np.testing.assert_allclose(out_y, np.stack([np.asarray(y) for y, _ in ref]), rtol=1e-6)
    np.testing.assert_allclose(out_div, [float(v) for _, v in ref], rtol=1e-5)
    np.testing.assert_allclose(out_div, [float(v) for _, v in plain], rtol=1e-5)


@pytest.mark.parametrize("mode", sorted(HUTCH))
def test_lane_sharded_hutchinson_matches_jax(world, mode):
    """Every rank fed ti_tpu's own per-shard draws (fold_in(key, rank))
    reproduces ti_tpu's lane-sharded estimate; 24 orthogonal probes over 4
    ranks at d = 6 are a full frame on every rank, so that one is exact."""
    inp, results = world[:2]
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    ref = []
    for xb, key in zip(inp["toy_x6"], _chain_keys(3)):
        body = jax.jit(jax.shard_map(
            lambda xx, kk=key: divergence_hutchinson(_jax_toy, xx, kk, num_probes=HUTCH[mode],
                                                     axis_name="data", probe_mode=mode),
            mesh=mesh, in_specs=P(), out_specs=(P(), P()), check_vma=False))
        ref.append(float(body(jnp.asarray(xb))[1]))
    np.testing.assert_allclose(results[0][f"hutch_{mode}"], ref, rtol=1e-5, atol=1e-6)
    if mode == "orthogonal":
        exact = [float(divergence_exact(_jax_toy, jnp.asarray(xb))[1]) for xb in inp["toy_x6"]]
        np.testing.assert_allclose(results[0]["hutch_orthogonal"], exact, rtol=1e-4)
        np.testing.assert_allclose(results[0]["hutch_own_orthogonal"], exact, rtol=1e-4)


@pytest.mark.parametrize("case,message", [
    ("guard_return_var", "return_var is not supported with axis_name"),
    ("guard_hutchpp", "not implemented for hutchpp"),
    ("guard_orthogonal", "ceil(28/4) = 7 probes per shard but dim is only 6"),
    ("guard_sampler_hutchpp", "not implemented for divergence='hutchpp'"),
    ("guard_div_drift", "div_axis is not supported with div_drift"),
    ("guard_unresolved_name", "names a mesh dimension but no mesh is in use"),
])
def test_lane_sharding_refusals(world, case, message):
    assert message in str(world[1][0][case])


def small_model_from(world):
    return (CPaiNN(F, LAYERS, n_atoms=N_ATOMS), world[3],
            graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2))


@pytest.mark.parametrize("rank,case", enumerate(["gauss_exact", "gauss_orthogonal",
                                                  "dopri5_rademacher", "main_path"]))
def test_chain_sharded_sampler_equals_unsharded(world, rank, case):
    """16 chains over 4 ranks: the gathered samples and dlogps are the
    unsharded run's, Hutchinson included (every rank draws the batch's
    probes and keeps its chains'; dopri5's ranks step in lockstep), and the
    main path's route (B1 and B3 through their plain versions here)."""
    res, ref = world[1][0], world[1][rank]  # rank r ran case r unsharded too
    np.testing.assert_allclose(res[f"chain_{case}_xs"], ref["unsharded_xs"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(res[f"chain_{case}_dlogp"], ref["unsharded_dlogp"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(res[f"chain_{case}_nfe"], ref["unsharded_nfe"])
    assert np.isfinite(res[f"chain_{case}_dlogp"]).all()


def test_chain_sharded_exact_sampler_matches_jax(world):
    """ti_tpu's test_headline_sampler_chain_sharded run (RK4-8, GL-4, the
    exact divergence, chains sharded over an 8-device mesh) on the same
    weights and chains."""
    inp, results, (jm, jp, jt), _ = world
    sampler = jax_make_ode_sampler(jax_v_fn_of(jm, jp, jt), divergence="exact", **JAX_GAUSS)
    mesh = jax_make_mesh(8)
    x, temps = jnp.asarray(inp["x16"]), jnp.asarray(temps_of(16))
    ref = sampler(jax_shard_batch(x, mesh), jax_shard_batch(temps, mesh), jax.random.PRNGKey(1))
    np.testing.assert_allclose(results[0]["chain_gauss_exact_xs"], np.asarray(ref.xs),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(results[0]["chain_gauss_exact_dlogp"], np.asarray(ref.dlogp),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("layout", ["lanes", "mesh2d"])
def test_lane_parallel_sampler_matches_jax(world, layout):
    """The Gauss-dlogp sampler built with div_axis="lanes": over 4 lane
    ranks (2 chains: 24 lanes, 6 a rank), and over a 2 x 2 chains x lanes
    mesh (4 chains), against ti_tpu's lane_parallel_sampler on the same
    layouts."""
    inp, results, (jm, jp, jt), _ = world
    sampler = jax_make_ode_sampler(jax_v_fn_of(jm, jp, jt), divergence="exact",
                                   div_axis="lanes", **JAX_GAUSS)
    devs = np.asarray(jax.devices()[:WORLD])
    if layout == "lanes":
        x, wrap = inp["x2"], jax_lane_parallel_sampler(sampler, Mesh(devs, ("lanes",)))
    else:
        x, wrap = inp["x4"], jax_lane_parallel_sampler(
            sampler, Mesh(devs.reshape(2, 2), ("data", "lanes")), chain_axis="data")
    ref = wrap(jnp.asarray(x), jnp.asarray(temps_of(len(x))), jax.random.PRNGKey(1))
    np.testing.assert_allclose(results[0][f"{layout}_xs"], np.asarray(ref.xs), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(results[0][f"{layout}_dlogp"], np.asarray(ref.dlogp), rtol=2e-5,
                               atol=1e-5)


def _single_device_step(world, microbatches=None):
    """The port's step on one process: the whole batch (``make_update_step``),
    or the given microbatches' rows in turn (mean of their gradients)."""
    inp = world[0]
    model, params, template = small_model_from(world)
    step, live = dense_loss_step(model, params, template)
    batch = [torch.as_tensor(inp[k]) for k in ("dp_x0", "dp_x1", "dp_temps")]
    gen = torch.Generator().manual_seed(11)
    if microbatches is None:
        loss = step(gen, *batch)
    else:
        plist = list(live.values())
        losses, grads = [], []
        for rows in microbatches:
            l = step.loss_fn(gen, *(x[rows] for x in batch))
            losses.append(l.detach())
            grads.append(torch.autograd.grad(l, plist))
        mean = [sum(g) / len(grads) for g in zip(*grads)]
        loss = step.optimizer.step(sum(losses) / len(losses), mean)
    return loss, {k: p.detach().numpy() for k, p in live.items()}


def test_parallel_update_equals_single_device_step(world):
    """16 molecules over 4 ranks, the dense f32 molecular loss: the loss,
    its x_t^± centred over the whole batch, the clip (the gradient's norm
    is above 1) and the updated parameters are the one-device step's."""
    inp, results = world[:2]
    model, params, template = small_model_from(world)
    step, live = dense_loss_step(model, params, template)
    batch = [torch.as_tensor(inp[k]) for k in ("dp_x0", "dp_x1", "dp_temps")]
    l = step.loss_fn(torch.Generator().manual_seed(11), *batch)
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in torch.autograd.grad(l, list(live.values()))]))
    assert float(norm) > 1.0, "the clip is engaged"
    loss, ref = _single_device_step(world)
    np.testing.assert_allclose(results[0]["dp_loss"], loss, rtol=1e-5)
    for k, v in ref.items():
        np.testing.assert_allclose(results[0][f"dp_param_{k}"], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_parallel_update_uneven_split_with_grad_accum(world):
    """16 molecules over 3 ranks (6, 5, 5 rows) in 2 microbatches a rank:
    microbatch i of every rank makes the batch's microbatch i (9 and 7
    molecules), which the one-device reference takes in turn."""
    results = world[1]
    rank_rows = [range(*shard_slice(16, r, 3)) for r in range(3)]
    micro = [[], []]
    for rows in rank_rows:
        for i in range(2):
            lo, hi = shard_slice(len(rows), i, 2)
            micro[i].extend(rows[lo:hi])
    assert [len(m) for m in micro] == [9, 7]
    np.testing.assert_array_equal(results[0]["dp3_block"], world[0]["dp_x0"][0:6])
    loss, ref = _single_device_step(world, [torch.as_tensor(m) for m in micro])
    np.testing.assert_allclose(results[0]["dp3_loss"], loss, rtol=1e-5)
    for k, v in ref.items():
        np.testing.assert_allclose(results[0][f"dp3_param_{k}"], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
