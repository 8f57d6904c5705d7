"""Kernel B3 (the pair-tangent kernel) and the divergence estimators of the
PyTorch port.

With the same explicit probes z (numpy), the plain version behind the
wrapper on the CPU is held against the JAX package's Pallas kernel in
interpret mode: velocity rtol 2e-4, every lane's JVP rtol 5e-4 / atol 5e-5
(the bars of tests/test_pair_tangent_kernel.py). The orthogonal frame at
K = 3N must give the exact divergence (rtol 2e-3 / atol 2e-4). The CUDA
kernel itself runs only on the card: tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.models.cpainn_dense import dense_velocity_fn as jax_dense_velocity
from ti_tpu.ops.divergence import divergence_exact as jax_divergence_exact
from ti_tpu.ops.divergence import hutchinson_var_estimate as jax_var
from ti_tpu.ops.pair_tangent_kernel import apply_dense_pair_tangent as jax_pair_tangent
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.convert import params_from_flax
from ti_torch.models.cpainn import CPaiNN
from ti_torch.models.cpainn_dense import dense_velocity_fn
from ti_torch.ops import _build
from ti_torch.ops.divergence import (
    _probe_block,
    divergence_exact,
    divergence_hutchinson,
    hutchinson_var_estimate,
)
from ti_torch.ops.pair_layer_kernel import prepare
from ti_torch.ops.pair_tangent_kernel import (
    _pick_lane_block,
    apply_dense_pair_tangent,
    pair_tangent_div_fn,
    smem_bytes,
)

N_ATOMS, F, LAYERS, B = 5, 16, 2, 3


@pytest.fixture(scope="module")
def setup():
    jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=2)
    jm = JaxCPaiNN(n_features=F, score_layers=LAYERS, temp_length=100.0, conditioning="ambient")
    jp = jm.init(jax.random.PRNGKey(0), jt)
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    model = CPaiNN(F, LAYERS, n_atoms=N_ATOMS)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2)
    rng = np.random.default_rng(7)
    x = (0.3 * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    t = np.full((B,), 0.37, np.float32)
    temps = np.tile(np.array([700.0, 300.0], np.float32), (B, 1))
    return jm, jp, jt, params, model, template, x, t, temps


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("lane_block", [1, 2, 4])
def test_plain_primal_and_lanes_match_jax(setup, lane_block):
    jm, jp, jt, params, model, template, x, t, temps = setup
    z = np.random.default_rng(3).standard_normal((B, 4, N_ATOMS, 3)).astype(np.float32)
    vel_j, dvel_j = jax_pair_tangent(jm, jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps),
                                     jnp.asarray(z), jt.atom_ids, jt.edges, interpret=True,
                                     lane_block=lane_block)
    pm = prepare(model, params, template, None, torch.device("cpu"))
    vel, dvel = apply_dense_pair_tangent(pm, _t(x), _t(t), _t(temps), _t(z), lane_block=lane_block)
    np.testing.assert_allclose(vel.numpy(), np.asarray(vel_j), rtol=2e-4, atol=2e-5)
    for k in range(4):
        np.testing.assert_allclose(dvel[:, k].numpy(), np.asarray(dvel_j[:, k]),
                                   rtol=5e-4, atol=5e-5)


def test_plain_bf16_lanes_match_jax(setup):
    """bf16_agg: the same rounding points as the JAX kernel; scaled bar
    4e-2 as for the pair layer's bf16 profile."""
    jm, jp, jt, params, model, template, x, t, temps = setup
    z = np.random.default_rng(5).standard_normal((B, 4, N_ATOMS, 3)).astype(np.float32)
    vel_j, dvel_j = jax_pair_tangent(jm, jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps),
                                     jnp.asarray(z), jt.atom_ids, jt.edges, interpret=True,
                                     compute_dtype="bf16_agg")
    pm = prepare(model, params, template, "bf16_agg", torch.device("cpu"))
    vel, dvel = apply_dense_pair_tangent(pm, _t(x), _t(t), _t(temps), _t(z))
    for a, r in ((vel, vel_j), (dvel, dvel_j)):
        r = np.asarray(r)
        scale = max(np.abs(r).max(), 1e-3)
        np.testing.assert_allclose(a.numpy() / scale, r / scale, atol=4e-2)


def test_orthogonal_full_frame_is_the_exact_divergence(setup):
    jm, jp, jt, params, model, template, x, t, temps = setup
    d = 3 * N_ATOMS
    div_fn = pair_tangent_div_fn(model, params, template, num_probes=d,
                                 probe_mode="orthogonal", device="cpu")
    gen = torch.Generator().manual_seed(11)
    divs = div_fn(_t(x), 0.37, _t(temps), gen)

    drift = dense_velocity_fn(model, params, template)
    exact = divergence_exact(lambda y: drift(y, 0.37, _t(temps)), _t(x))[1]
    np.testing.assert_allclose(divs.numpy(), exact.numpy(), rtol=2e-3, atol=2e-4)

    v_fn = jax_dense_velocity(jm, jp, jt)
    ref = [jax_divergence_exact(lambda y: v_fn(y[None], t[i], jnp.asarray(temps[i])[None])[0],
                                jnp.asarray(x[i]))[1] for i in range(B)]
    np.testing.assert_allclose(exact.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_hutchinson_with_explicit_probes(setup):
    """The default-route estimator contracts the same Σ w z·Jz as the
    pair-tangent estimator on the same probes."""
    _jm, _jp, _jt, params, model, template, x, t, temps = setup
    gen = torch.Generator().manual_seed(2)
    z, w = _probe_block(gen, 6, 3 * N_ATOMS, "rademacher", shape=(B,))
    drift = dense_velocity_fn(model, params, template)
    _, div, var = divergence_hutchinson(lambda y: drift(y, 0.37, _t(temps)), _t(x), z=z, w=w,
                                        probe_mode="rademacher", return_var=True)
    pm = prepare(model, params, template, None, torch.device("cpu"))
    zt = z.reshape(B, 6, N_ATOMS, 3)
    _, dvel = apply_dense_pair_tangent(pm, _t(x), _t(t), _t(temps), zt)
    est = (zt * dvel).sum((2, 3))
    np.testing.assert_allclose(div.numpy(), (w * est).sum(1).numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(var.numpy(), hutchinson_var_estimate(est, w, 15, "rademacher").numpy(),
                               rtol=2e-3, atol=1e-5)


def test_probe_blocks():
    gen = torch.Generator().manual_seed(0)
    z, w = _probe_block(gen, 12, 12, "orthogonal", shape=(4,))
    eye = torch.eye(12).expand(4, 12, 12)
    torch.testing.assert_close(z.transpose(-1, -2) @ z, eye, rtol=0, atol=1e-5)
    assert torch.all(w == 1.0)
    z, w = _probe_block(gen, 5, 12, "rademacher")
    assert set(z.unique().tolist()) <= {-1.0, 1.0} and torch.allclose(w, torch.full((5,), 0.2))
    with pytest.raises(ValueError, match="num_probes <= dim"):
        _probe_block(gen, 13, 12, "orthogonal")


@pytest.mark.parametrize("mode", ["rademacher", "orthogonal"])
def test_variance_estimate_matches_jax(mode):
    rng = np.random.default_rng(9)
    est = rng.standard_normal((6, 16)).astype(np.float32)
    w = np.full((6, 16), 57 / 16 if mode == "orthogonal" else 1 / 16, np.float32)
    ref = np.stack([np.asarray(jax_var(jnp.asarray(e), jnp.asarray(ww), 57, mode))
                    for e, ww in zip(est, w)])
    out = hutchinson_var_estimate(_t(est), _t(w), 57, mode).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_lane_block_choice_and_shared_memory():
    assert _pick_lane_block(57, bf16=False) == 1
    assert _pick_lane_block(16, bf16=True) == 4
    assert _pick_lane_block(18, bf16=True) == 2
    assert smem_bytes(False, 1) <= 232_448 and smem_bytes(True, 4) <= 232_448
    assert smem_bytes(False, 2) > 232_448


def test_cpu_route_launches_nothing(setup):
    _jm, _jp, _jt, params, model, template, x, _t_, temps = setup
    _build.reset_launches()
    div_fn = pair_tangent_div_fn(model, params, template, num_probes=4,
                                 compute_dtype="bf16_agg", device="cpu", return_var=True)
    div, var = div_fn(_t(x), 0.5, _t(temps), torch.Generator().manual_seed(0))
    assert div.shape == (B,) and var.shape == (B,)
    assert torch.isfinite(div).all() and (var >= 0).all()
    assert {"pair_layer", "pair_tangent"} <= set(_build.LAUNCHES)
    assert not any(_build.LAUNCHES.values())
