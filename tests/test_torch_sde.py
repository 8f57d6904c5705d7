"""The SDE path of the PyTorch port against the JAX package:
``integrators.sample_sde``, velocity-only ``make_ode_sampler`` and
``sample_molecular_sde`` (dense and pair-kernel drifts, f32 and bf16_agg,
``chain_block``).

The noise is JAX's own draws (``normal(fold_in(key, i))`` per step,
ti_tpu/sampling/integrators.py:570) passed to the port as ``noise=``.
Bars: sample_sde rtol 1e-5 / atol 1e-6 (the same f32 arithmetic);
samplers and f32 SDE rtol 1e-4 / atol 1e-5 (two BLAS libraries sum in
different orders); bf16_agg the scaled atol 4e-2 of
tests/test_pair_layer_kernel.py, on the displacement x_t - x_0. The pair
kernel runs its plain version here and in interpret mode on the JAX side;
kernels B1/B2 themselves run on the card (tests/test_torch_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.ops.pair_layer_kernel import pair_kernel_drift as jax_pair_kernel_drift
from ti_tpu.sampling.drivers import make_ode_sampler as jax_make_ode_sampler
from ti_tpu.sampling.drivers import molecular_v_fn_of as jax_v_fn_of
from ti_tpu.sampling.drivers import sample_molecular_sde as jax_sample_molecular_sde
from ti_tpu.sampling.integrators import sample_sde as jax_sample_sde
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.convert import params_from_flax
from ti_torch.models.cpainn import CPaiNN
from ti_torch.ops import _build
from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of, sample_molecular_sde
from ti_torch.sampling.integrators import sample_sde

N_ATOMS, F, LAYERS, B = 5, 16, 2, 5
N_STEPS, N_SAVE = 4, 3
F32_BAR = dict(rtol=1e-4, atol=1e-5)


def _jax_noise(key, n_steps, shape):
    """The draws of JAX sample_sde's step i, stacked (n_steps, *shape)."""
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape))
                     for i in range(n_steps)])


@pytest.fixture(scope="module")
def setup():
    jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=2)
    jm = JaxCPaiNN(n_features=F, score_layers=LAYERS, conditioning="ambient")
    jp = jm.init(jax.random.PRNGKey(0), jt)
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    model = CPaiNN(F, LAYERS, n_atoms=N_ATOMS)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2)
    rng = np.random.default_rng(1)
    x0 = (0.2 * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    x0 -= x0.mean(axis=1, keepdims=True)
    temps = np.tile(np.array([700.0, 300.0], np.float32), (B, 1))
    key = jax.random.PRNGKey(3)
    noise = _jax_noise(key, N_STEPS, x0.shape)
    return jm, jp, jt, params, model, template, x0, temps, key, noise


@pytest.mark.parametrize("g,project", [(0.0, False), (0.3, False), (0.3, True), ("callable", True)])
def test_sample_sde_matches_jax(g, project):
    """A linear time-dependent field; at g = 0 the Euler ODE, at g > 0 with
    JAX's noise, with and without the zero-mean projection."""
    rng = np.random.default_rng(0)
    a = (0.5 * rng.standard_normal((3, 3))).astype(np.float32)
    x0 = rng.standard_normal((4, 6, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    g_j = (lambda t: 0.4 * (1.0 - t)) if g == "callable" else g
    g_t = (lambda t: 0.4 * (1.0 - t)) if g == "callable" else g
    kw = dict(t0=0.1, t1=0.9, n_steps=6, n_save=4, project_zero_mean=project)
    ref = jax_sample_sde(lambda x, t: x @ jnp.asarray(a).T + t, jnp.asarray(x0), key, g_fn=g_j,
                         **kw)
    out = sample_sde(lambda x, t: x @ torch.from_numpy(a).T + t, torch.from_numpy(x0),
                     g_fn=g_t, noise=torch.from_numpy(_jax_noise(key, 6, x0.shape)), **kw)
    assert out.shape == (4, 4, 6, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("solver", ["euler", "rk4"])
@pytest.mark.parametrize("steps_per_dispatch", [None, 2])
def test_velocity_only_sampler_matches_jax(setup, solver, steps_per_dispatch):
    jm, jp, jt, params, model, template, x0, temps, key, _ = setup
    kw = dict(solver=solver, n_steps=8, n_save=3, return_dlogp=False,
              steps_per_dispatch=steps_per_dispatch)
    ref = jax_make_ode_sampler(jax_v_fn_of(jm, jp, jt), **kw)(jnp.asarray(x0),
                                                             jnp.asarray(temps), key)
    out = make_ode_sampler(molecular_v_fn_of(model, params, template, device="cpu"),
                           device="cpu", **kw)(x0, temps, torch.Generator().manual_seed(0))
    assert out.xs.shape == (B, 3, N_ATOMS, 3)
    np.testing.assert_allclose(out.xs.numpy(), np.asarray(ref.xs), **F32_BAR)
    assert not out.dlogp.any()
    assert out.nfe == int(np.max(ref.nfe))  # per chain when unsegmented


@pytest.mark.parametrize("forward_impl", ["dense", "pair_kernel"])
@pytest.mark.parametrize("compute_dtype", [None, "bf16_agg"])
def test_molecular_sde_matches_jax(setup, forward_impl, compute_dtype):
    """JAX's side: sample_molecular_sde itself for the dense drift; for the
    pair kernel, sample_sde over pair_kernel_drift(interpret=True) composed
    as sample_molecular_sde composes it (its own call passes no interpret
    and cannot lower the Pallas kernel on the CPU)."""
    jm, jp, jt, params, model, template, x0, temps, key, noise = setup
    kw = dict(g_fn=0.3, n_steps=N_STEPS, n_save=N_SAVE)
    if forward_impl == "dense":
        ref = jax_sample_molecular_sde(jm, jp, jt, jnp.asarray(x0), jnp.asarray(temps), key,
                                       compute_dtype=compute_dtype, **kw)
    else:
        drift = jax_pair_kernel_drift(jm, jp, jt, compute_dtype=compute_dtype, interpret=True)
        conds = jnp.asarray(temps)
        ref = jnp.moveaxis(jax_sample_sde(
            lambda x, t: drift(x, t, conds).astype(x.dtype), jnp.asarray(x0), key,
            project_zero_mean=True, **kw), 0, 1)
    ref = np.asarray(ref)
    out = sample_molecular_sde(model, params, template, x0, temps, compute_dtype=compute_dtype,
                               forward_impl=forward_impl, noise=torch.from_numpy(noise),
                               device="cpu", **kw).numpy()
    assert out.shape == (B, N_SAVE, N_ATOMS, 3)
    if compute_dtype is None:
        np.testing.assert_allclose(out, ref, **F32_BAR)
    else:
        moved, moved_ref = out - x0[:, None], ref - x0[:, None]
        scale = max(np.abs(moved_ref).max(), 1e-3)
        np.testing.assert_allclose(moved / scale, moved_ref / scale, atol=4e-2)


def test_molecular_sde_at_zero_noise_is_the_euler_sampler(setup):
    """g = 0 is the deterministic Euler transport of make_ode_sampler, and
    with noise the chains' centre of mass moves only with the drift's."""
    _jm, _jp, _jt, params, model, template, x0, temps, _key, noise = setup
    kw = dict(n_steps=8, n_save=3, device="cpu")
    out = sample_molecular_sde(model, params, template, x0, temps,
                               torch.Generator().manual_seed(0), g_fn=0.0, **kw)
    ode = make_ode_sampler(molecular_v_fn_of(model, params, template, device="cpu"),
                           solver="euler", return_dlogp=False, **kw)(x0, temps)
    torch.testing.assert_close(out, ode.xs, rtol=1e-5, atol=1e-6)
    noisy = sample_molecular_sde(model, params, template, x0, temps, g_fn=0.5,
                                 noise=torch.from_numpy(noise), n_steps=N_STEPS, n_save=N_SAVE,
                                 device="cpu")
    drift_only = sample_molecular_sde(model, params, template, x0, temps, g_fn=0.0,
                                      noise=torch.from_numpy(noise), n_steps=N_STEPS,
                                      n_save=N_SAVE, device="cpu")
    assert (noisy - drift_only).abs().max() > 1e-3
    # the noise is COM-free, so over one step the COM moves as the drift's
    com = noisy.mean(dim=2)
    assert torch.allclose(com[:, 0], torch.zeros(B, 3), atol=1e-6)
    one = sample_molecular_sde(model, params, template, x0, temps, g_fn=0.5,
                               noise=torch.from_numpy(noise[:1]), n_steps=1, n_save=2,
                               device="cpu")
    one_drift = sample_molecular_sde(model, params, template, x0, temps, g_fn=0.0,
                                     noise=torch.from_numpy(noise[:1]), n_steps=1, n_save=2,
                                     device="cpu")
    torch.testing.assert_close(one.mean(dim=2), one_drift.mean(dim=2), rtol=0, atol=1e-6)


@pytest.mark.parametrize("chain_block", [2, 4])
def test_chain_block_on_the_cpu_is_the_plain_version(setup, chain_block):
    """B = 5 is not a multiple of C; on CPU tensors the plain version has
    no blocks, launches nothing and gives the C = 1 result."""
    _jm, _jp, _jt, params, model, template, x0, temps, _key, noise = setup
    kw = dict(g_fn=0.3, n_steps=N_STEPS, n_save=N_SAVE, forward_impl="pair_kernel",
              noise=torch.from_numpy(noise), device="cpu")
    _build.reset_launches()
    blocked = sample_molecular_sde(model, params, template, x0, temps, chain_block=chain_block,
                                   **kw)
    assert sum(_build.LAUNCHES.values()) == 0
    torch.testing.assert_close(blocked, sample_molecular_sde(model, params, template, x0, temps,
                                                             **kw), rtol=0, atol=0)


def test_sde_guards(setup):
    _jm, _jp, _jt, params, model, template, x0, temps, _key, noise = setup
    kw = dict(device="cpu", n_steps=N_STEPS, n_save=N_SAVE)
    with pytest.raises(ValueError, match="forward_impl"):
        sample_molecular_sde(model, params, template, x0, temps, forward_impl="edge",
                             noise=torch.from_numpy(noise), **kw)
    with pytest.raises(ValueError, match="multiple"):
        sample_molecular_sde(model, params, template, x0, temps, n_steps=5, n_save=3,
                             device="cpu")
    with pytest.raises(ValueError, match="chain_block"):
        sample_molecular_sde(model, params, template, x0, temps, forward_impl="pair_kernel",
                             chain_block=0, **kw)
    with pytest.raises(ValueError, match="noise must be"):
        sample_molecular_sde(model, params, template, x0, temps,
                             noise=torch.from_numpy(noise[:2]), **kw)
    with pytest.raises(ValueError, match="generator or explicit noise"):
        sample_molecular_sde(model, params, template, x0, temps, **kw)
    # velocity-only dopri5 runs now, and lands within its tolerance of
    # fine RK4 (bar 1e-4: ten times its atol = rtol = 1e-5)
    v_of = molecular_v_fn_of(model, params, template, device="cpu")
    d5 = make_ode_sampler(v_of, solver="dopri5", return_dlogp=False, device="cpu")(x0, temps)
    rk = make_ode_sampler(v_of, solver="rk4", n_steps=64, return_dlogp=False,
                          device="cpu")(x0, temps)
    np.testing.assert_allclose(d5.xs.numpy(), rk.xs.numpy(), rtol=0, atol=1e-4)
