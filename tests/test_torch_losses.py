"""The port's velocity losses (ti_torch/losses.py) against ti_tpu's: value
and gradients with the draws pinned.

The same weights (a flax ``CPaiNN.init`` carried across with
``params_from_flax``) and the same numpy inputs, t and z go through
``jax.value_and_grad`` of ti_tpu's loss and ``torch.autograd.grad`` of the
port's; the flax gradient tree maps onto the state dict as the weights do.
Bars:
- f64 (the edge form, ``jax.enable_x64``): loss rtol 1e-5, gradients rtol
  1e-4 / atol 1e-6 elementwise;
- f32 (the edge form against ti_tpu's vmapped ``model.apply``, the dense
  form against its ``apply_dense``): loss rtol 1e-5, gradients rtol 1e-4
  with atol 1e-5 of the leaf's largest |gradient|. Against the f64
  gradient each package is 1.7e-6 to 2.8e-6 of that off in f32 (the
  leaves reach |g| ~ 1 here), so an absolute 1e-6 would hold rounding, not
  the port;
- bf16_agg: loss within 2e-2 relative, and the whole gradient, as one
  vector, within 2e-2 of its largest |entry| (the bf16_agg forward bar).
  Leaf by leaf, both packages' bf16_agg gradients are 6% to 17% of the
  leaf's largest entry away from the f64 gradient: the cotangents round
  to bf16 where the forward does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu import interpolants as jax_interp
from ti_tpu.config import MDQM9Config as JaxConfig
from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.losses import adw_velocity_loss as jax_adw_loss
from ti_tpu.losses import molecular_velocity_loss as jax_loss
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.train.common import make_batched_apply as jax_batched_apply
from ti_torch import interpolants
from ti_torch.config import MDQM9Config
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.losses import adw_velocity_loss, molecular_velocity_loss
from ti_torch.models.convert import _flatten, _leaf_to_torch, params_from_flax
from ti_torch.models.cpainn import CPaiNN
from ti_torch.train.common import make_batched_apply

N_ATOMS, F, LAYERS, B = 5, 16, 2, 4
LOSS_BAR = dict(rtol=1e-5, atol=0)
GRAD_BAR = dict(rtol=1e-4, atol=1e-6)
F32_GRAD_RTOL, F32_GRAD_ATOL = 1e-4, 1e-5  # atol: of the leaf's largest |gradient|
AGG_BAR = 2e-2
PROFILES = [("edge", "f32"), ("dense", "f32"), ("dense", "bf16_agg")]


def _setup():
    jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=2)
    jm = JaxCPaiNN(n_features=F, score_layers=LAYERS, conditioning="ambient")
    jp = jm.init(jax.random.PRNGKey(0), jt)
    model = CPaiNN(F, LAYERS, n_atoms=N_ATOMS)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2)
    return jm, jp, jt, model, template


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    x0 = (0.5 * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    x1 = (0.3 * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    x0 -= x0.mean(axis=1, keepdims=True)
    x1 -= x1.mean(axis=1, keepdims=True)
    temps = np.array([[1000.0, 300.0], [300.0, 1000.0], [700.0, 400.0], [500.0, 500.0]],
                     np.float32)
    t = rng.uniform(0.05, 0.95, size=B).astype(np.float32)
    z = rng.standard_normal((B, N_ATOMS, 3)).astype(np.float32)
    return x0, x1, temps, t, z


def _state_names(tree):
    """flax tree -> {state-dict name: numpy array in the port's layout},
    keeping the leaves' dtype."""
    out = {}
    for path, arr in _flatten(tree["params"]):
        name, _ = _leaf_to_torch(path, np.zeros(0))
        arr = np.asarray(arr)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr.T if path[-1] == "kernel" else arr))
    return out


def _jax_value_and_grad(jm, jp, jt, impl, dtype, interp, batch):
    x0, x1, temps, t, z = map(jnp.asarray, batch)
    cfg = JaxConfig(train_impl=impl, train_compute_dtype=dtype)
    bapply = jax_batched_apply(cfg, jm, jt)

    def loss(p):
        return jax_loss(jm.apply, p, jax.random.PRNGKey(0), jt, x0, x1, temps, interp,
                        batched_apply_fn=bapply, t=t, z=z)

    val, grads = jax.value_and_grad(loss)(jp)
    return float(val), _state_names(grads)


def _torch_value_and_grad(model, params, template, impl, dtype, interp, batch, remat=False):
    x0, x1, temps, t, z = map(torch.from_numpy, batch)
    apply = make_batched_apply(MDQM9Config(train_impl=impl, train_compute_dtype=dtype),
                               model, template)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = molecular_velocity_loss(apply, leaves, x0, x1, temps, interp, t=t, z=z, remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.item(), dict(zip(leaves, grads))


def _assert_grads(grads, ref, dtype):
    assert set(grads) == set(ref)
    for k, g in grads.items():
        assert g.dtype == ref[k].dtype and np.isfinite(g.numpy()).all(), k
    if dtype == "bf16_agg":
        flat = torch.cat([grads[k].ravel() for k in sorted(ref)])
        flat_ref = torch.cat([ref[k].ravel() for k in sorted(ref)])
        assert float((flat - flat_ref).abs().max()) <= AGG_BAR * float(flat_ref.abs().max())
        return
    for k, g in grads.items():
        r = ref[k].numpy()
        bar = GRAD_BAR if dtype == "f64" else dict(
            rtol=F32_GRAD_RTOL, atol=F32_GRAD_ATOL * float(np.abs(r).max()))
        np.testing.assert_allclose(g.numpy(), r, **bar, err_msg=k)


@pytest.mark.parametrize("impl,dtype", PROFILES)
@pytest.mark.parametrize("gamma", ["brownian", "sin2"])
def test_molecular_loss_and_grads_match_jax(impl, dtype, gamma):
    jm, jp, jt, model, template = _setup()
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    batch = _batch()
    ref_val, ref_grads = _jax_value_and_grad(jm, jp, jt, impl, dtype,
                                             jax_interp.linear(a=0.1, gamma=gamma), batch)
    val, grads = _torch_value_and_grad(model, params, template, impl, dtype,
                                       interpolants.linear(a=0.1, gamma=gamma), batch)
    if dtype == "bf16_agg":
        assert abs(val - ref_val) <= AGG_BAR * abs(ref_val)
    else:
        np.testing.assert_allclose(val, ref_val, **LOSS_BAR)
    _assert_grads(grads, ref_grads, dtype)


@pytest.mark.parametrize("gamma", ["brownian", "sin2"])
def test_molecular_loss_and_grads_match_jax_in_f64(gamma):
    """The edge form in f64 on both sides, at the f64 bars."""
    jm, jp, jt, model, template = _setup()
    batch = tuple(a.astype(np.float64) for a in _batch())
    with jax.enable_x64(True):
        jp64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), jp)
        params = _state_names(jp64)
        ref_val, ref_grads = _jax_value_and_grad(jm, jp64, jt, "edge", "f32",
                                                 jax_interp.linear(a=0.1, gamma=gamma), batch)
    val, grads = _torch_value_and_grad(model.double(), params, template, "edge", "f32",
                                       interpolants.linear(a=0.1, gamma=gamma), batch)
    np.testing.assert_allclose(val, ref_val, **LOSS_BAR)
    assert all(g.dtype == torch.float64 for g in grads.values())
    _assert_grads(grads, ref_grads, "f64")


def test_one_sided_loss_matches_jax():
    jm, jp, jt, model, template = _setup()
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    batch = _batch(2)
    ref_val, ref_grads = _jax_value_and_grad(jm, jp, jt, "edge", "f32",
                                             jax_interp.one_sided_linear(), batch)
    val, grads = _torch_value_and_grad(model, params, template, "edge", "f32",
                                       interpolants.one_sided_linear(), batch)
    np.testing.assert_allclose(val, ref_val, **LOSS_BAR)
    _assert_grads(grads, ref_grads, "f32")


def test_remat_changes_nothing():
    _, jp, _, model, template = _setup()
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    batch = _batch(3)
    interp = interpolants.linear(a=0.1, gamma="brownian")
    val, grads = _torch_value_and_grad(model, params, template, "dense", "f32", interp, batch)
    val_r, grads_r = _torch_value_and_grad(model, params, template, "dense", "f32", interp, batch,
                                           remat=True)
    assert val_r == val
    for k in grads:
        torch.testing.assert_close(grads_r[k], grads[k], rtol=0, atol=0)


def test_draws_are_per_molecule_and_centred_over_the_batch():
    """t is one draw a molecule, shared by its atoms; the pair x_t^± shares
    one z; x_t^± is centred over all atoms of the batch, not per molecule."""
    seen = []

    def apply(params, x, t, temps):
        seen.append((x.clone(), t.clone()))
        return torch.zeros_like(x)

    interp = interpolants.linear(a=1.0, gamma="brownian")
    x0, x1, temps, _, _ = map(torch.from_numpy, _batch(4))
    x1 = x1 + torch.arange(B, dtype=torch.float32)[:, None, None]  # per-molecule offsets
    gen = torch.Generator().manual_seed(0)
    molecular_velocity_loss(apply, None, x0, x1, temps, interp, generator=gen)
    (xp, tp), (xm, tm) = seen
    assert tp.shape == (B,) and torch.equal(tp, tm)
    torch.testing.assert_close(xp.reshape(-1, 3).mean(0), torch.zeros(3), atol=1e-6, rtol=0)
    assert float(xp.mean(dim=1).abs().max()) > 0.1  # not centred per molecule
    # the same generator state gives the same t, then z
    gen = torch.Generator().manual_seed(0)
    t = torch.rand(B, generator=gen)
    z = torch.randn(x0.shape, generator=gen)
    torch.testing.assert_close(tp, t)
    it = interp.It(t[:, None, None], x0, x1)
    g = interp.gamma(t[:, None, None])
    expect = it + g * z
    torch.testing.assert_close(xp, expect - expect.reshape(-1, 3).mean(0))
    expect_m = it - g * z
    torch.testing.assert_close(xm, expect_m - expect_m.reshape(-1, 3).mean(0))


def _adw_weights(d=2, h=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": (0.5 * rng.standard_normal((d + 3, h))).astype(np.float32),
            "b1": (0.1 * rng.standard_normal(h)).astype(np.float32),
            "w2": (0.5 * rng.standard_normal((h, d))).astype(np.float32)}


def test_adw_loss_and_grads_match_jax():
    """A small tanh MLP of (x, t, beta0, beta1), the same in both packages."""
    rng = np.random.default_rng(5)
    b, d = 6, 2
    x0, x1 = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(2))
    beta0 = np.full((b, 1), 1.0, np.float32)
    beta1 = np.full((b, 1), 1.25, np.float32)
    t = rng.uniform(0.05, 0.95, size=(b, 1)).astype(np.float32)
    z = rng.standard_normal((b, d)).astype(np.float32)
    w = _adw_weights(d)

    def jax_apply(p, x, tt, b0, b1):
        h = jnp.tanh(jnp.concatenate([x, tt, b0, b1], -1) @ p["w1"] + p["b1"])
        return h @ p["w2"]

    def torch_apply(p, x, tt, b0, b1):
        h = torch.tanh(torch.cat([x, tt, b0, b1], -1) @ p["w1"] + p["b1"])
        return h @ p["w2"]

    ji = jax_interp.linear(a=0.9, gamma="brownian")
    ref_val, ref_g = jax.value_and_grad(lambda p: jax_adw_loss(
        jax_apply, p, jax.random.PRNGKey(0), *map(jnp.asarray, (x0, x1, beta0, beta1)), ji,
        t=jnp.asarray(t), z=jnp.asarray(z)))({k: jnp.asarray(v) for k, v in w.items()})
    leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    val = adw_velocity_loss(torch_apply, leaves, *map(torch.from_numpy, (x0, x1, beta0, beta1)),
                            interpolants.linear(a=0.9, gamma="brownian"),
                            t=torch.from_numpy(t), z=torch.from_numpy(z))
    grads = torch.autograd.grad(val, list(leaves.values()))
    np.testing.assert_allclose(float(val), float(ref_val), **LOSS_BAR)
    for k, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_g[k]), **GRAD_BAR, err_msg=k)
    # unpinned: the draws come from the generator, reproducibly
    args = (torch_apply, leaves, *map(torch.from_numpy, (x0, x1, beta0, beta1)),
            interpolants.linear(a=0.9, gamma="brownian"))
    a = adw_velocity_loss(*args, generator=torch.Generator().manual_seed(1))
    c = adw_velocity_loss(*args, generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(a) and float(a) == float(c)
