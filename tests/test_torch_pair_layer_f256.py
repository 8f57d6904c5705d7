"""Kernel B1 in bf16_agg at F = 256 (library pair_layer_mma_f256, built from
csrc/pair_layer_mma.cu with -DPK_F=256), as far as the CPU reaches it, and
the path ``ti_tpu`` runs through it: ``sample_ambient`` under
``fast_profile(ambient_preset("10506"))``.

- The route table at F = 256: bf16_agg on the tensor cores takes the new
  library for every chain block; f32 (``pair_layer_tf32x3``), ``variant=
  "fma"`` (``pair_layer``), B3's libraries and B4-B7 refuse the width, each
  naming the route that takes it.
- The plain bf16_agg forward at F = 256 (the kernel's yardstick on the
  card) against ``ti_tpu``'s Pallas kernel in interpret mode on weights
  carried across by ``params_from_flax``: atol 4e-2 of max |ref|, the
  bf16_agg bar of tests/test_torch_pair_layer.py.
- ``sample_ambient`` under the 10506 fast profile, cut to 6 atoms, F = 256,
  2 layers, 3 chains and ``n_steps=9`` (one RK4 step a Gauss gap: 9 steps
  where the profile's 16 take 18; the JAX side runs the Pallas kernel in
  interpret mode), against ``ti_tpu``'s: the routes in both packages, the
  samples, and the dlogps with ``ti_tpu``'s Rademacher draws. The sampler
  takes no probes; they are pinned one level below ``make_ode_sampler``, at
  the ``probes=`` of ``integrators.node_divergences``, which the segmented
  Gauss sampler calls for its nodes (the test wraps the drivers module's
  reference to it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu.config import ambient_preset as jax_preset
from ti_tpu.config import fast_profile as jax_fast_profile
from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.ops.divergence import _probe_block as jax_probe_block
from ti_tpu.ops.pair_layer_kernel import apply_dense_pair_kernel as jax_pair_kernel
from ti_tpu.sampling.drivers import sample_ambient as jax_sample_ambient
from ti_torch.config import ambient_preset, fast_profile
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.convert import params_from_flax
from ti_torch.models.cpainn import CPaiNN
from ti_torch.ops import _build
from ti_torch.ops import pair_layer_kernel as plk
from ti_torch.ops import pair_tangent_kernel as ptk
from ti_torch.ops.mlp_block import BF16, MLPWeights
from ti_torch.sampling import drivers

F256 = 256
N_ATOMS, LAYERS, B = 6, 2, 3
SIZE = dict(n_features=F256, score_layers=LAYERS, batch_size=B)
STEPS = dict(n_steps=9)


def _weights(f: int, dtype, seed: int = 0):
    rng = np.random.default_rng(seed)

    def mlp(f_in):
        def t(*shape):
            return torch.as_tensor(rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[0]))

        return MLPWeights(t(f_in, f), t(f), 1 + 0.1 * t(f), t(f), t(f, f), t(f), 1 + 0.1 * t(f), t(f),
                          t(f, 5 * f), t(5 * f))

    return plk.with_mma_weights(plk.pack_pair_mlps(mlp(2 * f), mlp(f), dtype, "cpu"))


def _inputs(dtype, f=F256, n=5, b=2, seed=3):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dt=dtype):
        return torch.as_tensor((scale * rng.standard_normal(shape)).astype(np.float32)).to(dt)

    return (t(b, n, 3, scale=0.3, dt=torch.float32), t(b, n, f), t(b, 3, n, f, scale=0.3),
            t(b, n * n, f))


@pytest.mark.parametrize("bf16,chain_block,variant,lib", [
    (True, 1, None, "pair_layer_mma_f256"), (True, 1, "tc", "pair_layer_mma_f256"),
    (True, 2, None, "pair_layer_mma_f256"), (True, 4, "tc", "pair_layer_mma_f256"),
    (True, 8, None, "pair_layer_mma_f256"),
    (True, 1, "fma", "pair_layer"), (True, 4, "fma", "pair_layer"),
    (False, 1, None, "pair_layer_tf32x3"), (False, 4, "tc", "pair_layer_tf32x3"),
    (False, 1, "fma", "pair_layer"),
])
def test_route_table_at_f256(bf16, chain_block, variant, lib):
    """At F = 256 bf16_agg on the tensor cores takes pair_layer_mma_f256 for
    every chain block, and its input check passes; f32 and ``variant="fma"``
    route as at F = 128 and their launch check refuses the width, naming
    the route that takes it."""
    assert plk._route(bf16, chain_block, variant, F256) == lib
    dtype = BF16 if bf16 else torch.float32
    args = (*_inputs(dtype), _weights(F256, dtype))
    if lib == "pair_layer_mma_f256":
        assert plk._check_pair_inputs(*args, lib) == (2, 5, F256, dtype)
        assert plk.LIB_WIDTHS[lib] == F256
        return
    with pytest.raises(ValueError, match=f"{lib} is built for F=128, got F=256; F = 256 runs "
                                         "only in B1 and B2 in bf16_agg on the tensor cores"):
        plk._check_pair_inputs(*args, lib)


@pytest.mark.parametrize("bf16,variant,lib", [
    (True, "mma", "pair_tangent_mma"), (False, "mma", "pair_tangent_tf32x3"),
    (False, "fma", "pair_tangent"),
])
def test_b3_refuses_f256(bf16, variant, lib):
    """B3's libraries are built at F = 128 only: the check its launch makes
    refuses F = 256 and names the route that takes it."""
    assert ptk._route(bf16, variant) == lib
    dtype = BF16 if bf16 else torch.float32
    with pytest.raises(ValueError, match="got F=256; F = 256 runs only in B1 and B2 in bf16_agg"):
        plk._check_pair_inputs(*_inputs(dtype), _weights(F256, dtype), lib)


@pytest.mark.parametrize("what", ["fused_edge_mlp_tf32x3", "fused_edge_mlp_jvp_tf32x3",
                                  "kernel B7"])
def test_b4_b5_b7_width_check_refuses_f256(what):
    """The width check B4, B5 and B7 make before they launch: F = 128 passes,
    F = 256 raises with the route that takes it (B6's own check is held on
    the card, tests/test_torch_gpu.py)."""
    plk.check_width(128, what)
    with pytest.raises(ValueError, match=f"{what} is built for F=128, got F=256; F = 256 runs"):
        plk.check_width(F256, what)


@pytest.mark.parametrize("chain_block", [1, 4])
def test_cpu_tensors_take_the_plain_version_at_f256(chain_block):
    """On the CPU B1 at F = 256 is the plain version, bit for bit, and no
    kernel is launched or built."""
    base = _inputs(BF16)
    wts = _weights(F256, BF16)
    before, by_route = dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES)
    out = plk.pair_layer(*base, wts, 10.0, chain_block)
    ref = plk.pair_layer_plain(*base, wts, 10.0)
    assert _build.LAUNCHES == before and _build.ROUTE_LAUNCHES == by_route
    for a, r in zip(out, ref):
        assert a.dtype == r.dtype and torch.equal(a, r)


@pytest.fixture(scope="module")
def setup():
    jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=2)
    jm = JaxCPaiNN(n_features=F256, score_layers=LAYERS, conditioning="ambient")
    jp = jm.init(jax.random.PRNGKey(0), jt)
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    model = CPaiNN(F256, LAYERS, n_atoms=N_ATOMS)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2)
    rng = np.random.default_rng(1)
    x0 = (0.1 * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    x0 -= x0.mean(axis=1, keepdims=True)
    return jm, jp, jt, params, model, template, x0


def test_plain_bf16_agg_forward_matches_jax_at_f256(setup):
    """``apply_dense_pair_kernel`` in bf16_agg at F = 256 (the plain version,
    the CPU's route) against ``ti_tpu``'s bf16 Pallas kernel in interpret
    mode: atol 4e-2 of max |ref|."""
    jm, jp, jt, params, model, template, x = setup
    x = 3.0 * x
    t = np.array([0.2, 0.5, 0.9], np.float32)
    temps = np.tile(np.array([700.0, 300.0], np.float32), (B, 1))
    ref = np.asarray(jax_pair_kernel(jm, jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps),
                                     jt.atom_ids, jt.edges, interpret=True,
                                     compute_dtype="bf16_agg"))
    pm = plk.prepare(model, params, template, "bf16_agg", torch.device("cpu"))
    assert all(w.mma is not None and w.mats.numel() == 15 * F256 ** 2 for w in pm.layers)
    out = plk.apply_dense_pair_kernel(pm, torch.from_numpy(x), torch.from_numpy(t),
                                      torch.from_numpy(temps)).numpy()
    assert out.shape == (B, N_ATOMS, 3) and np.isfinite(out).all()
    scale = max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(out / scale, ref / scale, atol=4e-2)


def _jax_node_probes(seed: int, b: int, k: int, d: int):
    """``ti_tpu``'s Rademacher draws at Gauss node i of its first batch:
    chain c's key is split(fold_in(split(PRNGKey(seed))[1], 10_000), b)[c],
    node i draws from fold_in(that key, i) (ti_tpu/sampling/drivers.py,
    sample_ambient and _gauss_dlogp_sampler)."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    keys = jax.random.split(jax.random.fold_in(sub, 10_000), b)

    def probes(i):
        zs, ws = zip(*(jax_probe_block(jax.random.fold_in(key, i), k, d, jnp.float32, "rademacher")
                       for key in keys))
        return torch.from_numpy(np.stack(zs)), torch.from_numpy(np.stack(ws))

    return probes


# (profile overrides, route, samples atol, dlogp rtol, dlogp atol)
PROFILES = {
    "bf16_agg": ({}, ("pair_kernel_bf16", "bf16_agg"), 1e-2, 0.0, 1.0),
    "f32": (dict(compute_dtype="f32", traj_forward_impl="pair_kernel"), ("pair_kernel", "f32"),
            1e-5, 1e-3, 1e-3),
}


@pytest.mark.parametrize("profile", list(PROFILES))
def test_sample_ambient_10506_fast_profile_matches_jax(setup, monkeypatch, profile):
    """The 10506 profile at F = 256 (RK4 + GL-8, Hutchinson-32 Rademacher,
    bf16_agg, B1 in bf16_agg on the trajectory, the default divergence
    forward at the nodes) in both packages, on ``ti_tpu``'s probes; and the
    same in f32 (B1 in f32), where only summation orders differ.

    Bars, measured on this case. f32: samples within 1.7e-6 and dlogps
    within 3.2e-4 of ``ti_tpu``'s (|dlogp| up to 7.3), so the probes are
    pinned: samples atol 1e-5, dlogp rtol 1e-3 / atol 1e-3. bf16_agg: samples
    within 5.5e-3 (|x| up to 0.32) and dlogps within 0.55 (|dlogp| up to
    8.1). That is rounding of a strong field (flax's initialisation): in
    each package the bf16_agg samples lie 1.3e-2 (port) and 1.7e-2
    (``ti_tpu``) from its f32 ones, and the same probes put the bf16_agg
    dlogps up to 4.9 from the f32 ones. Bars: samples atol 1e-2, dlogp atol
    1.0."""
    over, (traj, dtype), x_atol, d_rtol, d_atol = PROFILES[profile]
    jm, jp, jt, params, model, template, x0 = setup
    cfg = fast_profile(ambient_preset("10506", **SIZE), **STEPS, **over)
    jcfg = jax_fast_profile(jax_preset("10506", **SIZE), **STEPS, **over)
    route = (traj, "default", "hutchinson", 32, "rademacher", dtype, 9)
    for c in (cfg, jcfg):
        assert (c.traj_forward_impl, c.div_forward_impl, c.divergence, c.num_probes,
                c.probe_mode, c.compute_dtype, c.n_steps) == route
    ref = jax_sample_ambient(jcfg, jm, jp, jt, x0, save=False)
    probes = _jax_node_probes(cfg.seed, B, cfg.num_probes, 3 * N_ATOMS)
    real = drivers.node_divergences
    pinned = []

    def node_divergences(*args, **kw):
        pinned.append(kw.get("probes"))
        return real(*args, **{**kw, "probes": probes})

    monkeypatch.setattr(drivers, "node_divergences", node_divergences)
    out = drivers.sample_ambient(cfg, model, params, template, x0, save=False, device="cpu")
    assert pinned == [None]  # one call for the batch's 8 nodes, which the test pins
    assert out["samples"].shape == ref["samples"].shape == (B, 2, N_ATOMS, 3)
    assert np.isfinite(out["samples"]).all() and np.isfinite(out["dlogps"]).all()
    np.testing.assert_allclose(out["samples"], ref["samples"], rtol=0, atol=x_atol)
    np.testing.assert_allclose(out["dlogps"], ref["dlogps"], rtol=d_rtol, atol=d_atol)
    assert out["nfe"] == ref["nfe"]
