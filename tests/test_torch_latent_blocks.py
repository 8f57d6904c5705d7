"""The published latent profile on the port and its exact-divergence lane
blocks, against ti_tpu.

``fast_profile(latent_preset(...), family="latent")`` as it stands: bf16,
the dense forward, the exact divergence at GL-8 nodes on the default route,
which ``_config_sampler`` evaluates in the lane blocks of
``exact_lane_block`` (ti_torch/ops/divergence.py). On the CPU the budget is
None (no blocking); the blocked cases force a small one through
``exact_lane_budget``. N = 6 (d = 18 lanes), F = 16, 2 layers, 3 chains, as
tests/test_torch_latent.py's ``SIZE``; JAX's noise is passed as ``noise=``.

Bars:
- bf16 against ti_tpu, or blocked against unblocked in bf16: samples
  within 2e-2 of max |x| and dlogp within 2e-2 of max |dlogp| (the two
  packages round to bf16 at other points, and a rounding that flips moves
  a product by one bf16 ulp, 2^-8, which the 9 RK4 steps carry);
- f32, blocked against unblocked: the samples to the bit (the trajectory
  does not see the divergence) and dlogp rtol 1e-5
  (tests/test_torch_dense_divergence.py's bar for blocked lanes: the same
  JVPs summed in another order);
- f32 against ti_tpu at the same ``div_chunk``: samples rtol 1e-4 / atol
  1e-5, dlogp rtol 1e-3 (tests/test_torch_latent.py's sampling bars).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu.config import MDQM9Config as JaxConfig
from ti_tpu.config import fast_profile as jax_fast_profile
from ti_tpu.config import latent_preset as jax_latent_preset
from ti_tpu.data import mdqm9 as jax_mdqm9
from ti_tpu.sampling import drivers as jax_drivers
from ti_tpu.train.latent import build_latent_model as jax_build_latent_model
from ti_torch.config import MDQM9Config, fast_profile, latent_preset
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.convert import params_from_flax
from ti_torch.ops import divergence as dv
from ti_torch.ops.divergence import exact_lane_block, exact_node_bytes
from ti_torch.sampling import drivers
from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of, sample_latent
from ti_torch.train import build_latent_model

N_ATOMS, F, LAYERS, B = 6, 16, 2, 3
SIZE = dict(n_features=F, score_layers=LAYERS, batch_size=B)
CONDITIONINGS = {"none": [300], "latent": [300, 500, 700]}
BF16_BAR = 2e-2
N_STEPS = 9  # RK4, one step a gap of GL-8
# H100 80GB HBM3: torch.cuda.get_device_properties(0).total_memory
# (tools/latent_memory_probe.py's first line on the card)
H100_TOTAL = 85_017_493_504


def _models(cond):
    Ts = CONDITIONINGS[cond]
    t_cond = 1 if len(Ts) > 1 else 0
    jt = jax_mdqm9.graph_template(jax_mdqm9.make_synthetic_molecule(N_ATOMS, seed=0), t_cond)
    jm = jax_build_latent_model(JaxConfig(**SIZE, T=Ts))
    jp = jm.init(jax.random.PRNGKey(0), jt)
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    model = build_latent_model(MDQM9Config(**SIZE, T=Ts), N_ATOMS)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond)
    return Ts, jm, jp, jt, params, model, template


@pytest.fixture(scope="module", params=list(CONDITIONINGS))
def models(request):
    return _models(request.param)


@pytest.fixture(scope="module")
def models_none():
    return _models("none")


def _published(Ts, tmp=None, jax=False, **over):
    preset, profile = ((jax_latent_preset, jax_fast_profile) if jax
                       else (latent_preset, fast_profile))
    common = dict(**SIZE, sampling_T=500)
    if tmp is not None:
        common["data_save_path"] = str(tmp)
    return profile(preset("00031", Ts=Ts, **common), family="latent", n_steps=N_STEPS, **over)


def _jax_noise(seed, n, bs):
    """The noise ti_tpu's sample_latent draws for n samples in batches of bs."""
    key, out = jax.random.PRNGKey(seed), []
    for i in range(0, n, bs):
        key, zk, _ = jax.random.split(key, 3)
        z = jax.random.normal(zk, (bs, N_ATOMS, 3), dtype=jnp.float32)
        out.append(np.asarray(z - z.mean(axis=1, keepdims=True))[: min(bs, n - i)])
    return np.concatenate(out)


def _close_bf16(a, ref):
    scale = max(float(np.abs(ref).max()), 1e-3)
    np.testing.assert_allclose(a / scale, ref / scale, atol=BF16_BAR)


def _force_block(monkeypatch, k, dtype):
    """Make the card's budget one that ``exact_lane_block`` turns into
    blocks of ``k`` lanes at B chains."""
    budget = int(exact_node_bytes(B, k + 0.5, N_ATOMS, F, dtype))
    monkeypatch.setattr(dv, "exact_lane_budget", lambda device: budget)
    assert exact_lane_block(B, N_ATOMS, F, LAYERS, dtype, budget) == k


# ------------------------------------------------------------ (a) the route

def test_published_route_matches_jax(models, tmp_path):
    """One batch of three chains through ``sample_latent`` under the
    published profile (bf16, default route, GL-8 exact nodes, RK4-9), on
    ti_tpu's noise, against ti_tpu's ``sample_latent``: at one temperature
    (the 00031 preset's conditioning "none") and at several ("latent", the
    all-temperature presets')."""
    Ts, jm, jp, jt, params, model, template = models
    cfg, jcfg = _published(Ts, tmp_path), _published(Ts, jax=True)
    assert (cfg.compute_dtype, cfg.divergence, cfg.dlogp_quad, cfg.dlogp_quad_points,
            cfg.traj_forward_impl, cfg.div_forward_impl) == (
        "bf16", "exact", "gauss", 8, "default", "default")
    assert drivers._exact_div_chunk(cfg, model, template, torch.device("cpu"), B) is None
    ref = jax_drivers.sample_latent(jcfg, jm, jp, jt, n_samples=B, save=False)
    noise = _jax_noise(cfg.seed, B, B)
    out = sample_latent(cfg, model, params, template, n_samples=B, noise=noise, device="cpu")
    assert out["samples"].shape == ref["samples"].shape == (B, 2, N_ATOMS, 3)
    np.testing.assert_array_equal(out["samples"][:, 0], noise)
    _close_bf16(out["samples"], np.asarray(ref["samples"]))
    _close_bf16(out["dlogps"], np.asarray(ref["dlogps"]))
    assert out["nfe"] == ref["nfe"]
    assert np.abs(out["dlogps"]).max() > 1e-2  # the nodes did reach dlogp


# ------------------------------------------------------------ (b) blocked nodes

def _port_sampler(model, params, template, compute_dtype, chunk):
    return make_ode_sampler(
        molecular_v_fn_of(model, params, template, compute_dtype=compute_dtype, device="cpu"),
        solver="rk4", n_steps=N_STEPS, n_save=2, divergence="exact", div_chunk=chunk,
        steps_per_dispatch=25, dlogp_quad_points=8, dlogp_quad="gauss", device="cpu")


@pytest.fixture(scope="module")
def unblocked(models_none):
    """The published route's sampler with every lane at once, in f32 and
    bf16, on one batch of JAX's noise."""
    Ts, jm, jp, jt, params, model, template = models_none
    noise = _jax_noise(7, B, B)
    return noise, {dtype: _port_sampler(model, params, template, cd, None)(
        noise, torch.zeros(B, 0), torch.Generator().manual_seed(0))
        for dtype, cd in (("f32", None), ("bf16", torch.bfloat16))}


@pytest.mark.parametrize("dtype, chunk", [("bf16", 1), ("bf16", 5), ("bf16", 7),
                                          ("f32", 5)])
def test_blocked_nodes_match_unblocked_and_jax(models_none, unblocked, dtype, chunk,
                                               monkeypatch):
    """The published route's sampler with ``div_chunk`` = 1, 5 and 7 lanes
    of 18 (in bf16, the profile's type; 5 in f32 too) against the
    same sampler unblocked, and against ti_tpu's
    ``make_ode_sampler(div_chunk=)`` on the same weights and noise. At 5
    lanes, a block the rule reaches (balanced blocks of 18 lanes are 18, 9,
    6, 5, 4, 3, 2 or 1), ``sample_latent`` under a budget forced to it
    gives that sampler's bits."""
    Ts, jm, jp, jt, params, model, template = models_none
    noise, whole = unblocked[0], unblocked[1][dtype]
    cd = None if dtype == "f32" else torch.bfloat16
    blocked = _port_sampler(model, params, template, cd, chunk)(
        noise, torch.zeros(B, 0), torch.Generator().manual_seed(0))
    xs, dl = blocked.xs.numpy(), blocked.dlogp[:, -1].numpy()
    wxs, wdl = whole.xs.numpy(), whole.dlogp[:, -1].numpy()
    jcfg = _published(Ts, jax=True, compute_dtype=dtype)
    jsampler = jax_drivers.make_ode_sampler(
        jax_drivers.molecular_v_fn_of(jm, jp, jt, compute_dtype=jax_drivers._compute_dtype(jcfg)),
        solver="rk4", n_steps=N_STEPS, n_save=2, divergence="exact", div_chunk=chunk,
        steps_per_dispatch=25, dlogp_quad_points=8, dlogp_quad="gauss")
    ref = jsampler(jnp.asarray(noise), jnp.zeros((B, 0)), jax.random.PRNGKey(0))
    rxs, rdl = np.asarray(ref.xs), np.asarray(ref.dlogp[:, -1])
    if dtype == "f32":
        np.testing.assert_array_equal(xs, wxs)
        np.testing.assert_allclose(dl, wdl, rtol=1e-5)
        np.testing.assert_allclose(xs, rxs, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(dl, rdl, rtol=1e-3)
    else:
        _close_bf16(xs, wxs)
        _close_bf16(dl, wdl)
        _close_bf16(xs, rxs)
        _close_bf16(dl, rdl)
    if chunk == 5:
        cfg = _published(Ts, compute_dtype=dtype)
        _force_block(monkeypatch, chunk, cfg.compute_dtype)
        assert drivers._exact_div_chunk(cfg, model, template, torch.device("cpu"), B) == chunk
        out = sample_latent(cfg, model, params, template, noise=noise, save=False, device="cpu")
        np.testing.assert_array_equal(out["samples"], xs)
        np.testing.assert_array_equal(out["dlogps"], dl)


# ------------------------------------------------------------ (c) stage-coupled

def test_stage_coupled_route_blocked_matches_unblocked(models_none, monkeypatch):
    """``latent_preset`` without ``fast_profile`` on RK4 (f32, the exact
    divergence inside every stage) in blocks of 5 lanes against all 18 at
    once."""
    Ts, jm, jp, jt, params, model, template = models_none
    cfg = latent_preset("00031", Ts=Ts, **SIZE, sampling_T=500, solver_type="rk4", n_steps=4,
                        divergence="exact")
    noise = _jax_noise(11, B, B)
    whole = sample_latent(cfg, model, params, template, noise=noise, save=False, device="cpu")
    _force_block(monkeypatch, 5, cfg.compute_dtype)
    blocked = sample_latent(cfg, model, params, template, noise=noise, save=False,
                            device="cpu")
    np.testing.assert_array_equal(blocked["samples"], whole["samples"])
    np.testing.assert_allclose(blocked["dlogps"], whole["dlogps"], rtol=1e-5)
    assert np.abs(whole["dlogps"]).max() > 1e-2


# ------------------------------------------------------------ (d) the rule

def test_exact_lane_block_rule():
    """None where every lane fits or no budget is given; otherwise balanced
    blocks of at least one lane, the largest that fit; the same answer on
    every call; and at the published presets' 256 chains on an 80 GB H100
    the blocks PERF.md states."""
    assert exact_lane_block(B, N_ATOMS, F, LAYERS, "bf16", None) is None
    assert exact_lane_block(B, N_ATOMS, F, LAYERS, "bf16", 10 ** 12) is None
    assert dv.exact_lane_budget("cpu") is None
    for n_atoms in (2, 6, 19, 29):
        d = 3 * n_atoms
        one = exact_node_bytes(8, 1, n_atoms, 64, "bf16")
        seen = set()
        for budget in np.linspace(0, 1.2 * exact_node_bytes(8, d, n_atoms, 64, "bf16"), 97):
            k = exact_lane_block(8, n_atoms, 64, 3, "bf16", int(budget))
            assert k == exact_lane_block(8, n_atoms, 64, 3, "bf16", int(budget))
            if k is None:
                assert exact_node_bytes(8, d, n_atoms, 64, "bf16") <= budget
                continue
            blocks = -(-d // k)
            assert 1 <= k < d and k == -(-d // blocks)  # balanced: ceil(d / ceil(d / k))
            assert exact_node_bytes(8, k, n_atoms, 64, "bf16") <= max(budget, one)
            seen.add(k)
        assert seen and min(seen) == 1
    # f32 counts twice the bytes of bf16: where bf16 fits 10.5 lanes, f32 fits
    # (chain + 10.5 lane) / 2 - chain = 4.9 lanes, so 5 blocks of 4
    budget = int(exact_node_bytes(B, 10.5, N_ATOMS, F, "bf16"))
    assert exact_lane_block(B, N_ATOMS, F, LAYERS, "bf16", budget) == 9
    assert exact_lane_block(B, N_ATOMS, F, LAYERS, None, budget) == 4
    budget = int(dv.EXACT_LANE_SHARE * H100_TOTAL)
    got = {mol: exact_lane_block(256, n, f, 5, "bf16", budget)
           for mol, n, f in (("00031", 19, 128), ("10506", 29, 256))}
    assert got == {"00031": 29, "10506": 6}  # 2 blocks of 57 lanes, 15 of 87 (PERF.md §6)
    assert exact_lane_block(8, 29, 256, 5, "bf16", budget) is None  # the smoke's 8-chain node


def test_exact_div_chunk_only_on_the_dense_exact_route(models_none, monkeypatch):
    """The block reaches the sampler only for the exact divergence through
    the dense forward: not for Hutchinson, not through ``div_drift``, not
    without dlogp; the batch defaults to the config's."""
    Ts, jm, jp, jt, params, model, template = models_none
    cpu = torch.device("cpu")
    cfg = _published(Ts)
    _force_block(monkeypatch, 5, cfg.compute_dtype)
    assert drivers._exact_div_chunk(cfg, model, template, cpu, B) == 5
    for over in (dict(divergence="hutchinson"), dict(return_dlogp=False),
                 dict(div_forward_impl="pair_tangent", compute_dtype="f32")):
        assert drivers._exact_div_chunk(_published(Ts, **over), model, template, cpu, B) is None
    seen = {}
    real = drivers.make_ode_sampler
    monkeypatch.setattr(drivers, "make_ode_sampler",
                        lambda *a, **kw: seen.update(kw) or real(*a, **kw))
    drivers._config_sampler(cfg, model, params, template, cpu)
    assert seen["div_chunk"] == 5  # batch None: cfg.batch_size = B
