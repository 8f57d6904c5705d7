"""The port's main path as a whole: ``sample_ambient`` under
``fast_profile`` against the JAX package on the same weights and x0.

With ``divergence="exact"`` the pair-tangent route runs the full
orthogonal frame, which makes dlogp exact whatever the probe draw, so the
two packages must agree: samples rtol 1e-4 / atol 1e-5, dlogp rtol 1e-3.
The unmodified profile (orthogonal-16 Hutchinson, bf16_agg divergence)
draws other probes in each package: its samples must still match (the
trajectory does not depend on the probes) and its dlogp be finite.
"""

import jax
import numpy as np
import pytest
import torch

from ti_tpu.config import ambient_preset as jax_preset
from ti_tpu.config import fast_profile as jax_fast_profile
from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.sampling.drivers import sample_ambient as jax_sample_ambient
from ti_torch.config import ambient_preset, fast_profile
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.convert import params_from_flax
from ti_torch.models.cpainn import CPaiNN
from ti_torch.ops.pair_tangent_kernel import pair_tangent_div_fn
from ti_torch.models.cpainn_fused import fused_velocity_fn
from ti_torch.sampling.drivers import (
    make_ode_sampler,
    molecular_v_fn_of,
    sample_ambient,
    sample_molecular_sde,
)

N_ATOMS, F, LAYERS, B = 6, 16, 2, 3
SIZE = dict(n_features=F, score_layers=LAYERS, batch_size=B)


@pytest.fixture(scope="module")
def setup():
    jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=2)
    jm = JaxCPaiNN(n_features=F, score_layers=LAYERS, conditioning="ambient")
    jp = jm.init(jax.random.PRNGKey(0), jt)
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    model = CPaiNN(F, LAYERS, n_atoms=N_ATOMS)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2)
    rng = np.random.default_rng(1)
    x0 = (0.1 * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    x0 -= x0.mean(axis=1, keepdims=True)
    return jm, jp, jt, params, model, template, x0


def test_exact_slice_matches_jax(setup):
    jm, jp, jt, params, model, template, x0 = setup
    over = dict(divergence="exact", div_forward_impl="pair_tangent")
    ref = jax_sample_ambient(jax_fast_profile(jax_preset("00031", **SIZE), **over),
                             jm, jp, jt, x0, save=False)
    out = sample_ambient(fast_profile(ambient_preset("00031", **SIZE), **over),
                         model, params, template, x0, save=False, device="cpu")
    assert out["samples"].shape == ref["samples"].shape == (B, 2, N_ATOMS, 3)
    np.testing.assert_allclose(out["samples"], ref["samples"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["dlogps"], ref["dlogps"], rtol=1e-3)
    assert out["nfe"] == ref["nfe"]


def test_reference_route_matches_jax(setup, tmp_path):
    """The preset's own route, the reference's algorithm: dopri5 at atol =
    rtol = 1e-5 with the exact divergence integrated inside every stage
    (n_steps=5, so 5 save points instead of 100, keeps the JAX side's
    compile short). Both packages hold each step's error below the
    tolerance but take different steps: ti_tpu forms the error of the first
    steps, far below atol, as the difference of two f32 solutions, which is
    their rounding, where the port forms it directly (in f64 the steps
    agree chain by chain,
    tests/test_torch_integrators.py::test_dopri5_nfe_matches_jax_in_f64).
    So the bars are the solver's, not rounding's: samples atol 1e-4 (ten
    times atol) and dlogp rtol 1e-3 / atol 1e-3, against ti_tpu and against
    stage-coupled RK4 at 64 steps. The artifacts are those of the
    fast_profile route."""
    jm, jp, jt, params, model, template, x0 = setup
    cfg = ambient_preset("00031", **SIZE, n_steps=5, data_save_path=str(tmp_path))
    assert (cfg.solver_type, cfg.dlogp_quad_points, cfg.divergence, cfg.atol, cfg.rtol,
            cfg.steps_per_dispatch) == ("dopri5", 0, "exact", 1e-5, 1e-5, 0)
    ref = jax_sample_ambient(jax_preset("00031", **SIZE, n_steps=5), jm, jp, jt, x0, save=False)
    out = sample_ambient(cfg, model, params, template, x0, save=True, device="cpu")
    assert out["samples"].shape == ref["samples"].shape == (B, 5, N_ATOMS, 3)
    per_chain = out["nfe_per_chain"]
    assert per_chain.shape == (B,) and out["nfe"] == per_chain.max()
    assert (per_chain >= 7 * 4).all() and (per_chain % 7 == 0).all()
    np.testing.assert_allclose(out["samples"], ref["samples"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["dlogps"], ref["dlogps"], rtol=1e-3, atol=1e-3)
    temps = np.tile(np.array([1000.0, 300.0], np.float32), (B, 1))
    fine = make_ode_sampler(molecular_v_fn_of(model, params, template, device="cpu"),
                            solver="rk4", n_steps=64, n_save=5, device="cpu")(x0, temps)
    np.testing.assert_allclose(out["samples"], fine.xs.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["dlogps"], fine.dlogp[:, -1].numpy(), rtol=1e-3, atol=1e-3)
    name = cfg.data_save_name
    for stem in ("samples", "dlogps", "latent_noises", "latent_dlogps"):
        assert (tmp_path / f"{stem}_{name}.npy").exists()


def test_fast_profile_route_matches_jax_samples(setup):
    jm, jp, jt, params, model, template, x0 = setup
    cfg = fast_profile(ambient_preset("00031", **SIZE))
    assert (cfg.traj_forward_impl, cfg.div_forward_impl) == ("pair_kernel", "pair_tangent_bf16")
    ref = jax_sample_ambient(jax_fast_profile(jax_preset("00031", **SIZE)),
                             jm, jp, jt, x0, save=False)
    out = sample_ambient(cfg, model, params, template, x0, save=False, device="cpu")
    np.testing.assert_allclose(out["samples"], ref["samples"], rtol=1e-4, atol=1e-5)
    assert np.all(np.isfinite(out["dlogps"]))
    assert "dlogp_vars" not in out


def test_return_dlogp_var_with_pair_tangent(setup, tmp_path):
    """The combination that crashes in the JAX package (its _div_drift_of
    drops return_var): here it returns dlogp_vars, 0 at the full
    orthogonal frame K = 3N, and saves them with the other artifacts."""
    _jm, _jp, _jt, params, model, template, x0 = setup
    cfg = fast_profile(ambient_preset("00031", **SIZE), num_probes=3 * N_ATOMS,
                       div_forward_impl="pair_tangent", return_dlogp_var=True,
                       data_save_path=str(tmp_path))
    out = sample_ambient(cfg, model, params, template, x0, save=True, device="cpu")
    np.testing.assert_allclose(out["dlogp_vars"], 0.0, atol=1e-10)
    name = cfg.data_save_name
    for stem in ("samples", "dlogps", "latent_noises", "latent_dlogps", "dlogp_vars"):
        assert (tmp_path / f"{stem}_{name}.npy").exists()
    np.testing.assert_array_equal(np.load(tmp_path / f"dlogps_{name}.npy"), out["dlogps"])


def test_default_route_matches_the_kernel_route(setup):
    """Hooks left None: the dense forward and torch.func JVPs give the same
    exact dlogp as the pair-tangent frame (tail batch padded)."""
    _jm, _jp, _jt, params, model, template, x0 = setup
    cfg = fast_profile(ambient_preset("00031", **SIZE), divergence="exact",
                       compute_dtype="f32", traj_forward_impl="default",
                       div_forward_impl="default")
    a = sample_ambient(cfg, model, params, template, x0, save=False, device="cpu", batch_size=2)
    cfg.div_forward_impl = "pair_tangent"
    cfg.traj_forward_impl = "pair_kernel"
    b = sample_ambient(cfg, model, params, template, x0, save=False, device="cpu")
    np.testing.assert_allclose(a["samples"], b["samples"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a["dlogps"], b["dlogps"], rtol=1e-3, atol=1e-4)


def test_sampler_div_chunk_and_hutchpp(setup):
    """The default route's exact divergence in blocks of ``div_chunk`` lanes
    gives the unblocked dlogp; Hutch++ with a sketch as wide as the state
    (54 queries: s = 3N = 18) is exact too, per chain and with one shared
    probe set (``probe_crn``)."""
    _jm, _jp, _jt, params, model, template, x0 = setup
    v_of = molecular_v_fn_of(model, params, template, device="cpu")
    kw = dict(solver="rk4", n_steps=4, dlogp_quad="gauss", dlogp_quad_points=2,
              steps_per_dispatch=4, device="cpu")
    temps = np.tile(np.array([700.0, 300.0], np.float32), (B, 1))

    def run(**over):
        return make_ode_sampler(v_of, **kw, **over)(x0, temps, torch.Generator().manual_seed(0))

    ref = run(divergence="exact")
    assert np.all(np.isfinite(ref.dlogp.numpy()))
    got = run(divergence="exact", div_chunk=5)
    torch.testing.assert_close(got.xs, ref.xs, rtol=0, atol=0)
    np.testing.assert_allclose(got.dlogp.numpy(), ref.dlogp.numpy(), rtol=1e-5, atol=1e-6)
    for crn in (False, True):
        got = run(divergence="hutchpp", num_probes=9 * N_ATOMS, probe_crn=crn)
        np.testing.assert_allclose(got.dlogp.numpy(), ref.dlogp.numpy(), rtol=1e-3, atol=1e-4)
    with pytest.raises(ValueError, match="num_probes >= 3"):
        make_ode_sampler(v_of, divergence="hutchpp", num_probes=2, **kw)
    with pytest.raises(ValueError, match="unknown divergence"):
        make_ode_sampler(v_of, divergence="nope", **kw)


def test_sampler_guards(setup):
    _jm, _jp, _jt, params, model, template, x0 = setup
    v_of = molecular_v_fn_of(model, params, template, device="cpu")
    gauss = dict(solver="rk4", n_steps=8, dlogp_quad="gauss", dlogp_quad_points=4, device="cpu")
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        make_ode_sampler(v_of, divergence="hutchinson", return_dlogp_var=True, **gauss)
    div_fn = pair_tangent_div_fn(model, params, template, num_probes=4, device="cpu")
    with pytest.raises(ValueError, match="probe_crn"):
        make_ode_sampler(v_of, steps_per_dispatch=4, probe_crn=True, div_drift=div_fn, **gauss)
    # dopri5, stage-coupled dlogp, Simpson and the unsegmented Gauss sampler
    # run; lane sharding resolves its axis name only inside
    # lane_parallel_sampler's mesh, and refuses div_drift, which does not
    # shard its lanes
    x0 = x0[:2]
    temps = np.tile(np.array([700.0, 300.0], np.float32), (2, 1))
    d5 = make_ode_sampler(v_of, solver="dopri5", return_dlogp=False, device="cpu")(x0, temps)
    rk = make_ode_sampler(v_of, solver="rk4", n_steps=2, device="cpu")(x0, temps)
    quads = [make_ode_sampler(v_of, solver="rk4", n_steps=8, device="cpu", **q)(x0, temps)
             for q in (dict(dlogp_quad_points=5), dict(dlogp_quad="gauss", dlogp_quad_points=4))]
    for sol in (d5, rk, *quads):
        assert sol.xs.shape == (2, 2, N_ATOMS, 3) and bool(torch.isfinite(sol.xs).all())
    for sol in (rk, *quads):
        assert bool(torch.isfinite(sol.dlogp).all()) and bool((sol.dlogp[:, -1] != 0).all())
    assert d5.nfe.shape == (2,) and bool((d5.nfe > 0).all())
    with pytest.raises(ValueError, match="no mesh is in use"):
        make_ode_sampler(v_of, solver="rk4", n_steps=8, device="cpu", div_axis="lanes")(x0, temps)
    with pytest.raises(ValueError, match="div_axis is not supported with div_drift"):
        make_ode_sampler(v_of, steps_per_dispatch=4, div_drift=div_fn, div_axis="lanes", **gauss)


def test_no_silent_cpu(setup, monkeypatch):
    _jm, _jp, _jt, params, model, template, x0 = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = fast_profile(ambient_preset("00031", **SIZE))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample_ambient(cfg, model, params, template, x0, save=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pair_tangent_div_fn(model, params, template)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        molecular_v_fn_of(model, params, template)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        molecular_v_fn_of(model, params, template, impl="dense_fused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample_molecular_sde(model, params, template, x0, np.tile([700.0, 300.0], (B, 1)),
                             g_fn=0.1, n_steps=2, forward_impl="pair_kernel")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fused_velocity_fn(model, params, template)


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_sample_ode_matches_jax(method):
    """The fixed-step integrator on a linear time-dependent field, batched
    in the port, per chain in the JAX package."""
    import jax.numpy as jnp

    from ti_tpu.sampling.integrators import sample_ode as jax_sample_ode
    from ti_torch.sampling.integrators import sample_ode

    rng = np.random.default_rng(0)
    a = (0.5 * rng.standard_normal((4, 4))).astype(np.float32)
    x0 = rng.standard_normal((3, 4)).astype(np.float32)
    out = sample_ode(lambda x, t: x @ torch.from_numpy(a).T + t, torch.from_numpy(x0),
                     t0=0.2, t1=0.9, n_steps=8, n_save=3, method=method)
    for i in range(3):
        ref = jax_sample_ode(lambda x, t: jnp.asarray(a) @ x + t, jnp.asarray(x0[i]), t0=0.2,
                             t1=0.9, n_steps=8, n_save=3, method=method, return_dlogp=False)
        np.testing.assert_allclose(out.xs[i].numpy(), np.asarray(ref.xs), rtol=1e-5, atol=1e-6)
        assert out.nfe == int(ref.nfe)
