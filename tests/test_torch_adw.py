"""The port's ADW family against ti_tpu's, on the CPU at a small size.

The same numpy inputs, weights (a flax ``FCNetMultiBeta.init`` carried
across with ``params_from_flax``) and pinned draws go through both
packages. Bars:
- the potentials, log Z, the inverse-CDF samples, the quadrature ΔF, the
  CSV, the splits and the batches: exactly equal (the same numpy);
- the forward: f32 rtol 1e-5 / atol 1e-6; f64 (``jax.enable_x64``) rtol
  1e-12;
- the loss and its gradients with t and z pinned: loss rtol 1e-5,
  gradients rtol 1e-4 / atol 1e-6 (``test_torch_losses.py``'s LOSS_BAR and
  GRAD_BAR), in f32 and in f64;
- ``sample_adw`` on the stage-coupled rk4, dopri5 and Gauss-Legendre
  routes: samples rtol 1e-4 / atol 1e-5 and dlogp rtol 1e-3 / atol 1e-5 in
  f32, both at rtol 1e-9 / atol 1e-9 in f64;
- the reweighting and gEDMD pipelines: rtol 1e-10 (eigenvalues: with an
  atol of 1e-10 of the largest).

ti_tpu's f64 entry points switch ``jax_enable_x64`` on for the whole
process, so the f64 cases call flax's ``apply`` and ti_tpu's
``make_ode_sampler`` directly under ``jax.enable_x64``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu import interpolants as jax_interp
from ti_tpu.analysis import potentials as jax_pot
from ti_tpu.analysis import reweight as jax_reweight
from ti_tpu.config import ADWConfig as JaxADWConfig
from ti_tpu.data import adw as jax_adw
from ti_tpu.gedmd import rff as jax_rff
from ti_tpu.losses import adw_velocity_loss as jax_adw_loss
from ti_tpu.models.mlp import FCNetMultiBeta as JaxFCNet
from ti_tpu.sampling.drivers import make_ode_sampler as jax_make_ode_sampler
from ti_tpu.sampling.drivers import sample_adw as jax_sample_adw
from ti_torch.analysis import potentials, reweight
from ti_torch.config import ADWConfig
from ti_torch.data.adw import ADWDataset, _read_csv_column, make_synthetic_adw_csv
from ti_torch.gedmd import rff
from ti_torch.models.convert import load_npz, params_from_flax, params_to_flax
from ti_torch.models.mlp import FCNetMultiBeta, apply_fcnet
from ti_torch.sampling.drivers import sample_adw
from ti_torch.train import make_adw_loss, train_adw

HIDDEN, LAYERS, CHAINS = 16, 2, 32
LOSS_BAR = dict(rtol=1e-5, atol=0)
GRAD_BAR = dict(rtol=1e-4, atol=1e-6)
FWD_BAR = {"f32": dict(rtol=1e-5, atol=1e-6), "f64": dict(rtol=1e-12, atol=0)}
SAMPLE_BAR = {"f32": (dict(rtol=1e-4, atol=1e-5), dict(rtol=1e-3, atol=1e-5)),
              "f64": (dict(rtol=1e-9, atol=1e-9), dict(rtol=1e-9, atol=1e-9))}
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
ROUTES = {  # sample_adw's routes, as ADWConfig fields
    "rk4": dict(solver_type="rk4", n_step=16),
    "dopri5": dict(solver_type="dopri5", n_step=6),
    "gauss": dict(solver_type="rk4", n_step=16, dlogp_quad_points=8, dlogp_quad="gauss"),
}


def _flax(dtype="f32"):
    """A flax model, its init (f32) and the same tree in ``dtype`` as numpy."""
    jm = JaxFCNet(hidden_size=HIDDEN, num_layers=LAYERS)
    z = jnp.zeros((1, 1))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0), z, z, z, z)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, DTYPES[dtype][0]), jp)
    return jm, tree


def _port(dtype="f32"):
    jm, tree = _flax(dtype)
    model = FCNetMultiBeta(hidden_size=HIDDEN, num_layers=LAYERS, dtype=DTYPES[dtype][1])
    params = params_from_flax(tree)
    model.load_state_dict(params)
    return jm, tree, model, params


def _inputs(n, dtype="f32", seed=0):
    rng = np.random.default_rng(seed)
    nd = DTYPES[dtype][0]
    x = rng.standard_normal((n, 1)).astype(nd)
    t = rng.uniform(0.0, 1.0, (n, 1)).astype(nd)
    b0 = np.full((n, 1), 1.0, nd)
    b1 = rng.choice([1.25, 1.5, 2.0], (n, 1)).astype(nd)
    return x, t, b0, b1


# ---------------------------------------------------------------- numpy copies

@pytest.mark.parametrize("beta", [0.5, 1.0, 1.25, 2.0])
def test_potentials_and_quadrature_equal(beta):
    x = np.linspace(-3.0, 3.0, 101)
    pot, jpot = potentials.AsymmetricDoubleWell(), jax_pot.AsymmetricDoubleWell()
    np.testing.assert_array_equal(pot(x), jpot(x))
    np.testing.assert_array_equal(pot.grad(x), jpot.grad(x))
    # torch tensors go through the same formulas (torch rounds its powers
    # apart from numpy's in the last bits)
    np.testing.assert_allclose(pot(torch.from_numpy(x)).numpy(), jpot(x), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(pot.grad(torch.from_numpy(x)).numpy(), jpot.grad(x), rtol=1e-13,
                               atol=1e-13)
    dens, jdens = potentials.BoltzmannDensity1D(beta), jax_pot.BoltzmannDensity1D(beta)
    assert dens.log_partition_function() == jdens.log_partition_function()
    assert dens.partition_function() == jdens.partition_function()
    assert dens.free_energy() == jdens.free_energy()
    np.testing.assert_array_equal(dens.logpdf(x), jdens.logpdf(x))
    np.testing.assert_array_equal(dens.sample(7, 500), jdens.sample(7, 500))
    assert potentials.delta_f_quadrature(1.0, beta) == jax_pot.delta_f_quadrature(1.0, beta)


def test_synthetic_csv_is_byte_equal(tmp_path):
    kw = dict(betas=[1.0, 1.25, 1.5], n_samples=2000, seed=3)
    a = make_synthetic_adw_csv(str(tmp_path / "port" / "samples.csv"), **kw)
    b = jax_adw.make_synthetic_adw_csv(str(tmp_path / "jax" / "samples.csv"), **kw)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(_read_csv_column(a, "1.25"), jax_adw._read_csv_column(b, "1.25"))


@pytest.mark.parametrize("scale", [False, True])
def test_from_csv_and_splits_equal(tmp_path, scale):
    csv = make_synthetic_adw_csv(str(tmp_path / "samples.csv"), betas=[1.0, 1.25, 1.5],
                                 n_samples=1500)
    kw = dict(n_samples=3000, scale=scale, seed=4)
    ds = ADWDataset.from_csv(csv, [1.25, 1.5], **kw)
    jds = jax_adw.ADWDataset.from_csv(csv, [1.25, 1.5], **kw)
    assert ds.x.dtype == np.float32 and len(ds) == 3000
    for a, b in zip((ds, *ds.splits()), (jds, *jds.splits())):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.beta, b.beta)
        assert a.seed == b.seed


def test_epoch_batches_on_the_jax_permutation(tmp_path):
    csv = make_synthetic_adw_csv(str(tmp_path / "samples.csv"), betas=[1.0], n_samples=1000)
    ds = ADWDataset.from_csv(csv, [1.0], seed=1)
    jds = jax_adw.ADWDataset.from_csv(csv, [1.0], seed=1)
    key = jax.random.PRNGKey(9)
    jx, jb = jds.epoch_batches(key, 96)
    x, b = ds.epoch_batches(None, 96, perm=np.asarray(jax.random.permutation(key, len(ds))))
    assert x.shape == (10, 96, 1) and x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    # from a generator: reproducible, every row once, in the dtype asked for
    g1, _ = ds.epoch_batches(torch.Generator().manual_seed(0), 96, dtype=torch.float64)
    g2, _ = ds.epoch_batches(torch.Generator().manual_seed(0), 96, dtype=torch.float64)
    assert g1.dtype == torch.float64 and torch.equal(g1, g2)
    assert len(np.unique(g1.numpy())) == 960 and np.isin(g1.numpy(), ds.x).all()


# ---------------------------------------------------------------- the model

@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_forward_matches_flax(dtype):
    jm, tree, model, params = _port(dtype)
    assert all(p.dtype == DTYPES[dtype][1] for p in model.parameters())
    args = _inputs(64, dtype)
    with jax.enable_x64(dtype == "f64"):
        ref = np.asarray(jax.jit(jm.apply)(jax.tree_util.tree_map(jnp.asarray, tree),
                                           *map(jnp.asarray, args)))
    out = model(*map(torch.from_numpy, args))
    assert out.shape == (64, 1) and out.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(out.detach().numpy(), ref, **FWD_BAR[dtype])
    # the functional form on a state dict is the module's forward
    torch.testing.assert_close(apply_fcnet(model, params, *map(torch.from_numpy, args)),
                               out.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_flax_round_trip_keeps_the_dtype(dtype, tmp_path):
    _, tree, model, params = _port(dtype)
    nd = DTYPES[dtype][0]
    back = params_to_flax(model.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    ref = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert flat.keys() == ref.keys()
    for k, v in flat.items():
        assert v.dtype == nd
        np.testing.assert_array_equal(v, ref[k])
    from ti_torch.models.convert import save_npz

    save_npz(str(tmp_path / "w.npz"), model.state_dict())
    again = load_npz(str(tmp_path / "w.npz"))
    assert all(torch.equal(again[k], params[k]) for k in params)


def test_fresh_model_draws_as_flax_init():
    h, draws = 64, 48
    jm = JaxFCNet(hidden_size=h, num_layers=LAYERS)
    z = jnp.zeros((1, 1))
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    ref = jax.jit(jax.vmap(lambda k: jm.init(k, z, z, z, z)))(keys)
    # flattened first: the names map, the draws' values pool
    ref = {name: v.double().numpy() for name, v in params_from_flax(
        jax.tree_util.tree_map(lambda a: np.asarray(a).reshape(-1), ref)).items()}
    gen = torch.Generator().manual_seed(0)
    models = [FCNetMultiBeta(hidden_size=h, num_layers=LAYERS, generator=gen)
              for _ in range(draws)]
    assert set(ref) == set(models[0].state_dict())
    for name, r in ref.items():
        p = np.concatenate([m.state_dict()[name].double().numpy().ravel() for m in models])
        assert p.size == r.size, name
        if name.endswith("bias"):
            assert not p.any() and not r.any(), name
            continue
        assert abs(p.std() / r.std() - 1.0) < 0.06, (name, p.std(), r.std())
        assert abs(p.mean()) < 0.06 * r.std(), name
        # lecun-normal: truncated at two standard deviations of the normal
        assert np.abs(p).max() <= 2.0 * r.std() / 0.8796 * 1.01, name
    a = FCNetMultiBeta(16, generator=torch.Generator().manual_seed(3)).state_dict()
    b = FCNetMultiBeta(16, generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------- the loss

@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_loss_and_grads_match_jax(dtype):
    jm, tree, model, params = _port(dtype)
    nd = DTYPES[dtype][0]
    rng = np.random.default_rng(5)
    b = 24
    x0 = rng.standard_normal((b, 1)).astype(nd)
    x1 = rng.standard_normal((b, 1)).astype(nd)
    beta0 = np.full((b, 1), 1.0, nd)
    beta1 = np.full((b, 1), 1.25, nd)
    t = rng.uniform(0.05, 0.95, (b, 1)).astype(nd)
    z = rng.standard_normal((b, 1)).astype(nd)
    with jax.enable_x64(dtype == "f64"):
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        ref_val, ref_g = jax.jit(jax.value_and_grad(lambda p: jax_adw_loss(
            jm.apply, p, jax.random.PRNGKey(0), *map(jnp.asarray, (x0, x1, beta0, beta1)),
            jax_interp.linear(a=0.9, gamma="brownian"), t=jnp.asarray(t),
            z=jnp.asarray(z))))(jp)
        ref_g = params_from_flax(jax.tree_util.tree_map(np.asarray, ref_g))
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    # the trainer's loss: ADWConfig's a = 0.9, brownian gamma
    val = make_adw_loss(ADWConfig(), model, leaves)(
        None, *map(torch.from_numpy, (x0, x1, beta0, beta1)), t=torch.from_numpy(t),
        z=torch.from_numpy(z))
    grads = dict(zip(leaves, torch.autograd.grad(val, list(leaves.values()))))
    np.testing.assert_allclose(val.item(), float(ref_val), **LOSS_BAR)
    assert set(grads) == set(ref_g)
    for k, g in grads.items():
        assert g.dtype == DTYPES[dtype][1], k
        np.testing.assert_allclose(g.numpy(), ref_g[k].numpy(), **GRAD_BAR, err_msg=k)


# ---------------------------------------------------------------- the trainer

def _train_cfg(tmp_path, **kw):
    base = dict(n_samples=1200, hidden_size=HIDDEN, num_layers=LAYERS, epochs=2, lr=1e-3,
                batch_size=64, traj_path=str(tmp_path), model_save_path=str(tmp_path / "models"),
                data_save_path=str(tmp_path / "out"), model_save_name="tiny")
    base.update(kw)
    return ADWConfig(**base)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_train_adw_bookkeeping(tmp_path, dtype):
    make_synthetic_adw_csv(str(tmp_path / "samples.csv"), betas=[1.0, 1.25], n_samples=1200)
    cfg = _train_cfg(tmp_path, dtype=dtype)
    res = train_adw(cfg, device="cpu")
    assert set(res) == {"params", "model", "history", "state"}
    assert set(res["history"]) == {"train_loss", "val_loss"}
    assert all(len(v) == 2 and np.isfinite(v).all() for v in res["history"].values())
    assert res["state"].nan_count == 0 and res["state"].count == 2 * (960 // 64)
    assert all(p.dtype == DTYPES[dtype][1] for p in res["params"].values())
    save_dir = tmp_path / "models" / "tiny"
    assert sorted(os.listdir(save_dir)) == ["epoch_0.npz", "epoch_1.npz", "settings.json"]
    last = load_npz(str(save_dir / "epoch_1.npz"))
    assert all(torch.equal(last[k], res["params"][k]) for k in last)
    # flax's apply reads the checkpoint back to the port's output
    args = _inputs(16, dtype, seed=2)
    out = res["model"](*map(torch.from_numpy, args)).detach().numpy()
    jm = JaxFCNet(hidden_size=HIDDEN, num_layers=LAYERS)
    with jax.enable_x64(dtype == "f64"):
        ref = np.asarray(jax.jit(jm.apply)(
            jax.tree_util.tree_map(jnp.asarray, params_to_flax(last)), *map(jnp.asarray, args)))
    np.testing.assert_allclose(out, ref, **FWD_BAR[dtype])


def test_train_adw_needs_a_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_adw(_train_cfg(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_adw(_train_cfg(tmp_path), FCNetMultiBeta(8, num_layers=1), None,
                   np.zeros((4, 1)), np.ones(4))
    assert not (tmp_path / "models").exists()  # it refused before doing anything


# ---------------------------------------------------------------- transport

def _jax_v_fn_of(jm, jp):
    """ti_tpu's sample_adw velocity (drivers.py:712-720)."""
    def v_fn_of(cond):
        b0, b1 = cond

        def v(x, t):
            tt = jnp.full((1, 1), t, dtype=x.dtype)
            return jm.apply(jp, x[None, :], tt, b0[None, None], b1[None, None])[0]

        return v

    return v_fn_of


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sample_adw_matches_jax(tmp_path, route, dtype):
    jm, tree, model, params = _port(dtype)
    nd = DTYPES[dtype][0]
    rng = np.random.default_rng(11)
    x0 = potentials.BoltzmannDensity1D(1.0).sample(3, CHAINS).astype(nd)[:, None]
    beta0 = np.full(CHAINS, 1.0)
    kw = dict(ROUTES[route], beta1s=[1.5], sampling_epoch=3, seed=0,
              data_save_path=str(tmp_path / "port"), model_save_name="v")
    out = sample_adw(ADWConfig(dtype=dtype, **kw), model, params, x0, beta0, device="cpu")
    n_save = kw["n_step"] if route == "dopri5" else 2
    assert out["samples"].shape == out["dlogps"].shape == (n_save, CHAINS)
    assert out["samples"].dtype == nd and out["initial_samples"].shape == (CHAINS,)

    if dtype == "f32":
        jcfg = JaxADWConfig(**dict(kw, data_save_path=str(tmp_path / "jax")))
        ref = jax_sample_adw(jcfg, jm, jax.tree_util.tree_map(jnp.asarray, tree), x0, beta0)
        files = sorted(os.listdir(tmp_path / "port" / "v" / "beta_1.0_to_1.5"))
        assert files == sorted(os.listdir(tmp_path / "jax" / "v" / "beta_1.0_to_1.5"))
        assert files == [f"{k}_epoch_3.npy" for k in ("dlogps", "initial_samples", "samples")]
        for f in files:
            a = np.load(tmp_path / "port" / "v" / "beta_1.0_to_1.5" / f)
            assert a.shape == np.load(tmp_path / "jax" / "v" / "beta_1.0_to_1.5" / f).shape
    else:
        with jax.enable_x64(True):
            jp = jax.tree_util.tree_map(jnp.asarray, tree)
            sampler = jax_make_ode_sampler(
                _jax_v_fn_of(jm, jp), solver=kw["solver_type"], n_steps=kw["n_step"],
                n_save=n_save, atol=1e-4, rtol=1e-4,
                dlogp_quad_points=kw.get("dlogp_quad_points"),
                dlogp_quad=kw.get("dlogp_quad", "simpson"))
            b0 = jnp.asarray(beta0, jnp.float64)
            sol = sampler(jnp.asarray(x0), (b0, jnp.full_like(b0, 1.5)), jax.random.PRNGKey(0))
            ref = {"samples": np.asarray(sol.xs)[:, :, 0].T, "dlogps": np.asarray(sol.dlogp).T,
                   "nfe": int(np.max(np.asarray(sol.nfe)))}
    s_bar, d_bar = SAMPLE_BAR[dtype]
    np.testing.assert_allclose(out["samples"], ref["samples"], **s_bar)
    np.testing.assert_allclose(out["dlogps"], ref["dlogps"], **d_bar)
    if route != "dopri5" or dtype == "f64":  # f32 dopri5 counts may differ (rounding noise)
        assert out["nfe"] == ref["nfe"]
    assert np.abs(out["dlogps"][-1]).max() > 1e-3  # the field moves dlogp


# ---------------------------------------------------------------- analysis

def _assert_spectra_equal(out, ref):
    """rtol 1e-10 with an atol of 1e-10 of the largest eigenvalue: the
    stationary one is zero up to rounding (~1e-7), and the port's bootstrap
    forms its Grams by BLAS where ti_tpu's einsum sums in another order."""
    scale = np.abs(ref["eigenvalues_mean"]).max()
    for k in ("eigenvalues_mean", "lower_bound", "upper_bound"):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-10, atol=1e-10 * scale, err_msg=k)
    assert np.isfinite(out["eigenvalues_mean"]).all()


def test_reweighting_pipelines_match_jax():
    rng = np.random.default_rng(6)
    n, beta = 3000, 1.5
    x0 = potentials.BoltzmannDensity1D(1.0).sample(1, n)
    x1 = np.stack([x0, 0.9 * x0 + 0.01 * rng.standard_normal(n)])
    dlogps = np.stack([np.zeros(n), np.log(0.9) + 0.02 * rng.standard_normal(n)])
    for a, b in zip(reweight.calculate_weights(x0, x1, dlogps, beta),
                    jax_reweight.calculate_weights(x0, x1, dlogps, beta)):
        np.testing.assert_allclose(a, b, rtol=1e-10)
    np.testing.assert_allclose(reweight.direct_weights(x0, 1.0, beta),
                               jax_reweight.direct_weights(x0, 1.0, beta), rtol=1e-10)
    kw = dict(p=16, n_bootstrap=20, seed=2)
    out = reweight.reweighted_gedmd_spectrum(x0, x1, dlogps, beta, **kw)
    ref = jax_reweight.reweighted_gedmd_spectrum(x0, x1, dlogps, beta, **kw)
    assert out.keys() == ref.keys() and out["n_filtered"] == ref["n_filtered"]
    np.testing.assert_allclose(out["weights"], ref["weights"], rtol=1e-10)
    _assert_spectra_equal(out, ref)
    out = reweight.direct_reweighted_gedmd_spectrum(x0, 1.0, beta, **kw)
    ref = jax_reweight.direct_reweighted_gedmd_spectrum(x0, 1.0, beta, **kw)
    np.testing.assert_allclose(out["weights"], ref["weights"], rtol=1e-10)
    _assert_spectra_equal(out, ref)

    # the generator spectrum of an OU path (numpy Euler–Maruyama)
    dt, m = 1e-3, 4000
    path = np.zeros(m)
    noise = rng.standard_normal(m)
    for i in range(1, m):
        path[i] = path[i - 1] - path[i - 1] * dt + np.sqrt(2.0 * dt) * noise[i]
    omega = rff.sample_rff_gaussian(1, 1, 32, 0.8)
    np.testing.assert_array_equal(omega, jax_rff.sample_rff_gaussian(1, 1, 32, 0.8))
    d, w = rff.spectral_analysis_rff_generator(path[None], omega, nev=4, a=2.0, tol=1e-4)
    jd, jw = jax_rff.spectral_analysis_rff_generator(path[None], omega, nev=4, a=2.0, tol=1e-4)
    np.testing.assert_allclose(d, jd, rtol=1e-10)
    np.testing.assert_allclose(np.abs(w), np.abs(jw), rtol=1e-10, atol=1e-12)
