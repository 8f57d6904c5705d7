"""The latent (Boltzmann-generator) family of the port against ti_tpu's:
``MDQM9LatentDataset``, ``build_latent_model``/``train_latent``,
``sample_latent`` and the pair kernels' plain versions under the latent
model's conditionings ("none": temps (B, 0); "latent": (B, 1)), then the
BG→TI composition through the port's entry points and, ``slow``, the
latent partition identity on a field ``train_latent`` trains on the CPU.

JAX's PRNG cannot be replayed, so its draws are pinned: the permutation
and the noise of an epoch (``perm=``, ``z=``), the loss's t (ti_tpu's
``_sample_t`` draw, fed in its place) and the generator's noise
(``noise=``). Bars:
- data: frames and temperatures exactly; the aligned noise rtol 1e-5 /
  atol 1e-5 (two SVDs' rounding, tests/test_torch_kabsch.py);
- the model: the state dict's names and shapes exactly, the dense forward
  rtol 1e-5 / atol 1e-6 (tests/test_torch_training.py's bar);
- the pair kernels' plain versions against ti_tpu's kernels in interpret
  mode: B1 f32 rtol 1e-4 / atol 1e-5, bf16_agg scaled atol 4e-2; B3 the
  velocity rtol 2e-4 / atol 2e-5, each lane rtol 5e-4 / atol 5e-5
  (tests/test_torch_pair_layer.py, tests/test_torch_pair_tangent.py);
- one training update: the loss rtol 1e-5; each parameter's move, past
  two ulps of the parameter, within 1e-4 of the learning rate where
  ti_tpu's gradient is more than 1e-3 of its leaf's largest (Adam's first
  step moves a parameter by about lr · sign(g), whose sign is rounding
  where g is that small), and within 2 lr + 1e-4 lr everywhere;
- sampling, exact dlogp: samples rtol 1e-4 / atol 1e-5, dlogp rtol 1e-3
  (tests/test_torch_sample_ambient.py's).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ti_torch.losses
from ti_tpu import interpolants as jax_interp
from ti_tpu.config import MDQM9Config as JaxConfig
from ti_tpu.config import fast_profile as jax_fast_profile
from ti_tpu.config import latent_preset as jax_latent_preset
from ti_tpu.data import mdqm9 as jax_mdqm9
from ti_tpu.losses import molecular_velocity_loss as jax_loss
from ti_tpu.models.cpainn_dense import apply_dense as jax_apply_dense
from ti_tpu.ops.pair_layer_kernel import apply_dense_pair_kernel as jax_pair_kernel
from ti_tpu.ops.pair_tangent_kernel import apply_dense_pair_tangent as jax_pair_tangent
from ti_tpu.sampling.drivers import sample_latent as jax_sample_latent
from ti_tpu.train import common as jax_common
from ti_tpu.train.latent import build_latent_model as jax_build_latent_model
from ti_tpu.train.latent import train_latent as jax_train_latent
from ti_torch.analysis.weights import calc_ess, calc_importance_weights
from ti_torch.config import MDQM9Config, fast_profile, latent_preset
from ti_torch.data.mdqm9 import (
    MDQM9AmbientDataset,
    MDQM9LatentDataset,
    graph_template,
    make_synthetic_frames,
    make_synthetic_molecule,
)
from ti_torch.models.convert import params_from_flax
from ti_torch.models.cpainn_dense import apply_dense, dense_velocity_fn
from ti_torch.ops.divergence import divergence_exact
from ti_torch.ops.pair_layer_kernel import apply_dense_pair_kernel, prepare
from ti_torch.ops.pair_tangent_kernel import apply_dense_pair_tangent, pair_tangent_div_fn
from ti_torch.sampling.drivers import sample_ambient, sample_latent
from ti_torch.train import build_latent_model, load_checkpoint, train_ambient, train_latent
from test_torch_training import _write_sdf

N_ATOMS, F, LAYERS, B = 6, 16, 2, 3
SIZE = dict(n_features=F, score_layers=LAYERS, batch_size=B)
CONDITIONINGS = {"none": [300], "latent": [300, 500, 700]}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=list(CONDITIONINGS))
def latent_models(request):
    """A flax-initialised latent model of ti_tpu and the port's model with
    its weights, for one conditioning."""
    Ts = CONDITIONINGS[request.param]
    t_cond = 1 if len(Ts) > 1 else 0
    jt = jax_mdqm9.graph_template(jax_mdqm9.make_synthetic_molecule(N_ATOMS, seed=0), t_cond)
    jm = jax_build_latent_model(JaxConfig(**SIZE, T=Ts))
    jp = jm.init(jax.random.PRNGKey(0), jt)
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    model = build_latent_model(MDQM9Config(**SIZE, T=Ts), N_ATOMS)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond)
    rng = np.random.default_rng(1)
    x = (0.5 * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    x -= x.mean(axis=1, keepdims=True)
    t = np.array([0.1, 0.5, 0.9], np.float32)
    temps = np.tile(np.array([[500.0]], np.float32)[:, :t_cond], (B, 1))
    return request.param, Ts, jm, jp, jt, params, model, template, x, t, temps


# ---------------------------------------------------------------- the model

def test_build_latent_model_matches_flax_init(latent_models):
    cond, Ts, jm, jp, jt, params, model, template, x, t, temps = latent_models
    assert model.conditioning == jm.conditioning == cond
    assert temps.shape == (B, template.t_cond) == (B, 0 if cond == "none" else 1)
    state = model.state_dict()
    assert set(state) == set(params)
    assert all(state[k].shape == params[k].shape for k in params)
    if cond == "latent":  # centred and scaled by the temperatures it trains on
        assert model.temperatures == tuple(float(T) for T in Ts) == tuple(jm.temperatures)
    assert model.cutoff is None and model.temp_length == jm.temp_length
    ref = np.asarray(jax_apply_dense(jm, jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps),
                                     jt.atom_ids, jt.edges))
    out = apply_dense(model, params, _t(x), _t(t), _t(temps), template.atom_ids, template.edges)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5, atol=1e-6)
    assert build_latent_model(MDQM9Config(n_features=8, score_layers=1, cutoff=5.0)).cutoff == 5.0


@pytest.mark.parametrize("compute_dtype", [None, "bf16_agg"])
def test_pair_kernels_plain_match_jax_under_latent_conditioning(latent_models, compute_dtype):
    """B1's and B3's plain versions with temps (B, 0) and (B, 1) against
    ti_tpu's kernels in interpret mode, and B3's full orthogonal frame
    against the exact divergence."""
    cond, Ts, jm, jp, jt, params, model, template, x, t, temps = latent_models
    jx, jtt, jtemps = jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps)
    ref = np.asarray(jax_pair_kernel(jm, jp, jx, jtt, jtemps, jt.atom_ids, jt.edges,
                                     interpret=True, compute_dtype=compute_dtype))
    pm = prepare(model, params, template, compute_dtype, torch.device("cpu"))
    out = apply_dense_pair_kernel(pm, _t(x), _t(t), _t(temps)).numpy()
    z = np.random.default_rng(3).standard_normal((B, 4, N_ATOMS, 3)).astype(np.float32)
    vel_j, dvel_j = jax_pair_tangent(jm, jp, jx, jtt, jtemps, jnp.asarray(z), jt.atom_ids,
                                     jt.edges, interpret=True, compute_dtype=compute_dtype)
    vel, dvel = apply_dense_pair_tangent(pm, _t(x), _t(t), _t(temps), _t(z))
    if compute_dtype is None:
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(vel.numpy(), np.asarray(vel_j), rtol=2e-4, atol=2e-5)
        for k in range(4):
            np.testing.assert_allclose(dvel[:, k].numpy(), np.asarray(dvel_j[:, k]),
                                       rtol=5e-4, atol=5e-5)
    else:
        for a, r in ((out, ref), (vel.numpy(), vel_j), (dvel.numpy(), dvel_j)):
            r = np.asarray(r)
            scale = max(np.abs(r).max(), 1e-3)
            np.testing.assert_allclose(a / scale, r / scale, atol=4e-2)
        return
    div_fn = pair_tangent_div_fn(model, params, template, num_probes=3 * N_ATOMS,
                                 probe_mode="orthogonal", device="cpu")
    divs = div_fn(_t(x), 0.5, _t(temps), torch.Generator().manual_seed(0))
    drift = dense_velocity_fn(model, params, template)
    exact = divergence_exact(lambda y: drift(y, 0.5, _t(temps)), _t(x))[1]
    np.testing.assert_allclose(divs.numpy(), exact.numpy(), rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------- the dataset

def _frames(n_atoms=N_ATOMS, n=24, Ts=(300, 700)):
    mol = make_synthetic_molecule(n_atoms, seed=2)
    stack = np.concatenate([make_synthetic_frames(mol, n, T, seed=T) + 0.3 for T in Ts])
    temps = np.concatenate([np.full(n, float(T)) for T in Ts])
    return mol, stack, temps


@pytest.mark.parametrize("align", [True, False])
def test_epoch_batches_match_jax_draws(align):
    mol, stack, temps = _frames()
    jds = jax_mdqm9.MDQM9LatentDataset.from_arrays(
        stack, temps, jax_mdqm9.make_synthetic_molecule(N_ATOMS, seed=2), align=align)
    ds = MDQM9LatentDataset.from_arrays(stack, temps, mol, align=align)
    key = jax.random.PRNGKey(4)
    jz, jx1, jT = (np.asarray(a) for a in jds.epoch_batches(key, 10))
    pkey, zkey = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(pkey, len(stack)))
    z = np.asarray(jax.random.normal(zkey, (40, N_ATOMS, 3)))
    x0, x1, T = ds.epoch_batches(None, 10, perm=perm, z=z)
    assert x0.shape == x1.shape == (4, 10, N_ATOMS, 3) and T.shape == (4, 10)
    np.testing.assert_allclose(x1.numpy(), jx1, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(T.numpy(), jT)
    np.testing.assert_allclose(x0.numpy(), jz, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x0.mean(dim=2).numpy(), 0.0, atol=1e-6)  # COM-free noise
    np.testing.assert_allclose(x1.mean(dim=2).numpy(), 0.0, atol=1e-6)


def test_epoch_batches_and_noise_from_a_generator():
    mol, stack, temps = _frames()
    ds = MDQM9LatentDataset.from_arrays(stack, temps, mol)
    a = ds.epoch_batches(torch.Generator().manual_seed(0), 16)
    b = ds.epoch_batches(torch.Generator().manual_seed(0), 16)
    c = ds.epoch_batches(torch.Generator().manual_seed(1), 16)
    assert a[0].shape == (3, 16, N_ATOMS, 3) and all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], c[0])
    # the generator draws the permutation, then the noise; the aligned noise
    # is a rotation of the centred draw, so each frame keeps its norm
    gen = torch.Generator().manual_seed(0)
    perm = torch.randperm(len(ds), generator=gen).numpy()[:48]
    z = torch.randn((48, N_ATOMS, 3), generator=gen)
    z = (z - z.mean(dim=1, keepdim=True)).reshape(3, 16, N_ATOMS, 3)
    np.testing.assert_array_equal(a[2].numpy().ravel(), temps[perm].astype(np.float32))
    torch.testing.assert_close(a[0].norm(dim=(2, 3)), z.norm(dim=(2, 3)), rtol=1e-5, atol=1e-5)
    noise = ds.sample_noise(torch.Generator().manual_seed(3), 7)
    assert noise.shape == (7, N_ATOMS, 3)
    np.testing.assert_allclose(noise.mean(dim=1).numpy(), 0.0, atol=1e-6)


def test_load_matches_jax(tmp_path):
    mol = make_synthetic_molecule(5, seed=1)
    os.makedirs(tmp_path / "train")
    all_T = np.stack([make_synthetic_frames(mol, 16, T, seed=T) + 0.7
                      for T in jax_mdqm9.TEMPERATURES])
    np.save(tmp_path / "train" / "00002.npy", all_T)
    _write_sdf(tmp_path / "mdqm9.sdf", mol, 2)
    for Ts, align in (((500,), True), ((300, 1000), False)):
        kw = dict(traj_path=str(tmp_path), sdf_path=str(tmp_path), traj_filename="00002.npy",
                  Ts=Ts, scale=True, align=align)
        ds = MDQM9LatentDataset.load(**kw)
        jds = jax_mdqm9.MDQM9LatentDataset.load(**kw)
        np.testing.assert_array_equal(ds.frames, jds.frames)
        np.testing.assert_array_equal(ds.temps, jds.temps)
        assert ds.frames.dtype == np.float32 and len(ds) == 16 * len(Ts)
        assert ds.template.t_cond == jds.template.temps.shape[0] == (len(Ts) > 1)
        assert ds.align == jds.align == align
        np.testing.assert_array_equal(ds.template.atom_ids, np.asarray(jds.template.atom_ids))
        for field in ("src", "dst", "edge_type"):
            np.testing.assert_array_equal(np.asarray(getattr(ds.template.edges, field)),
                                          np.asarray(getattr(jds.template.edges, field)))


# ---------------------------------------------------------------- the trainer

def _train_cfg(cls, tmp_path, Ts, **kw):
    base = dict(n_features=F, score_layers=LAYERS, batch_size=8, n_epochs=1, learning_rate=1e-3,
                scale_trajs=False, T=list(Ts), model_save_path=str(tmp_path / "models"),
                model_save_name="lat", use_wandb=False)
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("cond", list(CONDITIONINGS))
def test_one_train_latent_update_matches_jax(tmp_path, monkeypatch, cond):
    """One epoch of one batch: ti_tpu's initial weights, its permutation,
    noise and t fed to the port's trainer; the update, the epoch's loss and
    the re-evaluation's loss against ti_tpu's."""
    Ts = CONDITIONINGS[cond]
    t_cond = 1 if len(Ts) > 1 else 0
    mol, stack, temps = _frames(n=8, Ts=Ts[:2] if t_cond else Ts[:1])
    stack, temps = stack[:8], temps[:8]
    jmol = jax_mdqm9.make_synthetic_molecule(N_ATOMS, seed=2)
    jcfg = _train_cfg(JaxConfig, tmp_path / "jax", Ts)
    jds = jax_mdqm9.MDQM9LatentDataset.from_arrays(stack, temps, jmol, t_cond=t_cond)
    ref = jax_train_latent(jcfg, jds)

    # ti_tpu's draws: init, then per epoch (data, train, eval) keys
    key, init_key = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    jm = jax_build_latent_model(jcfg)
    jp0 = jm.init(init_key, jds.template)
    _, kd, ktr, kev = jax.random.split(key, 4)
    pkey, zkey = jax.random.split(kd)
    perm = np.asarray(jax.random.permutation(pkey, 8))
    z = np.asarray(jax.random.normal(zkey, (8, N_ATOMS, 3)))

    def t_of(k):
        tkey, _ = jax.random.split(jax.random.split(k)[1])
        return np.asarray(jax.random.uniform(tkey, (8,), dtype=jnp.float32))

    ts = [t_of(ktr), t_of(kev)]
    ds = MDQM9LatentDataset.from_arrays(stack, temps, mol, t_cond=t_cond)
    draw = MDQM9LatentDataset.epoch_batches
    monkeypatch.setattr(ds, "epoch_batches", lambda gen, bs, device=None: draw(
        ds, gen, bs, perm=perm, z=z, device=device))
    monkeypatch.setattr(ti_torch.losses, "_sample_t",
                        lambda gen, shape, t_distr, dtype, device: _t(ts.pop(0)).to(device))
    init = params_from_flax(jax.tree_util.tree_map(np.asarray, jp0))
    res = train_latent(_train_cfg(MDQM9Config, tmp_path / "torch", Ts), ds, device="cpu",
                       init_params=init)
    assert not ts  # both of ti_tpu's t draws were taken
    np.testing.assert_allclose(res["history"]["train_loss"], ref["history"]["train_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(res["history"]["last_train_loss"],
                               ref["history"]["last_train_loss"], rtol=1e-5)

    # ti_tpu's gradient of that step, to tell rounding-sized entries apart
    x0s, x1s, T = jds.epoch_batches(kd, 8)
    bapply = jax_common.make_batched_apply(jcfg, jm, jds.template)
    grads = jax.grad(lambda p: jax_loss(
        jm.apply, p, jax.random.PRNGKey(0), jds.template, x0s[0], x1s[0],
        T[0][:, None][:, :t_cond], jax_interp.one_sided_linear(), batched_apply_fn=bapply,
        t=jnp.asarray(t_of(ktr))))(jp0)
    g = params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    after = params_from_flax(jax.tree_util.tree_map(np.asarray, ref["params"]))
    lr = jcfg.learning_rate
    for k, p in res["params"].items():
        move, ref_move = (p - init[k]).numpy(), (after[k] - init[k]).numpy()
        gk = np.abs(g[k].numpy())
        big = gk > 1e-3 * gk.max()
        err = np.abs(move - ref_move) - 2 * np.spacing(np.abs(init[k].numpy()))
        assert np.all(err[big] <= 1e-4 * lr), (k, err[big].max())
        assert np.all(err <= 2.0001 * lr), k
    assert res["state"].count == 1 and res["state"].nan_count == 0


def test_train_latent_bookkeeping(tmp_path, monkeypatch):
    mol, stack, temps = _frames(n=24, Ts=(300, 700))
    ds = MDQM9LatentDataset.from_arrays(stack, temps, mol, t_cond=1)
    cfg = _train_cfg(MDQM9Config, tmp_path, [300, 700], n_epochs=2, batch_size=16)
    res = train_latent(cfg, ds, device="cpu")
    assert set(res) == {"params", "model", "template", "history", "state"}
    assert set(res["history"]) == {"train_loss", "last_train_loss"}
    assert all(len(v) == 2 and np.isfinite(v).all() for v in res["history"].values())
    assert res["model"].conditioning == "latent" and res["state"].count == 2 * 3
    save_dir = tmp_path / "models" / "lat"
    assert sorted(os.listdir(save_dir)) == ["lat_0.npz", "lat_1.npz", "settings.json"]
    last = load_checkpoint(str(save_dir / "lat_1.npz"))
    assert all(torch.equal(last[k], res["params"][k]) for k in last)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_latent(_train_cfg(MDQM9Config, tmp_path / "refused", [300]), ds)
    assert not (tmp_path / "refused").exists()


# ---------------------------------------------------------------- sampling

def _jax_noise(seed, n, bs):
    """The noise ti_tpu's sample_latent draws for n samples in batches of bs."""
    key, out = jax.random.PRNGKey(seed), []
    for i in range(0, n, bs):
        key, zk, _ = jax.random.split(key, 3)
        z = jax.random.normal(zk, (bs, N_ATOMS, 3), dtype=jnp.float32)
        out.append(np.asarray(z - z.mean(axis=1, keepdims=True))[: min(bs, n - i)])
    return np.concatenate(out)


@pytest.mark.parametrize("route", ["stage_coupled", "kernel"])
def test_sample_latent_matches_jax(latent_models, route, tmp_path):
    """Five samples in batches of three (the tail padded): the stage-coupled
    RK4 route with the exact divergence in every stage, and the latent
    kernel route (``fast_profile(family="latent")`` in f32 with B1's
    trajectory and B3's full orthogonal frame), on ti_tpu's noise."""
    cond, Ts, jm, jp, jt, params, model, template, x, t, temps = latent_models
    common = dict(**SIZE, sampling_T=500, data_save_path=str(tmp_path))
    if route == "stage_coupled":
        kw = dict(solver_type="rk4", n_steps=8, divergence="exact")
        cfg, jcfg = latent_preset("00031", Ts=Ts, **common, **kw), \
            jax_latent_preset("00031", Ts=Ts, **common, **kw)
    else:
        over = dict(compute_dtype="f32", traj_forward_impl="pair_kernel",
                    div_forward_impl="pair_tangent", n_steps=9)
        cfg = fast_profile(latent_preset("00031", Ts=Ts, **common), family="latent", **over)
        jcfg = jax_fast_profile(jax_latent_preset("00031", Ts=Ts, **common), family="latent",
                                **over)
        assert (cfg.dlogp_quad, cfg.dlogp_quad_points, cfg.divergence) == ("gauss", 8, "exact")
    ref = jax_sample_latent(jcfg, jm, jp, jt, n_samples=5, save=False)
    noise = _jax_noise(cfg.seed, 5, B)
    out = sample_latent(cfg, model, params, template, n_samples=5, noise=noise, device="cpu")
    assert out["samples"].shape == ref["samples"].shape == (5, 2, N_ATOMS, 3)
    np.testing.assert_array_equal(out["samples"][:, 0], noise)
    np.testing.assert_allclose(out["samples"], ref["samples"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["dlogps"], ref["dlogps"], rtol=1e-3)
    assert out["nfe"] == ref["nfe"]
    name = cfg.data_save_name
    for stem, arr in (("samples", out["samples"]), ("dlogps", out["dlogps"])):
        np.testing.assert_array_equal(np.load(tmp_path / f"{stem}_{name}_forward.npy"), arr)
    assert not (tmp_path / f"dlogp_vars_{name}_forward.npy").exists()


def test_sample_latent_draws_its_noise(latent_models, tmp_path):
    """Without ``noise=``: COM-free draws from cfg.seed, the same for the
    same seed; the probe variance is returned and saved on the Hutchinson
    kernel route; without a card and a device it refuses."""
    cond, Ts, jm, jp, jt, params, model, template, x, t, temps = latent_models
    cfg = fast_profile(latent_preset("00031", Ts=Ts, **SIZE, data_save_path=str(tmp_path)),
                       family="latent", compute_dtype="f32", n_steps=9, divergence="hutchinson",
                       num_probes=4, traj_forward_impl="pair_kernel",
                       div_forward_impl="pair_tangent", return_dlogp_var=True)
    a = sample_latent(cfg, model, params, template, n_samples=4, device="cpu")
    b = sample_latent(cfg, model, params, template, n_samples=4, device="cpu", save=False)
    np.testing.assert_array_equal(a["samples"], b["samples"])
    np.testing.assert_allclose(a["samples"][:, 0].mean(axis=1), 0.0, atol=1e-6)
    assert a["dlogp_vars"].shape == (4,) and np.all(a["dlogp_vars"] >= 0)
    np.testing.assert_array_equal(
        np.load(tmp_path / f"dlogp_vars_{cfg.data_save_name}_forward.npy"), a["dlogp_vars"])


# ---------------------------------------------------------------- BG → TI

def test_bg_to_ti_composition(tmp_path):
    """tests/test_bg_ti_composition.py's chain on the port: the latent
    generator at T0 = 500 K feeds sample_ambient 500 -> 400 K, which
    carries the noise and the BG dlogp through, and the importance weights
    combine both dlogps."""
    mol = make_synthetic_molecule(n_atoms=5, seed=0)
    frames = {T: make_synthetic_frames(mol, 48, T, seed=T) for T in (400, 500)}
    base = dict(
        n_features=8, score_layers=1, batch_size=8, n_epochs=1,
        model_save_path=str(tmp_path / "models"), data_save_path=str(tmp_path / "out"),
        n_steps=4, solver_type="rk4", T0s=[400, 500], T1s=[400, 500],
        sampling_T0=500, sampling_T1=400, T=[400, 500], sampling_T=500, use_wandb=False,
    )
    stack = np.concatenate([frames[400], frames[500]])
    temps = np.concatenate([np.full(48, 400.0), np.full(48, 500.0)])
    lat_cfg = MDQM9Config(**base)
    lat = train_latent(lat_cfg, MDQM9LatentDataset.from_arrays(stack, temps, mol, t_cond=1),
                       device="cpu")
    lat_out = sample_latent(lat_cfg, lat["model"], lat["params"], lat["template"],
                            n_samples=16, batch_size=8, device="cpu")
    latent_z, x0_ambient = lat_out["samples"][:, 0], lat_out["samples"][:, -1]
    latent_dlogp = lat_out["dlogps"]

    amb_cfg = MDQM9Config(**base)
    amb_ds = MDQM9AmbientDataset.from_arrays(stack, temps, mol)
    amb = train_ambient(amb_cfg, amb_ds, amb_ds, device="cpu")
    out = sample_ambient(amb_cfg, amb["model"], amb["params"], amb["template"], x0_ambient,
                         latent_z=latent_z, latent_dlogp=latent_dlogp, batch_size=8,
                         device="cpu")
    assert out["latent_noises"].shape == (16, 5, 3)
    np.testing.assert_array_equal(out["latent_noises"], latent_z)
    np.testing.assert_array_equal(out["latent_dlogps"], latent_dlogp)
    np.testing.assert_array_equal(out["samples"][:, 0], x0_ambient)
    E1 = np.random.default_rng(0).normal(5.0, 0.2, 16)
    w = calc_importance_weights(out["latent_noises"], E1,
                                neg_dlogps_bg=out["latent_dlogps"], neg_dlogps_ti=out["dlogps"])
    assert np.all(np.isfinite(w)) and np.all(w > 0)
    assert 1.0 <= calc_ess(w) <= 16.0


# ---------------------------------------------------------------- the oracle

T_LAT, JITTER_LAT, ORACLE_N = 300, 0.25, 4


@pytest.mark.slow
def test_latent_bg_partition_function(tmp_path):
    """tests/test_mdqm9_physics.py::test_latent_bg_partition_function on the
    port: a generator ``train_latent`` trains on the CPU (4 atoms, F = 16, 2
    layers, 2048 frames of an origin-centred isotropic well, sigma = 0.25,
    60 epochs of batch 64) and 512 samples from ``sample_latent`` (RK4-64,
    exact stage-coupled dlogp). The importance weights w = exp(-u) / q
    estimate Z = (2 pi sigma^2)^(3(N-1)/2) whatever the generator:
    |-log Z err| < 0.2 and ESS > 10% of the samples."""
    mol = make_synthetic_molecule(n_atoms=ORACLE_N, seed=0)
    sigma = JITTER_LAT * np.sqrt(T_LAT / 300.0)
    rng = np.random.default_rng(7)
    frames = sigma * rng.standard_normal((2048, ORACLE_N, 3)).astype(np.float32)
    frames -= frames.mean(axis=1, keepdims=True)
    cfg = MDQM9Config(
        n_features=16, score_layers=2, batch_size=64, n_epochs=60, learning_rate=2e-3,
        scale_trajs=False, T=[T_LAT], sampling_T=T_LAT, solver_type="rk4", n_steps=64,
        return_dlogp=True, divergence="exact", model_save_path=str(tmp_path / "models"),
        data_save_path=str(tmp_path / "out"), use_wandb=False,
    )
    ds = MDQM9LatentDataset.from_arrays(frames, np.full(len(frames), float(T_LAT)), mol,
                                        t_cond=0, align=True)
    res = train_latent(cfg, ds, device="cpu")
    out = sample_latent(cfg, res["model"], res["params"], res["template"], n_samples=512,
                        save=False, batch_size=256, device="cpu")
    z, x, dlogp = out["samples"][:, 0], out["samples"][:, -1], out["dlogps"]
    d_eff = 3 * (ORACLE_N - 1)
    xc = x - x.mean(axis=1, keepdims=True)
    u = np.sum(xc ** 2, axis=(1, 2)) / (2.0 * sigma ** 2)
    log_pz = -0.5 * np.sum(z ** 2, axis=(1, 2)) - 0.5 * d_eff * np.log(2 * np.pi)
    log_w = -u - log_pz - dlogp
    mx = log_w.max()
    neg_log_Z_est = -(mx + np.log(np.mean(np.exp(log_w - mx))))
    neg_log_Z_exact = -0.5 * d_eff * np.log(2 * np.pi * sigma ** 2)
    assert abs(neg_log_Z_est - neg_log_Z_exact) < 0.2, (neg_log_Z_est, neg_log_Z_exact)
    assert calc_ess(np.exp(log_w - mx)) > 0.1 * len(x)
    width = np.sqrt(np.sum(xc ** 2, axis=(1, 2)).mean() / d_eff)
    assert abs(width - sigma) < 0.5 * sigma, (width, sigma)
