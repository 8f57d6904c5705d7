"""The port's training stack (ti_torch/train, the ambient dataset, the
flax-style initialisation) against ti_tpu's, and its harmonic TFEP oracle.

What is held against ti_tpu on the same inputs: a fresh CPaiNN's per-leaf
law (std within 5% of flax ``model.init``'s at F = 128, pooled over 64
draws a side), the optimizer step fed identical gradients (rtol 1e-6,
clip active, weight decay 1e-3), ``ReduceLROnPlateau`` on one metric
sequence (exact), ``epoch_batches`` under ti_tpu's permutation (exact),
``load_trajs``/``MDQM9AmbientDataset.load`` on a reference-layout file
(exact), and a trained checkpoint carried into ti_tpu's ``apply_dense``
through ``params_to_flax`` (rtol 1e-5). The rest is the port's own
bookkeeping: grad accumulation against the full batch, the NaN guard,
checkpoint names and resume, and the refusal to run without a card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu.data import mdqm9 as jax_mdqm9
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.models.cpainn_dense import apply_dense as jax_apply_dense
from ti_tpu.train import common as jax_common
from ti_torch.analysis.free_energy import calc_phis_tfep, calc_tfep_dF
from ti_torch.analysis.weights import calc_ess
from ti_torch.config import MDQM9Config
from ti_torch.data import mdqm9
from ti_torch.data.mdqm9 import MDQM9AmbientDataset, make_synthetic_frames, make_synthetic_molecule
from ti_torch.interpolants import linear
from ti_torch.losses import molecular_velocity_loss
from ti_torch.models.convert import _flatten, _leaf_to_torch, params_to_flax
from ti_torch.models.cpainn import CPaiNN
from ti_torch.models.cpainn_dense import apply_dense
from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of
from ti_torch.train import common, train_ambient
from ti_torch.train.ambient import build_ambient_model

OPT_BAR = dict(rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------- initialisation

def _leaf_values(tree):
    """{state-dict name: flat values} of a (batched) flax tree."""
    out = {}
    for path, arr in _flatten(tree["params"]):
        name, _ = _leaf_to_torch(path, np.zeros(0))
        out[name] = np.asarray(arr, np.float64).ravel()
    return out


def test_fresh_model_draws_as_flax_init():
    f, draws, n = 128, 64, 19
    jt = jax_mdqm9.graph_template(jax_mdqm9.make_synthetic_molecule(n, seed=0), t_cond=2)
    jm = JaxCPaiNN(n_features=f, score_layers=1)
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    ref = _leaf_values(jax.vmap(lambda k: jm.init(k, jt))(keys))
    gen = torch.Generator().manual_seed(0)
    models = [CPaiNN(f, 1, n_atoms=n, generator=gen) for _ in range(draws)]
    assert set(ref) == set(models[0].state_dict())
    for name, r in ref.items():
        p = np.concatenate([m.state_dict()[name].double().numpy().ravel() for m in models])
        assert p.size == r.size, name
        if r.std() == 0.0:  # biases, LayerNorm scales and biases: constants
            assert np.array_equal(np.unique(p), np.unique(r)), name
            continue
        assert abs(p.std() / r.std() - 1.0) < 0.05, (name, p.std(), r.std())
        assert abs(p.mean() - r.mean()) < 0.05 * r.std(), name
        # lecun-normal kernels are truncated at two standard deviations of
        # the underlying normal, the embeddings are not
        truncated = not name.endswith("embed.weight")
        assert (np.abs(p).max() <= 2.0 * r.std() / 0.8796 * 1.01) == truncated, name
    # an explicit generator makes the draws reproducible
    a = CPaiNN(16, 1, n_atoms=5, generator=torch.Generator().manual_seed(3)).state_dict()
    b = CPaiNN(16, 1, n_atoms=5, generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------- optimizer

def _opt_case(seed, big):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": np.zeros(3, np.float32), "v": rng.standard_normal(5).astype(np.float32)}
    scale = 3.0 if big else 0.05
    grads = [{k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("clip_active", [True, False])
def test_optimizer_step_matches_optax_chain(clip_active):
    params, grads = _opt_case(0, clip_active)
    lr, wd = 1e-2, 1e-3
    tx = jax_common.make_optimizer(weight_decay=wd, clip=1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    names = list(params)
    tp = [torch.from_numpy(params[k].copy()).requires_grad_(True) for k in names]
    opt = common.make_optimizer(tp, lr, weight_decay=wd, clip=1.0)
    for g in grads:
        norm = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in g.values()))
        assert (norm > 1.0) == clip_active
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = {k: jp[k] - lr * updates[k] for k in names}
        opt.step(torch.tensor(0.5), [torch.from_numpy(g[k].copy()) for k in names])
        adam = jstate[-1]
        assert opt.count == int(adam.count)
        for i, (k, p) in enumerate(zip(names, tp)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), **OPT_BAR)
            np.testing.assert_allclose(opt.mu[i].numpy(), np.asarray(adam.mu[k]), **OPT_BAR)
            np.testing.assert_allclose(opt.nu[i].numpy(), np.asarray(adam.nu[k]), **OPT_BAR)
    assert opt.nan_count == 0 and opt.lr == lr


def test_nan_guard_moves_nothing():
    params, grads = _opt_case(1, True)
    tp = [torch.from_numpy(v.copy()).requires_grad_(True) for v in params.values()]
    opt = common.make_optimizer(tp, 1e-2, weight_decay=1e-3)

    def loss_fn(gen, x, bad):
        loss = sum((p * x).sum() for p in tp)
        return loss * float("nan") if bad else loss

    step = common.make_update_step(loss_fn, opt)
    x = torch.tensor(0.3)
    assert np.isnan(step(None, x, True))
    assert opt.nan_count == 1 and opt.count == 0  # no step count
    assert all(not m.any() and not v.any() for m, v in zip(opt.mu, opt.nu))  # no moment
    assert all(np.array_equal(p.detach().numpy(), v) for p, v in zip(tp, params.values()))
    assert np.isfinite(step(None, x, False))
    before = [p.detach().clone() for p in tp]
    moments = [t.clone() for t in opt.mu + opt.nu]
    assert np.isnan(step(None, x, True))
    assert opt.nan_count == 2 and opt.count == 1
    assert all(torch.equal(p.detach(), b) for p, b in zip(tp, before))
    assert all(torch.equal(t, m) for t, m in zip(opt.mu + opt.nu, moments))


def test_grad_accum_matches_full_batch():
    """accum_steps=4 with a draw-independent loss reproduces the single-shot
    full-batch update (mean of microbatch gradients == full-batch gradient
    for a mean-reduced loss over equal microbatches)."""
    x = torch.arange(24.0).reshape(8, 3) / 7.0
    y = torch.linspace(-1, 1, 16).reshape(8, 2)

    def run(accum):
        w = (torch.arange(6.0).reshape(2, 3) / 10.0).requires_grad_(True)
        opt = common.make_optimizer([w], 1e-2, clip=1.0)

        def loss_fn(gen, xb, yb):
            return ((xb @ w.T - yb) ** 2).mean()

        loss = common.make_update_step(loss_fn, opt, accum_steps=accum)(None, x, y)
        return loss, w.detach()

    l1, w1 = run(1)
    l4, w4 = run(4)
    np.testing.assert_allclose(l4, l1, rtol=1e-6)
    np.testing.assert_allclose(w4.numpy(), w1.numpy(), rtol=1e-6, atol=1e-7)


def test_grad_accum_molecular_loss_runs():
    """Accumulation composes with the antithetic molecular loss: each
    microbatch takes its own draws; the loss is finite and the params move."""
    mol = make_synthetic_molecule(4, seed=0)
    template = mdqm9.graph_template(mol, t_cond=2)
    model = CPaiNN(8, 1, n_atoms=4, generator=torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    cfg = MDQM9Config(train_impl="dense", train_compute_dtype="bf16_agg")
    apply = common.make_batched_apply(cfg, model, template)
    interp = linear(a=1.0, gamma="sin2")
    opt = common.make_optimizer(list(params.values()), 1e-3)
    draws = []

    def loss_fn(gen, x0, x1, temps):
        draws.append(torch.rand(1, generator=gen))
        return molecular_velocity_loss(apply, params, x0, x1, temps, interp, generator=gen)

    step = common.make_update_step(loss_fn, opt, accum_steps=2)
    rng = np.random.default_rng(1)
    x0, x1 = (torch.from_numpy(rng.standard_normal((8, 4, 3)).astype(np.float32))
              for _ in range(2))
    temps = torch.tensor([[700.0, 300.0]]).expand(8, 2)
    before = {k: p.detach().clone() for k, p in params.items()}
    loss = step(torch.Generator().manual_seed(0), x0, x1, temps)
    assert np.isfinite(loss) and len(draws) == 2 and not torch.equal(draws[0], draws[1])
    assert any(not torch.equal(before[k], p.detach()) for k, p in params.items())


def test_batched_apply_routes():
    mol = make_synthetic_molecule(4, seed=0)
    template = mdqm9.graph_template(mol, t_cond=2)
    model = CPaiNN(8, 1, n_atoms=4)
    with pytest.raises(ValueError, match="requires train_impl='dense'"):
        common.make_batched_apply(MDQM9Config(train_compute_dtype="bf16_agg"), model, template)
    with pytest.raises(ValueError):
        common.make_batched_apply(MDQM9Config(train_impl="fused"), model, template)
    with pytest.raises(ValueError):
        common.make_batched_apply(MDQM9Config(train_impl="dense", train_compute_dtype="f16"),
                                  model, template)
    x = torch.from_numpy(0.3 * np.random.default_rng(0).standard_normal((2, 4, 3)).astype(np.float32))
    t, temps = torch.tensor([0.2, 0.7]), torch.tensor([[700.0, 300.0]] * 2)
    outs = {impl: common.make_batched_apply(MDQM9Config(train_impl=impl), model, template)(
        None, x, t, temps) for impl in ("edge", "dense")}
    torch.testing.assert_close(outs["edge"], outs["dense"], rtol=2e-3, atol=2e-4)


def test_plateau_scheduler_matches_jax():
    rng = np.random.default_rng(0)
    metrics = np.concatenate([np.linspace(0.5, -0.3, 8), -0.3 + 0.01 * rng.standard_normal(30),
                              np.linspace(-0.31, -0.5, 5), np.full(25, -0.5)])
    ours, theirs = common.ReduceLROnPlateau(), jax_common.ReduceLROnPlateau()
    lr_o = lr_t = 2e-3
    seq_o, seq_t = [], []
    for m in metrics:
        lr_o, lr_t = ours.step(float(m), lr_o), theirs.step(float(m), lr_t)
        seq_o.append(lr_o)
        seq_t.append(lr_t)
    assert seq_o == seq_t and min(seq_o) < 2e-3


# ---------------------------------------------------------------- data

def _frames(n_atoms=6, n=48):
    mol = make_synthetic_molecule(n_atoms, seed=2)
    frames = {T: make_synthetic_frames(mol, n, T, seed=T) for T in (300, 700)}
    stack = np.concatenate([frames[300], frames[700]])
    temps = np.concatenate([np.full(n, 300.0), np.full(n, 700.0)])
    return mol, stack, temps


def test_epoch_batches_match_jax_permutation():
    mol, stack, temps = _frames()
    jds = jax_mdqm9.MDQM9AmbientDataset.from_arrays(
        stack, temps, jax_mdqm9.make_synthetic_molecule(6, seed=2))
    ds = MDQM9AmbientDataset.from_arrays(stack, temps, mol)
    key = jax.random.PRNGKey(5)
    jx, jtemps = jds.epoch_batches(key, 16)
    perm = np.asarray(jax.random.permutation(key, len(stack)))
    x, t = ds.epoch_batches(None, 16, perm=perm)
    assert x.shape == (6, 16, 6, 3) and t.shape == (6, 16) and x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jtemps))


def test_epoch_batches_from_a_generator():
    mol, stack, temps = _frames(n=50)  # 100 frames: 6 batches of 16, the tail of 4 dropped
    ds = MDQM9AmbientDataset.from_arrays(stack, temps, mol)
    a, ta = ds.epoch_batches(torch.Generator().manual_seed(0), 16)
    b, _ = ds.epoch_batches(torch.Generator().manual_seed(0), 16)
    c, _ = ds.epoch_batches(torch.Generator().manual_seed(1), 16)
    assert a.shape == (6, 16, 6, 3) and torch.equal(a, b) and not torch.equal(a, c)
    # every batch row is a frame of the dataset with its own temperature
    flat, flat_t = a.reshape(-1, 6, 3).numpy(), ta.reshape(-1).numpy()
    idx = [int(np.flatnonzero((stack == row).all(axis=(1, 2)))[0]) for row in flat]
    assert len(set(idx)) == 96 and np.array_equal(temps[idx], flat_t)
    np.testing.assert_allclose(flat.mean(axis=1), 0.0, atol=1e-5)


def _write_sdf(path, mol, index):
    """SDF with `index+1` records; the target molecule is last."""
    lines = []
    n, nb = mol.n_atoms, mol.bond_index.shape[1] // 2
    for rec in range(index + 1):
        lines.append(f"mol{rec}\n  synthetic\n")
        lines.append(f"{n:3d}{nb:3d}  0  0  0  0  0  0  0  0999 V2000")
        for i in range(n):
            x, y, z = mol.positions[i]
            sym = {1: "H", 6: "C", 7: "N", 8: "O"}[int(mol.atomic_numbers[i])]
            lines.append(f"{x:10.4f}{y:10.4f}{z:10.4f} {sym:<3}0  0  0  0  0  0  0  0  0  0  0  0")
        seen = set()
        for s, d, t in zip(*mol.bond_index, mol.bond_types):
            if (d, s) in seen:
                continue
            seen.add((s, d))
            lines.append(f"{s + 1:3d}{d + 1:3d}{t:3d}  0")
        lines.append("M  END\n$$$$")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_reference_layout_ingest_matches_jax(tmp_path):
    mol = make_synthetic_molecule(5, seed=1)
    os.makedirs(tmp_path / "train")
    all_T = np.stack([make_synthetic_frames(mol, 16, T, seed=T) + 0.7 for T in mdqm9.TEMPERATURES])
    np.save(tmp_path / "train" / "00002.npy", all_T)
    _write_sdf(tmp_path / "mdqm9.sdf", mol, 2)
    assert mdqm9.TEMPERATURES == jax_mdqm9.TEMPERATURES
    for fname in ("00031.npy", "10506.npy", "other.npy"):
        assert mdqm9.scaling_factor_for(fname) == jax_mdqm9.scaling_factor_for(fname)
    for scale in (True, False):
        got = mdqm9.load_trajs(str(tmp_path), "train", "00002.npy", 500, scale)
        ref = jax_mdqm9.load_trajs(str(tmp_path), "train", "00002.npy", 500, scale)
        assert got.dtype == np.float32 and got.shape == (16, 5, 3)
        np.testing.assert_array_equal(got, ref)
    kw = dict(traj_path=str(tmp_path), sdf_path=str(tmp_path), traj_filename="00002.npy",
              Ts=(300, 1000), scale=True)
    ds = MDQM9AmbientDataset.load(**kw)
    jds = jax_mdqm9.MDQM9AmbientDataset.load(**kw)
    np.testing.assert_array_equal(ds.frames, jds.frames)
    np.testing.assert_array_equal(ds.temps, jds.temps)
    np.testing.assert_array_equal(ds.mol.atomic_numbers, jds.mol.atomic_numbers)
    np.testing.assert_array_equal(ds.template.atom_ids, np.asarray(jds.template.atom_ids))
    for field in ("src", "dst", "edge_type"):
        np.testing.assert_array_equal(np.asarray(getattr(ds.template.edges, field)),
                                      np.asarray(getattr(jds.template.edges, field)))
    assert ds.template.t_cond == 2 and len(ds) == 32


# ---------------------------------------------------------------- the trainer

def _tiny_cfg(tmp_path, **kw):
    base = dict(n_features=8, score_layers=1, batch_size=16, n_epochs=2, learning_rate=2e-3,
                gamma="brownian", a=0.1, temp_length=8.0, scale_trajs=False,
                T0s=[300, 700], T1s=[300, 700], model_save_path=str(tmp_path / "models"),
                model_save_name="tiny", use_wandb=False)
    base.update(kw)
    return MDQM9Config(**base)


def _tiny_datasets(n=32):
    mol, stack, temps = _frames(4, n)
    return (MDQM9AmbientDataset.from_arrays(stack, temps, mol),
            MDQM9AmbientDataset.from_arrays(stack[::-1].copy(), temps[::-1].copy(), mol))


def test_train_ambient_bookkeeping_and_resume(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    ds0, ds1 = _tiny_datasets()
    res = train_ambient(cfg, ds0, ds1, device="cpu")
    assert set(res) == {"params", "best_params", "model", "template", "history", "state"}
    assert set(res["history"]) == {"train_loss", "last_train_loss", "epoch_best_loss"}
    assert all(len(v) == 2 and np.isfinite(v).all() for v in res["history"].values())
    assert all(b <= m for b, m in zip(res["history"]["epoch_best_loss"],
                                      res["history"]["train_loss"]))
    save_dir = tmp_path / "models" / "tiny"
    assert sorted(os.listdir(save_dir)) == sorted(
        ["settings.json"] + [f"tiny_{e}_weights.npz" for e in ("0", "1", "best0", "best1")])
    last = common.load_checkpoint(str(save_dir / "tiny_1_weights.npz"))
    best = common.load_checkpoint(str(save_dir / "tiny_best1_weights.npz"))
    assert set(last) == set(res["model"].state_dict())
    assert all(torch.equal(last[k], res["params"][k]) for k in last)
    assert all(torch.equal(best[k], res["best_params"][k]) for k in best)
    assert res["state"].nan_count == 0 and res["state"].lr == 2e-3
    assert isinstance(res["state"], common.Optimizer)

    # resume from "best1": the weights load, the epoch counter starts at 2
    cfg_r = _tiny_cfg(tmp_path, use_pretrained=True, model_epoch="best1", n_epochs=0)
    again = train_ambient(cfg_r, ds0, ds1, device="cpu")
    assert all(torch.equal(again["params"][k], best[k]) for k in best)
    cfg_r.n_epochs = 1
    train_ambient(cfg_r, ds0, ds1, device="cpu")
    assert {"tiny_2_weights.npz", "tiny_best2_weights.npz"} <= set(os.listdir(save_dir))
    assert "tiny_3_weights.npz" not in os.listdir(save_dir)

    # the checkpoint reaches ti_tpu's dense forward through params_to_flax
    jt = jax_mdqm9.graph_template(jax_mdqm9.make_synthetic_molecule(4, seed=2), t_cond=2)
    jm = JaxCPaiNN(n_features=8, score_layers=1, temp_length=8.0)
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_flax(last))
    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal((3, 4, 3))).astype(np.float32)
    t = np.array([0.1, 0.5, 0.9], np.float32)
    temps = np.tile(np.array([700.0, 300.0], np.float32), (3, 1))
    ref = np.asarray(jax_apply_dense(jm, jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps),
                                     jt.atom_ids, jt.edges))
    out = apply_dense(res["model"], res["params"], torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(temps), res["template"].atom_ids, res["template"].edges)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5, atol=1e-6)


def test_train_ambient_needs_a_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds0, ds1 = _tiny_datasets()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ambient(_tiny_cfg(tmp_path), ds0, ds1)
    assert not (tmp_path / "models").exists()  # it refused before doing anything


def test_build_ambient_model_follows_the_config():
    m = build_ambient_model(MDQM9Config(n_features=8, score_layers=2, temp_length=8.0,
                                        cutoff=5.0), n_atoms=30)
    assert (m.n_features, m.score_layers, m.temp_length, m.cutoff) == (8, 2, 8.0, 5.0)
    assert m.atom_embed.weight.shape == (30, 8) and m.conditioning == "ambient"
    assert build_ambient_model(MDQM9Config(n_features=8, score_layers=1)).cutoff is None


# ---------------------------------------------------------------- the oracle

T0, T1, ORACLE_N, JITTER = 1000, 300, 4, 0.4


def _sigma(T):
    return JITTER * np.sqrt(T / 300.0)


@pytest.mark.slow
def test_harmonic_tfep_oracle(tmp_path):
    """The port trains a small field on exact Boltzmann samples of a
    harmonic well (sigma_T = 0.4 sqrt(T/300), COM-centred) and transports
    fresh T0 samples to T1 with the exact stage-coupled dlogp: the TFEP ΔF
    matches the closed form -3(N-1) ln(sigma_T1/sigma_T0), enough samples
    carry weight, and the width moves toward sigma_T1. The shape of
    tests/test_mdqm9_physics.py::test_tfep_matches_closed_form."""
    mol = make_synthetic_molecule(ORACLE_N, seed=0)
    frames = {T: make_synthetic_frames(mol, 1024, T, seed=T, jitter=JITTER) for T in (T0, T1)}
    stack = np.concatenate([frames[T0], frames[T1]])
    temps = np.concatenate([np.full(1024, float(T0)), np.full(1024, float(T1))])
    cfg = MDQM9Config(n_features=16, score_layers=2, batch_size=64, n_epochs=60,
                      learning_rate=2e-3, gamma="brownian", a=0.1, temp_length=8.0,
                      scale_trajs=False, T0s=[T0, T1], T1s=[T0, T1],
                      model_save_path=str(tmp_path / "models"), use_wandb=False)
    res = train_ambient(cfg, MDQM9AmbientDataset.from_arrays(stack, temps, mol),
                        MDQM9AmbientDataset.from_arrays(stack, temps, mol), device="cpu")

    x0 = make_synthetic_frames(mol, 512, T0, seed=999, jitter=JITTER)
    sampler = make_ode_sampler(
        molecular_v_fn_of(res["model"], res["params"], res["template"], device="cpu"),
        solver="rk4", n_steps=64, n_save=2, return_dlogp=True, divergence="exact", device="cpu")
    conds = np.tile(np.array([T0, T1], np.float32), (len(x0), 1))
    sol = sampler(x0, conds, torch.Generator().manual_seed(0))
    x1, dlogp = sol.xs[:, -1].numpy(), sol.dlogp[:, -1].numpy()

    p_eq = (mol.positions - mol.positions.mean(axis=0, keepdims=True)).astype(np.float32)

    def energy(x, T):
        xc = x - x.mean(axis=-2, keepdims=True)
        return np.sum((xc - p_eq) ** 2, axis=(-2, -1)) / (2.0 * _sigma(T) ** 2)

    phis, _ = calc_phis_tfep(energy(x0, T0), energy(x1, T1), dlogp)
    dF_est = calc_tfep_dF(phis)
    dF_exact = -3 * (ORACLE_N - 1) * np.log(_sigma(T1) / _sigma(T0))
    assert abs(dF_est - dF_exact) < 0.2, (dF_est, dF_exact)
    w = np.exp(-phis - np.max(-phis))
    assert calc_ess(w) > 0.02 * len(x0)
    x1c = x1 - x1.mean(axis=1, keepdims=True)
    width = np.sqrt(np.sum((x1c - p_eq) ** 2, axis=(1, 2)).mean() / (3 * (ORACLE_N - 1)))
    assert abs(width - _sigma(T1)) < abs(width - _sigma(T0))
