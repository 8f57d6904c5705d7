"""The port's user CLIs (ti_torch/cli) against the JAX package's scripts
(scripts/*.py), each run in-process through ``main(argv)`` on the CPU
(``--device cpu``) at N = 5 atoms, F = 16, one message layer, on a
synthetic workspace in the reference's on-disk layout.

- ``parse`` gives the config of ti_tpu's script for the same argv lists
  (``--preset``, ``--config``, ``--fast_profile``, typed and JSON-list
  overrides).
- The deterministic CLIs (``mdqm9_results``, ``mdqm9_gedmd``,
  ``model_selection``, ``adw_reweight_gedmd``) give the JAX script's
  output on the same files: the same saved names, the statistics at rtol
  1e-10 (ti_tpu's numpy against the port's BLAS-ordered Grams, the bar of
  tests/test_torch_adw.py), the z-matrix marginals at f32's rtol 1e-5 /
  atol 1e-6 (torsions modulo 2 pi, the bar of tests/test_torch_zmatrix.py),
  and the same printed lines. They run on the host, with no card.
- The samplers (``mdqm9_sample_latent``, ``mdqm9_sample_sde``,
  ``adw_sample``) write the JAX script's artifact names and shapes; the
  JAX scripts read the port's checkpoints through a stand-in for
  ti_tpu's orbax loader (``_jax_reads_port_checkpoints``). The CLIs'
  artifacts equal, to the bit, the drivers called directly with the same
  config and seed.
- ``eval_energy`` refuses without OpenMM, and every CLI that computes on
  the card raises, with no card present, unless given ``--device``.
"""

import contextlib
import dataclasses
import io
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ti_tpu.train.common as jax_train_common
from scripts import adw_train as jax_adw_train
from scripts import mdqm9_gedmd as jax_gedmd
from scripts import mdqm9_results as jax_results
from scripts import mdqm9_train_ambient as jax_train_ambient
from scripts import mdqm9_train_latent as jax_train_latent
from scripts import model_selection as jax_model_selection
from ti_torch.cli import (
    adw_reweight_gedmd,
    adw_sample,
    adw_train,
    eval_energy,
    mdqm9_gedmd,
    mdqm9_plots,
    mdqm9_results,
    mdqm9_sample_latent,
    mdqm9_sample_sde,
    mdqm9_train_ambient,
    mdqm9_train_latent,
    model_selection,
)
from ti_torch.data.mdqm9 import make_synthetic_frames, write_synthetic_workspace
from ti_torch.models.convert import params_to_flax
from ti_torch.train.common import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = dict(rtol=1e-10, atol=1e-12)
MARGINALS = dict(rtol=1e-5, atol=1e-6)
# the latent route the JAX side can afford here: fast_profile without the
# Pallas kernels (their interpret mode takes seconds a call on the CPU)
LATENT_FAST = ["--fast_profile", "--num_probes", "2", "--dlogp_quad_points", "2", "--n_steps", "3"]
# the latent kernel route (B1, B3's full frame; their plain versions on the CPU)
LATENT_KERNEL = ["--fast_profile", "--compute_dtype", "f32", "--traj_forward_impl",
                 "pair_kernel", "--div_forward_impl", "pair_tangent", "--n_steps", "9"]


def _run_jax_script(monkeypatch, script, argv):
    """Run ``scripts/<script>`` as ``__main__`` in this process."""
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(sys, "argv", [script] + list(argv))
    runpy.run_path(os.path.join(REPO, "scripts", script), run_name="__main__")


def _jax_reads_port_checkpoints(monkeypatch):
    """ti_tpu's loader reads the port's ``<path>.npz`` (the same names
    without the suffix: ``{name}_{epoch}``, ``{name}_{epoch}_weights``,
    ``epoch_{n}``) as the variables its trainers save."""
    def load(path, like=None):
        tree = params_to_flax(load_checkpoint(path + ".npz"))
        return {"params": jax.tree_util.tree_map(jnp.asarray, tree)}

    monkeypatch.setattr(jax_train_common, "load_checkpoint", load)


def _shapes(d):
    return {f: np.load(os.path.join(d, f)).shape for f in sorted(os.listdir(d))
            if f.endswith(".npy")}


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# ---------------------------------------------------------------------------
# parse
# ---------------------------------------------------------------------------

MDQM9_ARGVS = [
    ["--preset", "00031:300"],
    ["--preset", "10506:500", "--fast_profile"],
    ["--preset", "00031:300", "--fast_profile", "--num_probes", "4", "--n_steps", "9"],
    ["--n_features", "16", "--T", "[300, 500]", "--learning_rate", "0.002"],
    ["--config", "{cfg}", "--batch_size", "12"],
]
LATENT_ARGVS = [
    ["--preset", "00031"],
    ["--preset", "00031:800", "--fast_profile"],
    ["--preset", "00031:300"] + LATENT_KERNEL,
    ["--preset", "10506", "--fast_profile"],
    ["--config", "{cfg}", "--fast_profile", "--n_steps", "18"],
]
ADW_ARGVS = [
    [],
    ["--hidden_size", "16", "--beta1s", "[1.5]", "--dtype", "f64", "--epochs", "3"],
    ["--config", "{cfg}", "--n_step", "8"],
]


def _fill(argv, tmp_path, data):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(data))
    return [str(path) if a == "{cfg}" else a for a in argv]


@pytest.mark.parametrize("family,argv", [("ambient", a) for a in MDQM9_ARGVS]
                         + [("latent", a) for a in LATENT_ARGVS]
                         + [("adw", a) for a in ADW_ARGVS])
def test_parse_matches_jax(family, argv, tmp_path):
    ours, ref = {"ambient": (mdqm9_train_ambient.parse, jax_train_ambient.parse),
                 "latent": (mdqm9_train_latent.parse, jax_train_latent.parse),
                 "adw": (adw_train.parse, jax_adw_train.parse)}[family]
    data = ({"hidden_size": 32, "beta0s": [1.0], "lr": 0.01} if family == "adw"
            else {"n_features": 32, "T": [300, 500], "score_layers": 2})
    argv = _fill(argv, tmp_path, data)
    assert dataclasses.asdict(ours(list(argv))) == dataclasses.asdict(ref(list(argv)))


# ---------------------------------------------------------------------------
# the MDQM9 samplers: latent and SDE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The synthetic workspace, a latent and an ambient checkpoint trained
    for one epoch through the train CLIs, and the flags the CLIs share."""
    root = tmp_path_factory.mktemp("torch_cli_scripts")
    write_synthetic_workspace(str(root), n_atoms=5, n_frames=12)
    common = [
        "--traj_path", str(root / "trajs"), "--sdf_path", str(root),
        "--model_save_path", str(root / "models"),
        "--n_features", "16", "--score_layers", "1", "--batch_size", "8",
        "--n_epochs", "1", "--n_steps", "4", "--solver_type", "rk4", "--model_epoch", "0",
    ]
    latent = common + ["--preset", "00031:300", "--model_save_name", "lat",
                       "--n_latent_samples", "8"]
    ambient = common + ["--preset", "00031:300", "--model_save_name", "amb"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mdqm9_train_latent.main(["--device", "cpu"] + latent) == 0
        assert mdqm9_train_ambient.main(["--device", "cpu"] + ambient) == 0
    trained = json.loads(out.getvalue().strip().splitlines()[-1])
    assert trained["epochs"] == 1 and np.isfinite(trained["train_loss"])
    assert (root / "models" / "lat" / "lat_0.npz").exists()
    assert (root / "models" / "amb" / "amb_0_weights.npz").exists()
    return root, latent, ambient


def test_sample_latent_kernel_route_equals_sample_latent(workspace, capsys):
    """The kernel-route flags through the CLI: the artifacts equal
    ``sample_latent`` called with the same config and seed, to the bit."""
    from ti_torch.data.mdqm9 import MDQM9LatentDataset
    from ti_torch.sampling.drivers import sample_latent
    from ti_torch.train.latent import build_latent_model

    root, latent, _ = workspace
    argv = latent + LATENT_KERNEL + ["--data_save_path", str(root / "lk"),
                                     "--data_save_name", "k"]
    assert mdqm9_sample_latent.main(["--device", "cpu"] + argv) == 0
    line = _last_json(capsys)
    assert line["n"] == 8 and line["seed"] == 0 and line["num_shards"] == 1
    assert set(line["launches"]) == {"pair_layer", "pair_tangent"}
    cfg = mdqm9_train_latent.parse(argv)
    assert (cfg.traj_forward_impl, cfg.div_forward_impl, cfg.compute_dtype) == \
        ("pair_kernel", "pair_tangent", "f32")
    ds = MDQM9LatentDataset.load(cfg.traj_path, cfg.sdf_path, cfg.mdqm9_traj_filename,
                                 cfg.sdf_filename, split="test", Ts=cfg.T)
    ref = sample_latent(cfg, build_latent_model(cfg, 5), load_checkpoint(
        str(root / "models" / "lat" / "lat_0.npz")), ds.template, save=False, device="cpu")
    for stem in ("samples", "dlogps"):
        np.testing.assert_array_equal(np.load(root / "lk" / f"{stem}_k_forward.npy"), ref[stem])


def test_sample_latent_artifacts_match_jax(workspace, monkeypatch, capsys):
    """Names and shapes of the JAX script's in shard 1 of 2 (the shard token
    before "_forward"), and the unsharded run's of the same family."""
    root, latent, _ = workspace
    _jax_reads_port_checkpoints(monkeypatch)
    argv = latent + LATENT_FAST + ["--data_save_name", "f"]
    shard = ["--shard", "1", "--num_shards", "2"]
    for extra in ([], shard):
        assert mdqm9_sample_latent.main(["--device", "cpu", "--data_save_path",
                                         str(root / "lt")] + argv + extra) == 0
    _run_jax_script(monkeypatch, "mdqm9_sample_latent.py",
                    ["--data_save_path", str(root / "lj")] + argv + shard)
    ours = _shapes(root / "lt")
    assert ours.pop("dlogps_f_forward.npy") == (8,)
    assert ours.pop("samples_f_forward.npy") == (8, 2, 5, 3)
    assert ours == _shapes(root / "lj") == {
        "dlogps_f_shard1of2_forward.npy": (4,), "samples_f_shard1of2_forward.npy": (4, 2, 5, 3)}
    assert "generated 4 conformations" in capsys.readouterr().out


@pytest.mark.parametrize("impl", ["pair_kernel", "dense"])
def test_sample_sde_equals_sample_molecular_sde(workspace, capsys, impl):
    """The CLI's samples equal ``sample_molecular_sde`` on the test split
    with the same config and seed, to the bit; B1's drift (``pair_kernel``,
    f32, chain_block 1) and the dense one."""
    from ti_torch.data.mdqm9 import MDQM9AmbientDataset
    from ti_torch.sampling.drivers import sample_molecular_sde
    from ti_torch.train.ambient import build_ambient_model

    root, _, ambient = workspace
    argv = ambient + ["--sde_forward_impl", impl, "--data_save_path", str(root / "sde"),
                      "--data_save_name", impl]
    assert mdqm9_sample_sde.main(["--device", "cpu"] + argv) == 0
    line = _last_json(capsys)
    assert (line["n"], line["n_steps"], line["impl"]) == (12, 4, impl)
    cfg = mdqm9_train_ambient.parse(argv)
    ds = MDQM9AmbientDataset.load(cfg.traj_path, cfg.sdf_path, cfg.mdqm9_traj_filename,
                                  cfg.sdf_filename, split="test", Ts=[cfg.sampling_T0])
    temps = np.tile(np.array([cfg.sampling_T0, cfg.sampling_T1], np.float32), (12, 1))
    ref = sample_molecular_sde(
        build_ambient_model(cfg, 5), load_checkpoint(str(root / "models" / "amb" /
                                                         "amb_0_weights.npz")),
        ds.template, ds.frames, temps, torch.Generator().manual_seed(cfg.seed), g_fn=cfg.sde_g,
        n_steps=cfg.n_steps, compute_dtype=None, forward_impl=impl, device="cpu")
    np.testing.assert_array_equal(np.load(root / "sde" / f"samples_{impl}_sde.npy"),
                                  ref.numpy())
    np.testing.assert_array_equal(np.load(root / "sde" / f"initial_samples_{impl}_sde.npy"),
                                  ds.frames)


def test_sample_sde_artifacts_match_jax(workspace, monkeypatch, capsys):
    """Names and shapes of the JAX script's: the "_sde" family, its shard
    token last; no dlogps."""
    root, _, ambient = workspace
    _jax_reads_port_checkpoints(monkeypatch)
    for extra in ([], ["--shard", "0", "--num_shards", "2"]):
        argv = ambient + ["--data_save_name", "run", "--sde_g", "0.05"] + extra
        assert mdqm9_sample_sde.main(["--device", "cpu", "--data_save_path",
                                      str(root / "st")] + argv) == 0
        _run_jax_script(monkeypatch, "mdqm9_sample_sde.py",
                        ["--data_save_path", str(root / "sj")] + argv)
    assert _shapes(root / "st") == _shapes(root / "sj") == {
        "initial_samples_run_sde.npy": (12, 5, 3), "samples_run_sde.npy": (12, 2, 5, 3),
        "initial_samples_run_sde_shard0of2.npy": (6, 5, 3),
        "samples_run_sde_shard0of2.npy": (6, 2, 5, 3)}
    assert "sde-sampled 6 conformations" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the report, the figures and the kinetics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def report_inputs(tmp_path_factory):
    """Reference-layout artifacts for every source of the full report
    (tests/test_cli_scripts.py::test_mdqm9_results_full_report_cli's), and
    the legacy layout (samples and dlogps in one dir, energies in another)."""
    from ti_torch.data.mdqm9 import make_synthetic_molecule
    from ti_torch.data.sdf import write_sdf_v2000

    root = tmp_path_factory.mktemp("torch_cli_report")
    mol = make_synthetic_molecule(5, seed=0)
    write_sdf_v2000(str(root / "mdqm9.sdf"), mol, 31)
    rng = np.random.default_rng(0)
    n, tag = 40, "full"

    def frames(seed):
        return make_synthetic_frames(mol, n, 300, seed=seed)

    for name, with_latent in (("ambient_md", False), ("ambient_lti", True)):
        d = root / name
        d.mkdir()
        np.save(d / f"samples_{tag}.npy", np.stack([frames(1), frames(2)], axis=1))
        np.save(d / f"dlogps_{tag}.npy", rng.normal(0, 0.1, n))
        np.save(d / f"E0s_{tag}.npy", rng.normal(10, 0.5, n))
        np.save(d / f"E1s_{tag}.npy", rng.normal(10, 0.5, n))
        if with_latent:
            np.save(d / f"latent_noises_{tag}.npy", rng.standard_normal((n, 5, 3)))
            np.save(d / f"latent_dlogps_{tag}.npy", rng.normal(0, 0.1, n))
    latent = root / "latent"
    latent.mkdir()
    for T in (1000, 300):
        np.save(latent / f"samples_{T}K.npy",
                np.stack([rng.standard_normal((n, 5, 3)), frames(T)], axis=1))
        np.save(latent / f"dlogps_{T}K.npy", rng.normal(0, 0.1, n))
        np.save(latent / f"Es_{T}K.npy", rng.normal(10, 0.5, n))
    (root / "trajs" / "train").mkdir(parents=True)
    np.save(root / "trajs" / "train" / "00031.npy",
            np.stack([make_synthetic_frames(mol, 24, T, seed=T) for T in range(300, 1001, 100)]))
    return root, tag


def _assert_reports_equal(ours, ref):
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(ours)) == names and names
    for f in names:
        a, b = np.load(os.path.join(ours, f)), np.load(os.path.join(ref, f))
        assert a.shape == b.shape, f
        if f.startswith(("torsions", "z_matrix")):
            d = (a - b + np.pi) % (2 * np.pi) - np.pi if f.startswith("torsions") else a - b
            if f.startswith("z_matrix"):  # lengths, angles, then torsions
                d[..., 2] = (d[..., 2] + np.pi) % (2 * np.pi) - np.pi
            assert np.all(np.abs(d) <= MARGINALS["atol"] + MARGINALS["rtol"] * np.abs(b)), f
        elif f.startswith(("bond_angles", "bond_lengths")):
            np.testing.assert_allclose(a, b, **MARGINALS, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, **STATS, err_msg=f)


def _printed(capsys, *dirs):
    out = capsys.readouterr().out
    for i, d in enumerate(dirs):
        out = out.replace(str(d), f"<dir{i}>")
    return out


@pytest.mark.parametrize("mode", ["full", "legacy"])
def test_results_match_jax(report_inputs, monkeypatch, capsys, tmp_path, mode):
    """The full multi-source report (with the z-matrices saved) and the
    legacy single-source mode: the JAX script's arrays and printed lines."""
    root, tag = report_inputs
    common = ["--sdf", str(root / "mdqm9.sdf"), "--mol_index", "31", "--tag", tag,
              "--n_bootstrap", "10", "--scaling_factor", "1.0"]
    if mode == "full":
        common += ["--md_ti_dir", str(root / "ambient_md"), "--bg_ti_dir",
                   str(root / "ambient_lti"), "--latent_dir", str(root / "latent"),
                   "--T0", "1000", "--T1", "300", "--traj_path", str(root / "trajs"),
                   "--save_z_matrices"]
    else:
        common += ["--data_dir", str(root / "ambient_lti"), "--energy_dir",
                   str(root / "ambient_lti")]
    monkeypatch.setattr(sys, "argv", ["mdqm9_results.py"] + common + ["--out",
                                                                      str(tmp_path / "j")])
    jax_results.main()
    ref_out = _printed(capsys, tmp_path / "j")
    assert mdqm9_results.main(common + ["--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert _printed(capsys, tmp_path / "t") == ref_out
    _assert_reports_equal(tmp_path / "t", tmp_path / "j")


def test_plots_render_the_report(report_inputs, tmp_path, capsys):
    """The 10506 figure path over a full report the port wrote: marginals
    against the MD reference (the bond_lengths_md_1 naming quirk), TICA,
    the report's saved weights; then the eigenvalue figure; a weights /
    marginals mismatch refused with both paths named."""
    root, tag = report_inputs
    res = tmp_path / "results"
    assert mdqm9_results.main([
        "--sdf", str(root / "mdqm9.sdf"), "--mol_index", "31", "--tag", tag,
        "--md_ti_dir", str(root / "ambient_md"), "--T0", "1000", "--T1", "300",
        "--traj_path", str(root / "trajs"), "--scaling_factor", "1.0", "--n_bootstrap", "10",
        "--out", str(res), "--device", "cpu"]) == 0
    fig = tmp_path / "figures"
    assert mdqm9_plots.main(["--results_dir", str(res), "--tag", "md_ti_1", "--ref_tag",
                             "md_T1", "--weights", "weights_md_ti", "--lag", "2",
                             "--out", str(fig)]) == 0
    for name in ("torsions_md_ti_1", "bond_angles_md_ti_1", "bond_lengths_md_ti_1",
                 "tica_md_ti_1"):
        assert (fig / f"{name}.png").exists(), name
    eigs = tmp_path / "eigs"
    eigs.mkdir()
    for part, val in (("temps", [300.0, 400.0]), ("eigenvalues_mean", [[0, -1.0]] * 2),
                      ("eigenvalues_lower_bound", [[0, -1.2]] * 2),
                      ("eigenvalues_upper_bound", [[0, -0.8]] * 2)):
        np.save(eigs / f"md_{part}.npy", np.asarray(val))
    assert mdqm9_plots.main(["--eigs_dir", str(eigs), "--out", str(fig)]) == 0
    assert (fig / "eigenvalues_vs_T.png").exists()
    np.save(res / "weights_short.npy", np.ones(7))
    with pytest.raises(SystemExit, match="length mismatch"):
        mdqm9_plots.main(["--results_dir", str(res), "--tag", "md_ti_0", "--weights",
                          "weights_short", "--out", str(fig)])


def test_plots_refuse_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Where matplotlib is missing (the card's machine) the figures are
    refused with exit code 2 and a message, before anything is written."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    assert mdqm9_plots.main(["--eigs_dir", str(tmp_path), "--out",
                             str(tmp_path / "figs")]) == 2
    assert "matplotlib is not available" in capsys.readouterr().err
    assert not (tmp_path / "figs").exists()


def test_gedmd_matches_jax(tmp_path, monkeypatch, capsys):
    """Torsion files at two temperatures, with and without resampling
    weights; no card needed."""
    _no_card(monkeypatch)
    rng = np.random.default_rng(0)
    for T in (300, 400):
        np.save(tmp_path / f"torsions_{T}k.npy", rng.uniform(-np.pi, np.pi, (300, 3)))
        np.save(tmp_path / f"weights_{T}k.npy", rng.uniform(0.5, 1.5, 300))
    for extra in ([], ["--weights_pattern", str(tmp_path / "weights_{T}k.npy")]):
        argv = ["--pattern", str(tmp_path / "torsions_{T}k.npy"), "--temps", "300,400",
                "--src", "md", "--p", "20", "--n_bootstrap", "20", "--max_samples", "200",
                *extra]
        jax_gedmd.main(argv + ["--out_dir", str(tmp_path / "j")])
        ref_out = _printed(capsys, tmp_path / "j")
        assert mdqm9_gedmd.main(argv + ["--out_dir", str(tmp_path / "t")]) == 0
        assert _printed(capsys, tmp_path / "t") == ref_out and "lambda_2" in ref_out
        _assert_reports_equal(tmp_path / "t", tmp_path / "j")


def test_model_selection_matches_jax(tmp_path, monkeypatch, capsys):
    """tests/test_cli_scripts.py::test_model_selection_cli's two modes (ADW
    artifacts, molecular torsions) on the same files; no card needed."""
    _no_card(monkeypatch)
    rng = np.random.default_rng(0)
    d = tmp_path / "velocity" / "beta_1.0_to_1.25"
    d.mkdir(parents=True)
    x = np.zeros(2000)
    for i in range(1, len(x)):
        x[i] = 0.95 * x[i - 1] + 0.3 * rng.standard_normal()
    np.save(d / "samples_epoch_1.npy", np.stack([x, x]))
    np.save(tmp_path / "torsions_run.npy", rng.uniform(-np.pi, np.pi, (300, 3)))
    for i, argv in enumerate((
            ["--adw_dir", str(tmp_path / "velocity"), "--epoch", "1", "--beta", "1.25",
             "--sigmas", "0.3", "0.6", "--ps", "20", "40", "--ntest", "3"],
            ["--torsions", str(tmp_path / "torsions_run.npy"), "--T", "300", "--sigmas", "3.0",
             "5.0", "--ps", "20", "--ntest", "2"])):
        jax_model_selection.main(argv + ["--out", str(tmp_path / f"j{i}.npz")])
        ref_out = _printed(capsys, tmp_path)
        assert model_selection.main(argv + ["--out", str(tmp_path / f"t{i}.npz")]) == 0
        assert _printed(capsys, tmp_path).replace("/t", "/j") == ref_out
        ours, ref = np.load(tmp_path / f"t{i}.npz"), np.load(tmp_path / f"j{i}.npz")
        assert sorted(ours.files) == sorted(ref.files) and "VAMP" in ref.files
        for k in ref.files:
            np.testing.assert_allclose(ours[k], ref[k], **STATS, err_msg=k)


# ---------------------------------------------------------------------------
# the ADW chain
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def adw_chain(tmp_path_factory):
    """``adw_train`` for 2 epochs, then ``adw_sample`` (RK4-8) on the test
    split, through the CLIs on the CPU."""
    from ti_torch.data.adw import make_synthetic_adw_csv

    root = tmp_path_factory.mktemp("torch_cli_adw")
    make_synthetic_adw_csv(str(root / "samples.csv"), betas=[1.0, 1.25], n_samples=3000)
    common = ["--traj_path", str(root), "--model_save_path", str(root / "models"),
              "--data_save_path", str(root / "out"), "--n_samples", "2000",
              "--hidden_size", "16", "--num_layers", "2", "--epochs", "2",
              "--batch_size", "256", "--n_step", "8", "--solver_type", "rk4",
              "--sampling_epoch", "1"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert adw_train.main(["--device", "cpu"] + common) == 0
        assert adw_sample.main(["--device", "cpu"] + common) == 0
    trained, sampled = (json.loads(line) for line in out.getvalue().strip().splitlines()[-2:])
    # the 200-row validation split (10% of 2000) holds no batch of 256: NaN,
    # as ti_tpu's mean over an empty scan gives
    assert trained["epochs"] == 2 and np.isfinite(trained["train_loss"])
    assert np.isnan(trained["val_loss"])
    assert sampled["n"] > 0 and sampled["nfe"] > 0
    return root, common


def test_adw_sample_equals_sample_adw_and_jax_names(adw_chain, monkeypatch, capsys):
    """The CLI's artifacts equal ``sample_adw`` called directly, to the
    bit, and carry the JAX script's names and shapes (fixed-step samples
    (2, n))."""
    from ti_torch.data.adw import ADWDataset
    from ti_torch.sampling.drivers import sample_adw
    from ti_torch.train.adw import build_adw_model

    root, common = adw_chain
    cfg = adw_train.parse(common)
    _, _, test = ADWDataset.from_csv(str(root / "samples.csv"), cfg.beta0s, cfg.n_samples,
                                     seed=cfg.seed).splits()
    ref = sample_adw(cfg, build_adw_model(cfg), load_checkpoint(
        str(root / "models" / "velocity" / "epoch_1.npz")), test.x, test.beta.reshape(-1),
        save=False, device="cpu")
    ours = root / "out" / "velocity" / "beta_1.0_to_1.25"
    for stem in ("initial_samples", "samples", "dlogps"):
        np.testing.assert_array_equal(np.load(ours / f"{stem}_epoch_1.npy"), ref[stem])
    _jax_reads_port_checkpoints(monkeypatch)
    jcommon = [a if a != str(root / "out") else str(root / "jout") for a in common]
    _run_jax_script(monkeypatch, "adw_sample.py", jcommon)
    assert "sampled" in capsys.readouterr().out
    n = len(test.x)
    assert _shapes(ours) == _shapes(root / "jout" / "velocity" / "beta_1.0_to_1.25") == {
        "initial_samples_epoch_1.npy": (n,), "samples_epoch_1.npy": (2, n),
        "dlogps_epoch_1.npy": (2, n)}


@pytest.mark.parametrize("direct", [False, True], ids=["transport", "direct"])
def test_adw_reweight_gedmd_matches_jax(adw_chain, monkeypatch, capsys, tmp_path, direct):
    """Over the chain's artifacts (and the direct Boltzmann baseline over its
    initial samples): the JAX script's spectra and printed lines; no card."""
    root, _ = adw_chain
    _no_card(monkeypatch)
    argv = ["--data_dir", str(root / "out" / "velocity"), "--epoch", "1", "--betas", "1.25",
            "--n_bootstrap", "20", "--p", "20"] + (["--direct"] if direct else [])
    _run_jax_script(monkeypatch, "adw_reweight_gedmd.py", argv + ["--out",
                                                                  str(tmp_path / "j.npz")])
    ref_out = _printed(capsys, tmp_path / "j.npz")
    assert adw_reweight_gedmd.main(argv + ["--out", str(tmp_path / "t.npz")]) == 0
    assert _printed(capsys, tmp_path / "t.npz") == ref_out and "lambda_2" in ref_out
    ours, ref = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(ours.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_allclose(ours[k], ref[k], **STATS, err_msg=k)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_eval_energy_refuses_without_openmm(tmp_path, capsys):
    """As scripts/eval_energy.py (tests/test_cli_scripts.py::
    test_eval_energy_cli_gated): exit code 2 and the environment to use."""
    from ti_torch.analysis.energy import openmm_available

    assert not openmm_available()
    rc = eval_energy.main(["--sdf", "x.sdf", "--mol_index", "0", "--data_dir", str(tmp_path),
                           "--tag", "t", "--T0", "1000", "--T1", "300", "--charges", "c.npy"])
    assert rc == 2
    assert "dedicated energy environment" in capsys.readouterr().err


@pytest.mark.parametrize("cli", ["mdqm9_train_latent", "mdqm9_sample_latent",
                                 "mdqm9_sample_sde", "mdqm9_results", "adw_train",
                                 "adw_sample"])
def test_card_clis_raise_without_a_card(cli, tmp_path, monkeypatch):
    """No card and no ``--device``: each CLI that computes on the card
    raises before it reads or writes anything; none falls back to the CPU."""
    _no_card(monkeypatch)
    argv = {"mdqm9_results": ["--sdf", str(tmp_path / "x.sdf"), "--mol_index", "0", "--tag",
                              "t", "--data_dir", str(tmp_path)],
            "adw_train": ["--traj_path", str(tmp_path), "--model_save_path", str(tmp_path)],
            "adw_sample": ["--traj_path", str(tmp_path), "--model_save_path", str(tmp_path)],
            }.get(cli, ["--preset", "00031:300", "--traj_path", str(tmp_path),
                        "--model_save_path", str(tmp_path), "--data_save_path", str(tmp_path)])
    main = {"mdqm9_train_latent": mdqm9_train_latent.main,
            "mdqm9_sample_latent": mdqm9_sample_latent.main,
            "mdqm9_sample_sde": mdqm9_sample_sde.main, "mdqm9_results": mdqm9_results.main,
            "adw_train": adw_train.main, "adw_sample": adw_sample.main}[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert not os.listdir(tmp_path)
