"""The port's analysis layer against ``ti_tpu``'s, on the same seeded inputs.

- ``results``: ``generate_report`` and ``generate_full_report`` (every
  source, a partial set, the 10506 extras) give the same keys and save the
  same file names; ΔF, ESS and weights at rtol 1e-10 (the same host numpy
  on the same arrays), marginals at the float32 bar of
  tests/test_torch_zmatrix.py (rtol 1e-5 / atol 1e-6, torsions modulo 2π).
- ``kinetics``: spectra, model-selection grids and the chosen
  hyperparameters at rtol 1e-10 with an atol of 1e-10 of the largest
  eigenvalue (the bar of tests/test_torch_adw.py's gEDMD pipelines: the
  port forms the bootstrap's Grams as BLAS products); ``load_torsions`` in
  both on-disk layouts.
- ``plots``: the numpy helpers at 1e-12; every figure writes its file.
- ``energy`` and ``eval_dataset``: equal results, OpenMM faked in this file.
- ``gedmd.symbolic``: values, gradients and Hessians at float32 rtol 1e-5.
- the slice as a whole: ``sample_ambient`` then ``generate_report`` in both
  packages on the same weights and ``ti_tpu``'s probes.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_cli_scripts import _write_sdf
from ti_tpu.analysis import energy as jax_energy
from ti_tpu.analysis import kinetics as jax_kinetics
from ti_tpu.analysis import plots as jax_plots
from ti_tpu.analysis import results as jax_results
from ti_tpu.config import ambient_preset as jax_preset
from ti_tpu.config import fast_profile as jax_fast_profile
from ti_tpu.data.eval_dataset import MDQM9EvalDataset as JaxEvalDataset
from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.ops.divergence import _probe_block as jax_probe_block
from ti_tpu.sampling.drivers import sample_ambient as jax_sample_ambient
from ti_torch.analysis import energy, kinetics, plots, results
from ti_torch.analysis.sort_atoms import adjacency_from_bonds
from ti_torch.config import ambient_preset, fast_profile
from ti_torch.data.eval_dataset import MDQM9EvalDataset
from ti_torch.data.mdqm9 import graph_template, make_synthetic_frames, make_synthetic_molecule
from ti_torch.gedmd.symbolic import Sym2numeric, SymbolicBasis
from ti_torch.models.convert import params_from_flax
from ti_torch.models.cpainn import CPaiNN
from ti_torch.sampling import drivers

STATS_RTOL = 1e-10
Z_RTOL, Z_ATOL = 1e-5, 1e-6
MARGINALS = ("torsions", "bond_angles", "bond_lengths", "z_matri")  # z_matrix_*, z_matrices


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def _flat(v):
    """A report value as one float64 array: arrays, numbers and the
    (value, (lo, hi)) pairs of the bootstrap routes."""
    if isinstance(v, tuple):
        return np.concatenate([_flat(x) for x in v])
    return np.atleast_1d(np.asarray(v, dtype=np.float64))


def _assert_value(key, got, ref):
    if key.startswith(MARGINALS):
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32, key
        tors = key.startswith("torsions")
        if key.startswith("z_matri"):
            np.testing.assert_allclose(got[..., :2], ref[..., :2], rtol=Z_RTOL, atol=Z_ATOL)
            got, ref, tors = got[..., 2], ref[..., 2], True
        if tors:
            err = np.abs(_wrap(got - ref))
            assert np.all(err <= Z_ATOL + Z_RTOL * np.abs(ref)), (key, err.max())
        else:
            np.testing.assert_allclose(got, ref, rtol=Z_RTOL, atol=Z_ATOL, err_msg=key)
    else:
        np.testing.assert_allclose(_flat(got), _flat(ref), rtol=STATS_RTOL, atol=0, err_msg=key)


def _assert_reports_equal(got, ref):
    assert set(got) == set(ref)
    for key in ref:
        _assert_value(key, got[key], ref[key])


def _assert_saved_equal(got_dir, ref_dir):
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        _assert_value(name[:-4], np.load(os.path.join(got_dir, name)),
                      np.load(os.path.join(ref_dir, name)))


def _harmonic(x, T, p_eq, jitter=0.4):
    """tools/torch_ambient_oracle.py's stand-in energy: an isotropic well of
    width jitter * sqrt(T / 300) about the equilibrium geometry, in
    float64 as the OpenMM stage writes them."""
    x = np.asarray(x, dtype=np.float64)
    xc = x - x.mean(axis=-2, keepdims=True)
    return np.sum((xc - p_eq) ** 2, axis=(-2, -1)) / (2.0 * (jitter ** 2) * T / 300.0)


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

def test_generate_report_matches_jax(tmp_path):
    mol = make_synthetic_molecule(n_atoms=9, seed=0)
    frames = make_synthetic_frames(mol, 200, 300, seed=1)
    adj = adjacency_from_bonds(mol.n_atoms, mol.bond_index)
    rng = np.random.default_rng(0)
    E0s = rng.normal(10.0, 1.0, 200)
    E1s = E0s + rng.normal(0.5, 0.2, 200)
    nd = rng.normal(0.0, 0.1, 200)
    z0 = rng.standard_normal((200, 9, 3))
    kw = dict(neg_dlogps_ti=nd, E0s=E0s, E1s=E1s, latent_z=z0, neg_dlogps_bg=nd,
              n_bootstrap=50, tag="t")
    got = results.generate_report(adj, frames, save_path=str(tmp_path / "port"), device="cpu",
                                  **kw)
    ref = jax_results.generate_report(adj, frames, save_path=str(tmp_path / "jax"), **kw)
    _assert_reports_equal(got, ref)
    _assert_saved_equal(tmp_path / "port", tmp_path / "jax")
    assert {"z_matrices", "dF_tfep_md_ti", "ess_md_ti", "ess_bg_ti"} <= set(got)
    # without energies: the marginals alone
    got = results.generate_report(adj, frames, device="cpu")
    assert set(got) == set(jax_results.generate_report(adj, frames))


def _full_inputs(n=60, n_atoms=9):
    """tests/test_pipelines.py's synthetic sources (every cartesian array
    (n, n_atoms, 3), so ti_tpu compiles its z-matrix ops once)."""
    mol = make_synthetic_molecule(n_atoms=n_atoms, seed=0)
    adj = adjacency_from_bonds(mol.n_atoms, mol.bond_index)

    def frames(seed):
        return make_synthetic_frames(mol, n, 300, seed=seed)

    def sources(mod):
        r = np.random.default_rng(7)  # the same draws for both packages
        es_, nd_ = (lambda: r.normal(10.0, 0.5, n)), (lambda: r.normal(0.0, 0.1, n))
        md_ti = mod.MDTISource(x0s=frames(1), x1s=frames(2), E0s=es_(), E1s=es_(),
                               neg_dlogps_ti=nd_())
        bg_ti = mod.BGTISource(x0s=frames(3), x1s=frames(4),
                               zs=r.standard_normal((n, n_atoms, 3)),
                               neg_dlogps_bg=nd_(), neg_dlogps_ti=nd_(), E0s=es_(), E1s=es_())
        bg0 = mod.BGRefSource(zs=r.standard_normal((n, n_atoms, 3)), xs=frames(5),
                              neg_dlogps_bg=nd_(), Es=es_())
        bg1 = mod.BGRefSource(zs=r.standard_normal((n, n_atoms, 3)), xs=frames(6),
                              neg_dlogps_bg=nd_(), Es=es_())
        return dict(md_ti=md_ti, bg_ti=bg_ti, bg_ref_T0=bg0, bg_ref_T1=bg1)

    return adj, frames, sources


CASES = {
    # every source: the 43 artifacts of results_00031.py:291-340
    "all": (("md_ti", "bg_ti", "bg_ref_T0", "bg_ref_T1"), ("md_T0", "md_T1"), {}),
    # a BG-reference-only call
    "partial": (("bg_ref_T0", "bg_ref_T1"), (), {}),
    # results_10506.py's extras: z-matrices and torsions_h5_md
    "10506": (("md_ti", "bg_ti"), ("md_T0", "md_T1", "h5_md"), dict(save_z_matrices=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_full_report_matches_jax(tmp_path, case):
    picked, extra, kw = CASES[case]
    adj, frames, sources = _full_inputs()
    seeds = {"md_T0": 7, "md_T1": 8, "h5_md": 9}
    both = {}
    for name, mod, opts in (("port", results, dict(device="cpu")), ("jax", jax_results, {})):
        srcs = sources(mod)
        args = {k: srcs[k] for k in picked}
        args.update({k: frames(seeds[k]) for k in extra})
        both[name] = mod.generate_full_report(adj, n_bootstrap=20, save_path=str(tmp_path / name),
                                              **args, **kw, **opts)
    _assert_reports_equal(both["port"], both["jax"])
    _assert_saved_equal(tmp_path / "port", tmp_path / "jax")
    saved = {p[:-4] for p in os.listdir(tmp_path / "port")}
    if case == "all":
        assert len(saved) == 43
    if case == "10506":
        assert {"torsions_h5_md", "z_matrix_md_ti_0", "z_matrix_md_T1"} <= saved
    assert results.save_full_report(both["port"], str(tmp_path / "again")) == \
        jax_results.save_full_report(both["jax"], str(tmp_path / "again_jax"))


def test_chip_smoke_artifact_list_matches_jax(tmp_path):
    """chip_smoke.py's analysis phase holds the names its report saves to
    ANALYSIS_ARTIFACTS: the names ti_tpu saves for the same sources (MD→TI
    with energies, the MD references at T0 and T1)."""
    adj, frames, sources = _full_inputs()
    srcs = sources(jax_results)
    jax_results.generate_full_report(adj, md_ti=srcs["md_ti"], md_T0=frames(7), md_T1=frames(8),
                                     n_bootstrap=5, save_path=str(tmp_path))
    assert sorted(p[:-4] for p in os.listdir(tmp_path)) == sorted(chip_smoke.ANALYSIS_ARTIFACTS)


@pytest.mark.parametrize("k", [None, 100.0])
def test_free_energy_and_ess_routes_match_jax(k):
    rng = np.random.default_rng(3)
    n = 300
    e0, e1, e0b, e1b = (rng.normal(10.0, 0.6, n) for _ in range(4))
    nd0, nd1 = rng.normal(0, 0.2, n), rng.normal(0, 0.2, n)
    zs = rng.standard_normal((n, 5, 3))
    for fn, args in (("gen_free_energy_tfep_md_ti", (e0, e1, nd0)),
                     ("gen_free_energy_bg", (e0, nd0, e1b, nd1)),
                     ("gen_free_energy_bg_tfep", (e0b, nd0, e1, nd1))):
        got = getattr(results, fn)(*args, n_bootstrap=40, k=k, seed=2)
        ref = getattr(jax_results, fn)(*args, n_bootstrap=40, k=k, seed=2)
        np.testing.assert_allclose(_flat(got), _flat(ref), rtol=STATS_RTOL, atol=0)
    for fn, args in (("gen_ess_ti", (e0, e1, nd0)), ("gen_ess_bg", (zs, e1, nd0, nd1))):
        got = getattr(results, fn)(*args, k=k, n_bootstrap=40, seed=2)
        ref = getattr(jax_results, fn)(*args, k=k, n_bootstrap=40, seed=2)
        np.testing.assert_allclose(_flat(got), _flat(ref), rtol=STATS_RTOL, atol=0)
        assert 1.0 <= got[0] <= n


def test_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` means ``cuda``: without a card the z-matrices and the
    symbolic basis raise instead of running on the CPU."""
    sympy = pytest.importorskip("sympy")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mol = make_synthetic_molecule(n_atoms=5, seed=0)
    adj = adjacency_from_bonds(mol.n_atoms, mol.bond_index)
    x = make_synthetic_frames(mol, 4, 300)
    for call in (lambda: results.gen_z_matrix(adj, x),
                 lambda: results.generate_report(adj, x),
                 lambda: results.generate_full_report(adj, md_T0=x),
                 lambda: SymbolicBasis([sympy.Symbol("a")], [sympy.Symbol("a")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# kinetics
# ---------------------------------------------------------------------------

def _assert_spectra(got, ref):
    assert set(got) == set(ref)
    scale = max(np.abs(ref["eigenvalues_mean"]).max(), 1e-300)
    for key in ("eigenvalues_mean", "lower_bound", "upper_bound"):
        np.testing.assert_allclose(got[key], ref[key], rtol=STATS_RTOL, atol=STATS_RTOL * scale,
                                   err_msg=key)
    assert got["beta"] == ref["beta"]


@pytest.mark.parametrize("T", [300.0, 1000.0])
def test_torsion_generator_spectrum_matches_jax(T):
    torsions = np.random.default_rng(0).uniform(-np.pi, np.pi, (3, 512))
    kw = dict(p=50, sigma=5.0, nev=4, n_bootstrap=30, seed=1)
    got = kinetics.torsion_generator_spectrum(torsions, T, **kw)
    _assert_spectra(got, jax_kinetics.torsion_generator_spectrum(torsions, T, **kw))
    assert np.isfinite(got["eigenvalues_mean"]).all()
    # a given feature matrix, and the molecular a = 1/beta convention
    omega = np.random.default_rng(2).normal(0, 1 / 5.0, (3, 40))
    got = kinetics.torsion_generator_spectrum(torsions, T, Omega=omega, **kw)
    _assert_spectra(got, jax_kinetics.torsion_generator_spectrum(torsions, T, Omega=omega, **kw))
    assert kinetics.beta_kj_per_mol(T) == jax_kinetics.beta_kj_per_mol(T) == got["beta"]


def test_model_selection_scan_matches_jax():
    X = np.random.default_rng(3).normal(0, 1, (2, 400))
    kw = dict(sigma_list=(0.6, 10.0), p_list=(20, 40), ntest=5, nev=3, seed=4)
    got = kinetics.model_selection_scan(X, 2.0, **kw)
    ref = jax_kinetics.model_selection_scan(X, 2.0, **kw)
    assert set(got) == set(ref) and got["EV"].shape == (2, 2, 5, 3)
    scale = np.abs(ref["EV"]).max()
    np.testing.assert_allclose(got["EV"], ref["EV"], rtol=STATS_RTOL, atol=STATS_RTOL * scale)
    np.testing.assert_allclose(got["VAMP"], ref["VAMP"], rtol=STATS_RTOL,
                               atol=STATS_RTOL * np.abs(ref["VAMP"]).max())
    np.testing.assert_array_equal(got["sigma_list"], ref["sigma_list"])
    np.testing.assert_array_equal(got["p_list"], ref["p_list"])
    assert kinetics.best_hyperparameters(got) == jax_kinetics.best_hyperparameters(ref)


@pytest.mark.parametrize("layout", ["sample_major", "feature_major"])
def test_load_torsions_matches_jax(tmp_path, layout):
    t = np.random.default_rng(5).uniform(-3, 3, (300, 4))
    np.save(tmp_path / "t.npy", t if layout == "sample_major" else t.T)
    for max_samples in (None, 100):
        got = kinetics.load_torsions(str(tmp_path / "t.npy"), max_samples=max_samples, seed=6)
        ref = jax_kinetics.load_torsions(str(tmp_path / "t.npy"), max_samples=max_samples, seed=6)
        assert got.shape == (4, max_samples or 300)
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(kinetics.subsample_columns(t.T, 50, seed=1),
                                  jax_kinetics.subsample_columns(t.T, 50, seed=1))


# ---------------------------------------------------------------------------
# plots
# ---------------------------------------------------------------------------

def test_plot_helpers_match_jax():
    rng = np.random.default_rng(8)
    tors = rng.uniform(-np.pi, np.pi, (400, 3))
    w = rng.uniform(0.1, 2.0, 400)
    for kw in ({}, dict(weights=w), dict(weights=w, bins=20, range=(-np.pi, np.pi))):
        for a, b in zip(plots.reweighted_hist(tors[:, 0], **kw),
                        jax_plots.reweighted_hist(tors[:, 0], **kw)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    feats = plots.torsion_features(tors)
    np.testing.assert_allclose(feats, jax_plots.torsion_features(tors), rtol=1e-12, atol=0)
    series = np.cumsum(rng.normal(0, 0.1, (500, 3)), axis=0)
    for lag in (1, 10):
        for a, b in zip(plots.tica(plots.torsion_features(series), lag=lag),
                        jax_plots.tica(jax_plots.torsion_features(series), lag=lag)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    stack = rng.normal(size=(5, 2, 4, 3))
    np.testing.assert_array_equal(plots.frames_from_artifact(stack),
                                  jax_plots.frames_from_artifact(stack))
    np.testing.assert_array_equal(plots.frames_from_artifact(stack[:, 0]), stack[:, 0])


PLOTS = {
    "plot_marginals": lambda r: dict(generated=r.uniform(-3, 3, (200, 3)),
                                     reference=r.uniform(-3, 3, (100, 3)),
                                     weights=r.uniform(0.5, 1.5, 200)),
    "plot_marginals_overlay": lambda r: dict(series={"a": (r.uniform(-3, 3, (200, 2)), None),
                                                     "b": (r.uniform(-3, 3, (200, 2)),
                                                           r.uniform(0.5, 1.5, 200))},
                                             reference=r.uniform(-3, 3, (100, 2))),
    "plot_eigenvalues_vs_T": lambda r: dict(curves={"md": (np.array([300.0, 500.0]),
                                                           -r.uniform(0, 1, (2, 3)),
                                                           -r.uniform(1, 2, (2, 3)),
                                                           -r.uniform(0, 0.5, (2, 3)))}),
    "plot_tica": lambda r: dict(md_torsions=np.cumsum(r.normal(0, 0.1, (300, 3)), axis=0),
                                generated_torsions=r.uniform(-3, 3, (100, 3)), lag=5),
    "plot_molecule_frames": lambda r: dict(frames=r.normal(size=(2, 5, 3)),
                                           atomic_numbers=np.array([6, 1, 1, 8, 7]),
                                           bond_index=np.array([[0, 0, 0, 3], [1, 2, 3, 4]])),
}


@pytest.mark.parametrize("name", list(PLOTS))
def test_plots_write_their_files(tmp_path, name):
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    out = tmp_path / f"{name}.png"
    getattr(plots, name)(**PLOTS[name](np.random.default_rng(9)), out_path=str(out))
    plt.close("all")
    assert out.exists() and out.stat().st_size > 0


# ---------------------------------------------------------------------------
# energy stage and eval dataset
# ---------------------------------------------------------------------------

def test_reduced_and_saved_energies_match_jax(tmp_path):
    e = np.random.default_rng(10).normal(50.0, 5.0, 64)
    for T in (300.0, 1000.0):
        np.testing.assert_array_equal(energy.reduced_energies(e, T),
                                      jax_energy.reduced_energies(e, T))
    assert energy.KB_KJ_PER_MOL_K == jax_energy.KB_KJ_PER_MOL_K
    energy.save_energy_artifacts(str(tmp_path / "port"), "t", e, 2 * e)
    jax_energy.save_energy_artifacts(str(tmp_path / "jax"), "t", e, 2 * e)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == \
        ["E0s_t.npy", "E1s_t.npy"]
    for name in ("E0s_t.npy", "E1s_t.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                      np.load(tmp_path / "jax" / name))


class _Context:
    """The fake OpenMM context: E = 0.5 * sum(x^2) kJ/mol."""

    def __init__(self, system, integrator):
        self._x = None

    def setPositions(self, x):
        self._x = np.asarray(x)

    def getState(self, getEnergy=False):
        e = 0.5 * float(np.sum(self._x ** 2))
        return types.SimpleNamespace(
            getPotentialEnergy=lambda: types.SimpleNamespace(value_in_unit=lambda _u: e))


class _Offmol:
    def __init__(self, rdmol):
        self.partial_charges = None

    @classmethod
    def from_rdkit(cls, rdmol, allow_undefined_stereo=False):
        return cls(rdmol)

    def to_topology(self):
        return types.SimpleNamespace(to_openmm=lambda: {"offmol": self})


class _ForceField:
    def __init__(self, *xmls):
        pass

    def registerTemplateGenerator(self, gen):
        pass

    def createSystem(self, topology):
        return {"topology": topology}


@pytest.fixture
def fake_openmm(monkeypatch):
    """Importable stand-ins for openmm, openff, openmmforcefields and rdkit
    (none is installed here)."""
    mods = {name: types.ModuleType(name) for name in (
        "openmm", "openmm.app", "openmm.unit", "openff", "openff.toolkit",
        "openff.toolkit.topology", "openmmforcefields", "openmmforcefields.generators",
        "rdkit", "rdkit.Chem")}
    mods["openmm"].LangevinIntegrator = lambda T, friction, dt: (T, friction, dt)
    mods["openmm"].Context = _Context
    mods["openmm.app"].ForceField = _ForceField
    for unit in ("kelvin", "picosecond", "femtosecond", "elementary_charge", "nanometer"):
        setattr(mods["openmm.unit"], unit, 1.0)
    mods["openmm.unit"].kilojoule_per_mole = "kJ/mol"
    mods["openmm"].app, mods["openmm"].unit = mods["openmm.app"], mods["openmm.unit"]
    mods["openff.toolkit.topology"].Molecule = _Offmol
    mods["openmmforcefields.generators"].GAFFTemplateGenerator = (
        lambda molecules=None, forcefield=None: types.SimpleNamespace(generator=object()))
    mods["rdkit.Chem"].SDMolSupplier = lambda path, removeHs=False, sanitize=True: [{}] * 8
    mods["rdkit"].Chem = mods["rdkit.Chem"]
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)


def test_eval_energy_openmm_matches_jax(fake_openmm):
    assert energy.openmm_available() and jax_energy.openmm_available()
    rng = np.random.default_rng(11)
    confs, charges = rng.standard_normal((6, 5, 3)), rng.normal(0, 0.1, 5)
    got = energy.eval_energy_openmm("fake.sdf", 3, charges, confs, 300.0)
    ref = jax_energy.eval_energy_openmm("fake.sdf", 3, charges, confs, 300.0)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(
        got, energy.reduced_energies(0.5 * np.sum(confs.reshape(6, -1) ** 2, axis=1), 300.0),
        rtol=1e-12)


def test_eval_energy_openmm_gated_without_openmm(monkeypatch):
    monkeypatch.setitem(sys.modules, "openmm", None)
    assert not energy.openmm_available()
    with pytest.raises(ImportError, match="dedicated environment"):
        energy.eval_energy_openmm("x.sdf", 0, np.zeros(3), np.zeros((1, 3, 3)), 300.0)


def _write_eval_h5(path, n_mols, n_atoms, with_optional):
    """The reference's hdf5 layout (eval_dataset.py:33-54)."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(12)
    with h5py.File(path, "w") as f:
        for i in range(n_mols):
            d = f.create_group(f"{i:05d}/data")
            d["atoms"] = rng.choice([1, 6, 8], n_atoms)
            d["heavy_atoms"] = np.array([0, 3, 4])
            d["partial_charges"] = rng.normal(0, 0.2, n_atoms)
            d["ref_atoms"] = rng.integers(0, n_atoms, (n_atoms, 3))
            d["groups"] = rng.integers(0, 2, n_atoms)
            t = f.create_group(f"{i:05d}/trajectories")
            t["md_0"] = rng.standard_normal((7, n_atoms, 3))
            if with_optional:
                t["mdrt_0"] = rng.standard_normal((3, n_atoms, 3))
                t["re_0"] = rng.standard_normal((4, n_atoms, 3))


@pytest.mark.parametrize("with_optional", [True, False])
def test_eval_dataset_matches_jax(tmp_path, with_optional):
    mol = make_synthetic_molecule(n_atoms=5, seed=0)
    _write_sdf(tmp_path / "mols.sdf", mol, 1)
    _write_eval_h5(tmp_path / "eval.hdf5", 2, 5, with_optional)
    ds = MDQM9EvalDataset(str(tmp_path / "eval.hdf5"), str(tmp_path / "mols.sdf"))
    ref = JaxEvalDataset(str(tmp_path / "eval.hdf5"), str(tmp_path / "mols.sdf"))
    try:
        assert len(ds) == len(ref) == 2
        for i in range(2):
            a, b = ds[i], ref[i]
            assert a.idx == b.idx == i
            for field in ("atomic_numbers", "positions", "bond_index", "bond_types"):
                np.testing.assert_array_equal(getattr(a.mol, field), getattr(b.mol, field))
            assert a.mol.name == b.mol.name
            for field in ("atoms", "heavy_atoms", "partial_charges", "ref_atoms", "groups",
                          "conformations", "mdrt_conformations", "re_conformations"):
                va, vb = getattr(a, field), getattr(b, field)
                assert (va is None) == (vb is None), field
                if va is not None:
                    np.testing.assert_array_equal(va, vb)
            assert (a.re_conformations is None) == (not with_optional)
    finally:
        ds.close()
        ref.close()


# ---------------------------------------------------------------------------
# symbolic dictionary
# ---------------------------------------------------------------------------

def test_symbolic_basis_matches_jax():
    """tests/test_gedmd.py's mixed dictionary (a constant, monomials, a
    Gaussian) and a trigonometric product: values, gradients and Hessians
    in float32 against ti_tpu's jax.jacfwd."""
    sympy = pytest.importorskip("sympy")
    from ti_tpu.gedmd.symbolic import SymbolicBasis as JaxSymbolicBasis

    x, y = sympy.symbols("x y")
    psis = [sympy.Integer(1), x, x ** 2 * y, sympy.exp(-(x ** 2) - y ** 2),
            sympy.sin(x) * sympy.cos(2 * y), sympy.Rational(3, 2)]
    basis = SymbolicBasis(psis, [x, y], ndiff=2, device="cpu")
    ref = JaxSymbolicBasis(psis, [x, y], ndiff=2)
    assert Sym2numeric is SymbolicBasis
    pts = np.random.default_rng(13).normal(0, 1, (2, 64))
    for method, shape in (("__call__", (6, 64)), ("diff", (6, 2, 64)), ("ddiff", (6, 2, 2, 64))):
        got, want = getattr(basis, method)(pts), getattr(ref, method)(pts)
        assert got.shape == want.shape == shape and got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=method)
    np.testing.assert_array_equal(basis(pts)[5], 1.5)
    np.testing.assert_array_equal(basis.diff(pts)[[0, 5]], 0.0)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

# 12 chains in one batch: the report's IQR filter empties a bootstrap
# resample of 3 chains that draws one chain three times (in both packages)
N_ATOMS, F, LAYERS, B = 6, 16, 2, 12
SIZE = dict(n_features=F, score_layers=LAYERS, batch_size=B)


def test_slice_sample_ambient_then_report_matches_jax(tmp_path, monkeypatch):
    """``sample_ambient`` under ``fast_profile(ambient_preset("00031"))`` on
    the dense f32 forward (the CPU route of the main path's kernels: on a
    CPU tensor B1 is its plain version, and the nodes take Hutchinson
    probes), with ``ti_tpu``'s orthogonal draws pinned at the port's
    ``node_divergences`` (as tests/test_torch_pair_layer_f256.py does), then
    ``generate_report`` on the final samples, the harmonic stand-in
    energies and the dlogps, in both packages.

    Bars: the samples and dlogps at tests/test_torch_sample_ambient.py's
    (rtol 1e-4 / atol 1e-5; rtol 1e-3). The report then follows from them:
    phi = E1 - E0 + dlogp moves by at most delta between the packages, and
    -log mean exp(-phi) and each bootstrap percentile by at most delta, the
    Kish ESS by at most a factor exp(4 delta); the bond lengths by at most
    twice the samples' difference. The port's report on its own samples is
    held to ti_tpu's report on the same samples at the module bars."""
    over = dict(compute_dtype="f32", traj_forward_impl="default", div_forward_impl="default")
    cfg = fast_profile(ambient_preset("00031", **SIZE), **over)
    jcfg = jax_fast_profile(jax_preset("00031", **SIZE), **over)
    route = ("default", "default", "hutchinson", 16, "orthogonal", "f32")
    for c in (cfg, jcfg):
        assert (c.traj_forward_impl, c.div_forward_impl, c.divergence, c.num_probes,
                c.probe_mode, c.compute_dtype) == route

    jmol = jax_molecule(N_ATOMS, seed=0)
    jt = jax_template(jmol, t_cond=2)
    jm = JaxCPaiNN(n_features=F, score_layers=LAYERS, conditioning="ambient")
    jp = jax.jit(lambda key: jm.init(key, jt))(jax.random.PRNGKey(0))  # op by op: 3x slower
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    mol = make_synthetic_molecule(N_ATOMS, seed=0)
    template = graph_template(mol, t_cond=2)
    x0 = make_synthetic_frames(mol, B, cfg.sampling_T0, seed=1, jitter=0.1)

    ref = jax_sample_ambient(jcfg, jm, jp, jt, x0, save=False)
    _, sub = jax.random.split(jax.random.PRNGKey(cfg.seed))
    keys = jax.random.split(jax.random.fold_in(sub, 10_000), B)

    def probes(i):  # ti_tpu's draw at Gauss node i, chain by chain
        zs, ws = zip(*(jax_probe_block(jax.random.fold_in(key, i), cfg.num_probes, 3 * N_ATOMS,
                                       jnp.float32, "orthogonal") for key in keys))
        return torch.from_numpy(np.stack(zs)), torch.from_numpy(np.stack(ws))

    real, pinned = drivers.node_divergences, []

    def node_divergences(*args, **kw):
        pinned.append(kw.get("probes"))
        return real(*args, **{**kw, "probes": probes})

    monkeypatch.setattr(drivers, "node_divergences", node_divergences)
    cfg.data_save_path = str(tmp_path / "samples")
    out = drivers.sample_ambient(cfg, CPaiNN(F, LAYERS, n_atoms=N_ATOMS), params, template, x0,
                                 save=True, device="cpu")
    assert pinned == [None]
    np.testing.assert_allclose(out["samples"], ref["samples"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["dlogps"], ref["dlogps"], rtol=1e-3)
    # the report reads the saved artifacts, as users run it
    samples = np.load(tmp_path / "samples" / f"samples_{cfg.data_save_name}.npy")
    dlogps = np.load(tmp_path / "samples" / f"dlogps_{cfg.data_save_name}.npy")
    np.testing.assert_array_equal(samples, out["samples"])

    p_eq = (mol.positions - mol.positions.mean(axis=0)).astype(np.float32)
    adj = adjacency_from_bonds(N_ATOMS, mol.bond_index)

    def report(mod, xs, nd, **kw):
        return mod.generate_report(adj, xs[:, -1], neg_dlogps_ti=nd,
                                   E0s=_harmonic(xs[:, 0], cfg.sampling_T0, p_eq),
                                   E1s=_harmonic(xs[:, -1], cfg.sampling_T1, p_eq),
                                   n_bootstrap=20, **kw)

    got = report(results, samples, dlogps, device="cpu")
    _assert_reports_equal(got, report(jax_results, samples, dlogps))
    want = report(jax_results, ref["samples"], ref["dlogps"])
    delta = np.max(np.abs((_harmonic(samples[:, -1], cfg.sampling_T1, p_eq)
                           - _harmonic(samples[:, 0], cfg.sampling_T0, p_eq) + dlogps)
                          - (_harmonic(ref["samples"][:, -1], cfg.sampling_T1, p_eq)
                             - _harmonic(ref["samples"][:, 0], cfg.sampling_T0, p_eq)
                             + ref["dlogps"])))
    np.testing.assert_allclose(_flat(got["dF_tfep_md_ti"]), _flat(want["dF_tfep_md_ti"]),
                               rtol=0, atol=delta * (1 + 1e-9))
    ratio = _flat(got["ess_md_ti"]) / _flat(want["ess_md_ti"])
    assert np.all(np.abs(np.log(ratio)) <= 4 * delta * (1 + 1e-9))
    dx = np.max(np.abs(samples[:, -1] - ref["samples"][:, -1]))
    np.testing.assert_allclose(got["bond_lengths"], want["bond_lengths"], rtol=0,
                               atol=2 * dx + Z_ATOL)
    assert np.isfinite(got["torsions"]).all() and got["torsions"].shape == (B, N_ATOMS - 3)
