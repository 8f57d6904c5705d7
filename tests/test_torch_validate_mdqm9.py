"""The port's ``validate_mdqm9_physics`` CLI (ti_torch/cli) against
scripts/validate_mdqm9_physics.py, both run in-process on the CPU
(``--device cpu``) at a tiny size.

The field is a 4-atom ambient cPaiNN (F = 8, 1 layer) at flax's
initialisation, written as the JAX script writes its trained one: an orbax
checkpoint ``{"params", "arch"}`` at ``out_dir/oracle_params``
(``ti_tpu.train.common.save_checkpoint``; the script's own training run
takes 38 s here, its jit compile nearly all of it, so
test_script_trains_and_reuses_its_field runs the port's at 1 epoch). The
test reads it with ``load_checkpoint``, carries it across with
``params_from_flax`` and writes the port's ``oracle_params.npz`` with its
arch beside it. Both packages then run ``--reuse`` on that field (RK4-2,
the exact divergence; the scripts' 1024 transported chains, their frames
of seed 999, cut to 128 by wrapping ``make_synthetic_frames`` in both
packages, since the whole suite shares this CPU's cores):

- the JSON keys are the same, and ``width``, ``dlogp_mean``, ``dF_est``,
  ``dF_abs_err`` and ``ess_frac`` agree at rtol 1e-4 in f32 (``dF_abs_err``,
  |dF_est - dF_exact|, at 1e-4 of dF_exact: it is the small difference of
  two such numbers);
- ``--compute_dtype all``'s bf16 and bf16_agg rows agree at the bf16_agg bar
  of tests/test_torch_pair_layer.py (4e-2 of the f32 quantity they shift:
  max |dlogp| for the dlogp shifts, max |x1| for the sample shift, ΔF for
  the ΔF error);
- ``--probe_sweep orthogonal:12:0`` (K = 3N, the exact trace) equals the
  exact row at rtol 1e-4 in the port;
- the arch check of ``--reuse`` and the ``--quad_dlogp`` guards exit in both;
- on the CPU the port's ``--traj_impl pair_kernel`` route (B1's plain
  version) equals its default route at rtol 1e-5, and its ``--div_impl
  pair_tangent`` exact frame the exact divergence at rtol 1e-4;
- Hutchinson, SDE and debias rows cannot replay JAX's draws: their keys are
  present and finite, and the debiased row is the oracle of phi + var/2 on
  the transport's own dlogp variances.
"""

import contextlib
import io
import json

import numpy as np
import pytest

from scripts import validate_mdqm9_physics as jax_cli
from ti_torch.analysis import oracles
from ti_torch.cli import validate_mdqm9_physics as cli
from ti_torch.models.convert import params_from_flax, save_npz

SIZE = ["--features", "8", "--layers", "1", "--atoms", "4", "--temp_length", "8"]
EVAL = ["--eval_steps", "2"]
ARCH = {"features": 8, "layers": 1, "temp_length": 8.0, "atoms": 4}
CLOSE = ("width", "dlogp_mean", "dF_est", "dF_abs_err", "ess_frac")
DTYPE_ROWS = {"dF_abs_err": "dF", "dlogp_mean_shift": "dlogp", "dlogp_rms_shift": "dlogp",
              "x1_rms_shift": "x1"}


N_CHAINS = 128


@contextlib.contextmanager
def _few_chains():
    """Both packages' ``make_synthetic_frames`` with the transport's start
    frames (seed 999) cut to N_CHAINS."""
    import ti_torch.data.mdqm9 as port_data
    import ti_tpu.data.mdqm9 as jax_data

    def cut(real):
        def frames(mol, n_frames, temperature, seed=0, **kw):
            return real(mol, N_CHAINS if seed == 999 else n_frames, temperature, seed=seed, **kw)

        return frames

    with pytest.MonkeyPatch.context() as mp:
        for module in (port_data, jax_data):
            mp.setattr(module, "make_synthetic_frames", cut(module.make_synthetic_frames))
        yield


@pytest.fixture(autouse=True)
def few_chains():
    with _few_chains():
        yield


def _close(row, ref, rtol, keys=CLOSE):
    """``keys`` of two rows at ``rtol``; ``dF_abs_err``, the small difference
    of two numbers of the size of ``dF_exact``, at ``rtol`` of that size."""
    for k in keys:
        assert np.isfinite(row[k]), k
        scale = abs(ref["dF_exact"]) if k == "dF_abs_err" else abs(ref[k])
        assert abs(row[k] - ref[k]) <= rtol * scale, (k, row[k], ref[k])


def _run(main, argv):
    """The stdout lines of ``main(argv)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().strip().splitlines()


def _port(out_dir, *argv):
    return _run(cli.main, ["--device", "cpu", "--reuse", "--out_dir", out_dir, *SIZE, *EVAL,
                           *argv])


@pytest.fixture(scope="module")
def field(tmp_path_factory):
    """The JAX package's field as the script saves it (orbax), and as the
    port's npz."""
    import jax

    from ti_tpu.config import MDQM9Config
    from ti_tpu.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_tpu.train.ambient import build_ambient_model
    from ti_tpu.train.common import load_checkpoint, save_checkpoint

    out_dir = str(tmp_path_factory.mktemp("validate_mdqm9"))
    model = build_ambient_model(MDQM9Config(n_features=8, score_layers=1, temp_length=8.0))
    variables = model.init(jax.random.PRNGKey(0),
                           graph_template(make_synthetic_molecule(4, seed=0), t_cond=2))
    save_checkpoint(f"{out_dir}/oracle_params", {"params": variables, "arch": ARCH})
    ckpt = load_checkpoint(f"{out_dir}/oracle_params")
    save_npz(f"{out_dir}/oracle_params.npz", params_from_flax(ckpt["params"]), arch=ARCH)
    return out_dir


@pytest.fixture(scope="module")
def both(field):
    """The reuse run of each package with ``--compute_dtype all``."""
    with _few_chains():
        jax_row = json.loads(_run(jax_cli.main, ["--reuse", "--out_dir", field,
                                                 "--compute_dtype", "all", *SIZE, *EVAL])[-1])
        port = _port(field, "--compute_dtype", "all", "--probe_sweep", "orthogonal:12:0")
    assert round(jax_row["ess"] / jax_row["ess_frac"]) == N_CHAINS
    return jax_row, port


def test_json_matches_jax(both):
    jax_row, port = both
    row = json.loads(port[-1])
    assert set(row) == set(jax_row)
    assert row["compute_dtype"] == jax_row["compute_dtype"] == "f32"
    _close(row, jax_row, 1e-4)
    for k in ("width_target", "width_start", "dlogp_expected", "dF_exact"):
        np.testing.assert_allclose(row[k], jax_row[k], rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("dtype", ["bf16", "bf16_agg"])
def test_compute_dtype_rows_match_jax(both, dtype):
    jax_row, port = both
    row = json.loads(port[-1])
    scale = {"dF": abs(jax_row["dF_exact"]), "dlogp": abs(jax_row["dlogp_mean"]) + 1.0,
             "x1": 3 * jax_row["width_start"]}
    for stem, what in DTYPE_ROWS.items():
        k = f"{stem}_{dtype}"
        assert np.isfinite(row[k])
        assert abs(row[k] - jax_row[k]) <= 4e-2 * scale[what], (k, row[k], jax_row[k])


def test_full_orthogonal_frame_sweep_is_the_exact_row(both):
    _, port = both
    sweep = json.loads(port[0])
    row = json.loads(port[-1])
    assert (sweep["sweep_mode"], sweep["K"], sweep["seed"]) == ("orthogonal", 12, 0)
    _close({**sweep, "dF_exact": row["dF_exact"]}, row, 1e-4, ("dF_abs_err", "ess_frac"))


GUARDS = {
    "arch": (["--features", "16"], "--reuse architecture mismatch"),
    "traj_impl": (["--traj_impl", "pair_kernel"], "--traj_impl requires --quad_dlogp"),
    "div_impl": (["--div_impl", "pair_tangent"], "--div_impl requires --quad_dlogp"),
    "probe_debias": (["--probe_debias"], "--probe_debias requires --quad_dlogp"),
}


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("guard", list(GUARDS))
def test_guards_exit(field, package, guard):
    extra, msg = GUARDS[guard]
    argv = ["--reuse", "--out_dir", field, *SIZE, *EVAL, *extra]
    main = jax_cli.main if package == "jax" else cli.main
    if package == "port":
        argv = ["--device", "cpu", *argv]
    with pytest.raises(SystemExit, match=msg):
        _run(main, argv)


def test_kernel_routes_equal_the_default_routes_on_the_cpu(field):
    """B1's and B3's plain versions behind ``--traj_impl pair_kernel`` and
    ``--div_impl pair_tangent`` (the full orthogonal frame) on the Gauss
    path: the trajectory equals the dense one at rtol 1e-5, the frame's
    trace the exact divergence at rtol 1e-4."""
    quad = ["--quad_dlogp", "--gl_points", "2"]
    base = json.loads(_port(field, *quad)[-1])
    traj = json.loads(_port(field, *quad, "--traj_impl", "pair_kernel")[-1])
    frame = json.loads(_port(field, *quad, "--traj_impl", "pair_kernel", "--div_impl",
                             "pair_tangent")[-1])
    assert (traj["traj_impl"], frame["div_impl"]) == ("pair_kernel", "pair_tangent")
    _close(traj, base, 1e-5)
    _close(frame, base, 1e-4)


def test_stochastic_rows_are_finite_and_debiased(field, monkeypatch):
    """Hutchinson on B3's plain version with ``--probe_debias`` and an SDE
    row: the keys are present and finite, and the debiased row is the
    oracle of phi + var/2 on the transport's own samples and variances."""
    from ti_torch.sampling import drivers

    real = drivers.make_ode_sampler
    seen = []

    def make_ode_sampler(*a, **kw):
        sampler = real(*a, **kw)

        def run(*b, **bk):
            sol = sampler(*b, **bk)
            seen.append((sol.xs[:, -1].numpy(), sol.dlogp[:, -1].numpy(),
                         sol.dlogp_var[:, -1].numpy()))
            return sol

        return run

    monkeypatch.setattr(drivers, "make_ode_sampler", make_ode_sampler)
    row = json.loads(_port(field, "--quad_dlogp", "--gl_points", "2", "--div_impl",
                           "pair_tangent", "--divergence", "hutchinson", "--num_probes", "4",
                           "--probe_debias", "--sde_g", "0.1", "--sde_steps", "2")[-1])
    for k in ("dF_abs_err_debiased", "ess_frac_debiased", "dlogp_var_mean", "sde_g0.1_width",
              "sde_g0.1_ks_energy", "ode_ks_energy", *CLOSE):
        assert np.isfinite(row[k]), k
    (x1, dlogp, var), = seen
    assert var.shape == dlogp.shape and (var >= 0).all() and var.mean() > 0
    from ti_torch.data.mdqm9 import make_synthetic_frames, make_synthetic_molecule

    mol = make_synthetic_molecule(n_atoms=4, seed=0)
    x0 = make_synthetic_frames(mol, 1024, 1000, seed=999, jitter=0.4)
    assert len(x0) == len(x1) == N_CHAINS
    p_eq = (mol.positions - mol.positions.mean(0)).astype(np.float32)
    s0, s1 = oracles.well_sigma(1000, 0.4), oracles.well_sigma(300, 0.4)
    phis = oracles.well_energy(x1, s1, p_eq) - oracles.well_energy(x0, s0, p_eq) + dlogp
    dF_exact = oracles.tfep_dF_exact(4, s0, s1)
    np.testing.assert_allclose(row["dF_abs_err"],
                               abs(oracles.neg_log_mean_exp(-phis) - dF_exact), rtol=1e-10)
    np.testing.assert_allclose(row["dF_abs_err_debiased"],
                               abs(oracles.neg_log_mean_exp(-(phis + 0.5 * var)) - dF_exact),
                               rtol=1e-10)
    np.testing.assert_allclose(row["dlogp_var_mean"], var.mean(), rtol=1e-6)


def test_script_trains_and_reuses_its_field(tmp_path):
    """The port's own round trip: one epoch of ``train_ambient``, the weights
    at ``out_dir/oracle_params.npz`` with their arch, then ``--reuse``
    reproduces the trained run's row."""
    from ti_torch.models.convert import load_npz_arch

    argv = ["--device", "cpu", "--out_dir", str(tmp_path), "--frames", "64", "--batch", "32",
            *SIZE, *EVAL]
    trained = json.loads(_run(cli.main, ["--epochs", "1", *argv])[-1])
    state, arch = load_npz_arch(str(tmp_path / "oracle_params.npz"))
    assert {k: float(v) for k, v in arch.items()} == ARCH and state
    assert json.loads(_run(cli.main, ["--reuse", *argv])[-1]) == trained


def test_needs_a_device_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--epochs", "1"])
