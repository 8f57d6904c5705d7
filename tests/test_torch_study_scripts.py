"""The port's study CLIs (ti_torch/cli: adw_plots, step_count_study,
adw_f64_study, probe_mode_study, sde_scan, large_scale_scan,
profile_divergence) against the JAX package's scripts of the same names,
each run in-process on the CPU (``--device cpu``) at a small size.

- ``step_count_study`` and ``adw_f64_study``: both packages' ``train_adw``
  return the same field (a flax ``FCNetMultiBeta.init`` carried across
  with ``params_from_flax``), and the printed rows agree: f32 at rtol 1e-4
  / atol 1e-6, f64 at rtol 1e-10, NFE equal; the seconds are left out. The
  JAX f64 study switches ``jax_enable_x64`` on for the process when it is
  loaded; the test puts the setting back.
- ``probe_mode_study``: the exact trace at each node equals ti_tpu's
  ``divergence_exact`` on the same weights and states (rtol 1e-5); the JAX
  test's checks (tests/test_cli_scripts.py::test_probe_mode_study_cli)
  hold for the port; ``--oracle --params`` is refused by both.
- ``sde_scan``, ``large_scale_scan`` and ``profile_divergence``: the JAX
  script's printed labels and row keys are a subset of the port's (the
  rates differ); the JAX scans run their dense rows (the Pallas kernels'
  interpret mode takes seconds a call here), the port's every impl through
  the plain versions. ``profile_divergence`` is fixed at 19 atoms: both
  sides' fields are shrunk to F = 8 x 1 and their timers to one call.
- A scan records running out of device memory and the width refusal as a
  row, and lets every other error through.
- ``adw_plots``: both draw the figures from the same npz; the port exits 2
  when matplotlib cannot be found.
- Every CLI that computes on a device raises with no card and no
  ``--device``.
"""

import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ti_tpu.models.cpainn as jax_cpainn
import ti_tpu.train.adw as jax_train_adw
import ti_tpu.utils.timing as jax_timing
from scripts import adw_plots as jax_adw_plots
from scripts import large_scale_scan as jax_large_scale_scan
from scripts import probe_mode_study as jax_probe_mode_study
from scripts import step_count_study as jax_step_count_study
from ti_torch.cli import (
    adw_f64_study,
    adw_plots,
    large_scale_scan,
    probe_mode_study,
    profile_divergence,
    sde_scan,
    step_count_study,
)
from ti_torch.models.convert import params_from_flax, params_to_flax, save_npz
from ti_torch.ops import pair_layer_kernel as plk
from ti_tpu.models.mlp import FCNetMultiBeta as JaxFCNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-4, atol=1e-6)
F64 = dict(rtol=1e-10, atol=0)
# the f32 dopri5 references of the two packages end up to 2.3e-4 apart
DOPRI5_F32 = dict(rtol=0, atol=5e-4)
SECONDS = ("train_s", "sample_s")


def _run_jax_script(monkeypatch, script, argv):
    """Run ``scripts/<script>`` as ``__main__`` in this process."""
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(sys, "argv", [script] + list(argv))
    runpy.run_path(os.path.join(REPO, "scripts", script), run_name="__main__")


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _assert_json_close(ours, ref, bar, path="", skip=SECONDS):
    """Equal keys; numbers at ``bar``, ints exactly, strings equal."""
    assert sorted(ours) == sorted(ref), path
    for k, r in ref.items():
        if k in skip:
            continue
        o, where = ours[k], f"{path}{k}"
        if isinstance(r, dict):
            _assert_json_close(o, r, bar, where + ".", skip)
        elif isinstance(r, bool) or isinstance(r, str) or isinstance(r, int):
            assert o == r, where
        else:
            np.testing.assert_allclose(o, r, **bar, err_msg=where)


# ---------------------------------------------------------------------------
# the ADW studies on a carried-across field
# ---------------------------------------------------------------------------

def _fields(hidden, layers, seed, dtype, scale=1.0):
    """(flax model, numpy tree, port model, state dict) of one init, every
    kernel times ``scale``."""
    from ti_torch.models.mlp import FCNetMultiBeta

    nd, td = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}[dtype]
    jm = JaxFCNet(hidden_size=hidden, num_layers=layers)
    z = jnp.zeros((1, 1))
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a, nd) * (scale if path[-1].key == "kernel" else 1.0),
        jax.jit(jm.init)(jax.random.PRNGKey(seed), z, z, z, z))
    model = FCNetMultiBeta(hidden_size=hidden, num_layers=layers, dtype=td)
    return jm, tree, model, params_from_flax(tree)


def _patch_trainers(monkeypatch, hidden, layers, scale=1.0, history=(0.25,)):
    """Both ``train_adw`` return the same field: seed 0 in f32, seed 1 in
    f64 (two trained fields differ, so the cross-dtype deltas are the
    fields' and not f32's rounding)."""
    fields = {d: _fields(hidden, layers, s, d, scale) for d, s in (("f32", 0), ("f64", 1))}
    hist = {"train_loss": list(history), "val_loss": list(history)}

    def jax_train(cfg, *a, **kw):
        jm, tree, _, _ = fields[getattr(cfg, "dtype", "f32")]
        return {"model": jm, "params": jax.tree_util.tree_map(jnp.asarray, tree),
                "history": hist}

    def port_train(cfg, *a, device=None, **kw):
        _, _, model, params = fields[cfg.dtype]
        return {"model": model, "params": dict(params), "history": hist}

    import ti_torch.train.adw as port_train_adw

    monkeypatch.setattr(jax_train_adw, "train_adw", jax_train)
    monkeypatch.setattr(port_train_adw, "train_adw", port_train)


def test_step_count_study_matches_jax(monkeypatch, capsys, tmp_path):
    """Both scripts on the same 64 x 3 field and draws, in f32 as they run:
    the same rows, RK4's and GL-10's NFE equal. The init's kernels are
    scaled by 1.7, a field that moves the chains enough that every error is
    the integrator's (3e-4 to 7e-3; the init itself reads 5e-7 at RK4-8,
    f32's rounding). The errors are against each package's dopri5@1e-5,
    which in f32 steps differently on a third of the chains (the first
    steps' error norms are rounding noise, as tests/test_torch_adw.py
    finds) and ends up to 2.3e-4 apart: the rows agree to that
    (``DOPRI5_F32``), and the f64 test below holds the same evaluation to
    1e-9."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    _patch_trainers(monkeypatch, 64, 3, scale=1.7)
    argv = ["--epochs", "1", "--n_samples", "1000", "--n_eval", "48", "--steps", "8", "16"]
    jax_step_count_study.main(argv)
    ref = [json.loads(line) for line in _lines(capsys)]
    assert step_count_study.main(argv + ["--device", "cpu"]) == 0
    ours = [json.loads(line) for line in _lines(capsys)]
    assert len(ours) == len(ref) == 3 and ref[1]["gauss10_nfe"] == 16 * 4 + 10
    for o, r in zip(ours[:2], ref[:2]):
        _assert_json_close(o, r, DOPRI5_F32)
    assert ours[2]["summary"] == ref[2]["summary"] and ours[2]["rk4_steps"] == ref[2]["rk4_steps"]
    assert min(r["dlogp_err_p99"] for r in ref[:2]) > 1e-4  # the integrator's, not rounding


def _jax_step_count_rows(jm, jp, x0, steps):
    """scripts/step_count_study.py's evaluation, as written there, on x0 in
    its own dtype (the script casts to f32; here x64 is on)."""
    from ti_tpu.sampling.integrators import sample_ode, sample_ode_dopri5, sample_ode_gauss_dlogp

    def v(x, t):
        full = lambda c: jnp.full((1, 1), c, dtype=x.dtype)  # noqa: E731
        return jm.apply(jp, x[None, :], full(t), full(1.0), full(1.25))[0]

    xj = jnp.asarray(x0)[:, None]
    ref = jax.jit(jax.vmap(lambda x: sample_ode_dopri5(v, x, atol=1e-5, rtol=1e-5,
                                                       divergence="exact")))(xj)
    x_ref, lp_ref = np.asarray(ref.xs[:, -1, 0]), np.asarray(ref.dlogp[:, -1])
    rows = []
    for n in steps:
        sol = jax.jit(jax.vmap(lambda x: sample_ode(v, x, n_steps=n, method="rk4",
                                                    divergence="exact")))(xj)
        le = np.abs(np.asarray(sol.dlogp[:, -1]) - lp_ref)
        row = {"rk4_steps": n, "nfe": int(np.max(np.asarray(sol.nfe))),
               "x_err_p99": float(np.percentile(np.abs(np.asarray(sol.xs[:, -1, 0]) - x_ref), 99)),
               "dlogp_err_p99": float(np.percentile(le, 99)), "dlogp_err_max": float(le.max())}
        if n >= 16:
            g = jax.jit(jax.vmap(lambda x: sample_ode_gauss_dlogp(v, x, n_steps=n, gl_points=10,
                                                                  method="rk4")))(xj)
            row["gauss10_dlogp_err_p99"] = float(np.percentile(
                np.abs(np.asarray(g.dlogp[:, -1]) - lp_ref), 99))
            row["gauss10_nfe"] = int(np.max(np.asarray(g.nfe)))
        rows.append(row)
    return rows, int(np.max(np.asarray(ref.nfe)))


def test_step_count_evaluation_matches_jax_in_f64(capsys):
    """``evaluate`` on given f64 weights against the JAX script's
    evaluation under x64: every row to 1e-9 (the two dopri5 references end
    8.6e-11 apart, the same steps on every chain), dopri5's NFE equal."""
    from ti_torch.analysis.potentials import AsymmetricDoubleWell, BoltzmannDensity1D

    jm, tree, model, params = _fields(64, 3, 0, "f64", scale=1.7)
    x0 = BoltzmannDensity1D(1.0, AsymmetricDoubleWell()).sample(123, 48)
    rows, summary, nfe = step_count_study.evaluate((model, params), x0, [8, 16], "cpu")
    with jax.enable_x64(True):
        ref, ref_nfe = _jax_step_count_rows(jm, jax.tree_util.tree_map(jnp.asarray, tree),
                                            x0, [8, 16])
    assert nfe == ref_nfe and len(rows) == 2
    for o, r in zip(rows, ref):
        _assert_json_close(o, r, dict(rtol=1e-10, atol=1e-9))
    assert summary["speedup_vs_dopri5_nfe"] == ref_nfe / ref[1]["gauss10_nfe"]
    assert capsys.readouterr().out.count("\n") == 3


def test_dopri5_references_part_in_f32_only():
    """Why the f32 step-count rows are held to ``DOPRI5_F32``: on the same
    1.7-scaled field and starts, the two packages' dopri5@1e-5 take
    different step counts on many chains in f32 (the first steps' error
    norms are rounding noise) and end apart by up to a few 1e-4, while in
    f64 every chain takes the same steps and ends within 1e-9."""
    from ti_torch.analysis.potentials import AsymmetricDoubleWell, BoltzmannDensity1D
    from ti_torch.sampling.drivers import adw_v_fn_of
    from ti_torch.sampling.integrators import sample_ode_dopri5
    from ti_tpu.sampling.integrators import sample_ode_dopri5 as jax_dopri5

    x0 = BoltzmannDensity1D(1.0, AsymmetricDoubleWell()).sample(123, 48)
    spread = {}
    for dtype in ("f32", "f64"):
        jm, tree, model, params = _fields(64, 3, 0, dtype, scale=1.7)
        x = torch.as_tensor(x0, dtype=next(iter(params.values())).dtype)[:, None]
        conds = torch.tensor([[1.0, 1.25]], dtype=x.dtype).expand(len(x), 2)
        with torch.no_grad():
            ours = sample_ode_dopri5(adw_v_fn_of(model, params)(conds), x, atol=1e-5,
                                     rtol=1e-5, divergence="exact")
        with jax.enable_x64(dtype == "f64"):
            jp = jax.tree_util.tree_map(jnp.asarray, tree)

            def v(xc, t):
                full = lambda c: jnp.full((1, 1), c, dtype=xc.dtype)  # noqa: E731
                return jm.apply(jp, xc[None, :], full(t), full(1.0), full(1.25))[0]

            ref = jax.jit(jax.vmap(lambda xc: jax_dopri5(v, xc, atol=1e-5, rtol=1e-5,
                                                          divergence="exact")))(
                jnp.asarray(x.numpy()))
            ref_nfe, ref_x = np.asarray(ref.nfe), np.asarray(ref.xs[:, -1, 0])
        spread[dtype] = (int((ours.nfe.numpy() != ref_nfe).sum()),
                         float(np.abs(ours.xs[:, -1, 0].numpy() - ref_x).max()))
    assert spread["f64"][0] == 0 and spread["f64"][1] < 1e-9
    assert spread["f32"][0] >= 5 and 1e-5 < spread["f32"][1] < DOPRI5_F32["atol"]


def test_adw_f64_study_matches_jax(monkeypatch, capsys, tmp_path):
    """Both dtypes' physics and the cross-dtype deltas on the same fields:
    f32 at rtol 1e-4 / atol 1e-6, f64 at rtol 1e-10; jax_enable_x64 put
    back afterwards."""
    _patch_trainers(monkeypatch, 16, 2)
    argv = ["--epochs", "1", "--n_train", "1000", "--n", "200", "--steps", "8",
            "--hidden", "16", "--layers", "2"]
    x64, platforms = jax.config.jax_enable_x64, jax.config.jax_platforms
    try:
        _run_jax_script(monkeypatch, "adw_f64_study.py", argv + ["--out", str(tmp_path / "j")])
    finally:
        jax.config.update("jax_enable_x64", x64)
        jax.config.update("jax_platforms", platforms)
    assert not jax.config.jax_enable_x64 and jnp.zeros(1).dtype == jnp.float32
    ref = json.loads(_lines(capsys)[-1])
    assert adw_f64_study.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    ours = json.loads(_lines(capsys)[-1])
    assert sorted(ours) == sorted(ref) == ["cross", "dF_exact", "f32", "f64"]
    np.testing.assert_allclose(ours["dF_exact"], ref["dF_exact"], **F64)
    _assert_json_close(ours["f32"], ref["f32"], F32)
    _assert_json_close(ours["f64"], ref["f64"], F64)
    _assert_json_close(ours["cross"], ref["cross"], F32)
    assert ref["cross"]["x1_rms_delta"] > 1e-3  # two fields, not rounding


# ---------------------------------------------------------------------------
# probe_mode_study
# ---------------------------------------------------------------------------

SMALL_PROBE = ["--atoms", "3", "--features", "8", "--layers", "1"]


def test_probe_mode_exact_trace_matches_jax():
    """The ground truth of every node: the port's exact trace at its node
    states equals ti_tpu's ``divergence_exact`` on the same weights."""
    import argparse

    from ti_tpu.data.mdqm9 import graph_template as jax_template
    from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
    from ti_tpu.ops.divergence import divergence_exact as jax_divergence_exact
    from ti_tpu.sampling.drivers import molecular_v_fn_of as jax_v_fn_of
    from ti_torch.sampling.drivers import molecular_v_fn_of

    args = argparse.Namespace(atoms=5, features=16, layers=2, params=None)
    model, params, template, label = probe_mode_study.build_field(args, torch.device("cpu"))
    assert label == "random-init"
    temps = torch.tensor([[1000.0, 300.0]])
    v = molecular_v_fn_of(model, params, template, device="cpu")(temps)
    xs, ts = probe_mode_study.node_states(v, 5, 3, 0, torch.device("cpu"))
    ours = probe_mode_study.exact_traces(v, xs, ts)

    jm = jax_cpainn.CPaiNN(n_features=16, score_layers=2, temp_length=100.0,
                           conditioning="ambient")
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_flax(params))
    jv = jax_v_fn_of(jm, jp, jax_template(jax_molecule(n_atoms=5, seed=0), t_cond=2))(
        jnp.array([1000.0, 300.0], jnp.float32))
    exact_at = jax.jit(lambda x, t: jax_divergence_exact(lambda y: jv(y, t), x)[1])
    ref = [float(exact_at(jnp.asarray(x), t)) for x, t in zip(xs.numpy(), ts)]
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    assert np.abs(ref).min() > 1e-2


def test_probe_mode_study_orthogonal_frame_is_exact(capsys):
    """tests/test_cli_scripts.py::test_probe_mode_study_cli's checks, on the
    port: the orthogonal frame at K = d reads the exact trace, Rademacher
    draws do not."""
    argv = SMALL_PROBE + ["--keys", "3", "--probes", "3,9", "--nodes", "1", "--device", "cpu"]
    assert probe_mode_study.main(argv) == 0
    line = [ln for ln in _lines(capsys) if ln.startswith("rows: ")][-1]
    rows = {(x["mode"], x["K"]): x for x in json.loads(line[len("rows: "):])}
    assert rows[("orthogonal", 9)]["rms_err"] < 1e-4  # exact at K = d
    assert rows[("rademacher", 9)]["rms_err"] > 1e-3  # iid draws are not
    assert ("orthogonal", 3) in rows and ("rademacher", 3) in rows


def test_probe_mode_study_reads_the_checkpoints_arch(tmp_path, capsys):
    """``--params``: a port checkpoint whose arch overrides the flags."""
    from ti_torch.models.cpainn import CPaiNN

    model = CPaiNN(8, 1, n_atoms=4, temp_length=50.0, generator=torch.Generator().manual_seed(3))
    path = tmp_path / "field.npz"
    save_npz(str(path), model.state_dict(),
             arch={"atoms": 4, "features": 8, "layers": 1, "temp_length": 50.0})
    argv = ["--params", str(path), "--keys", "2", "--probes", "12", "--nodes", "1",
            "--device", "cpu"]
    assert probe_mode_study.main(argv) == 0
    out = capsys.readouterr()
    assert "using the checkpoint's arch (atoms=4, F=8, layers=1, temp_length=50)" in out.err
    assert "trained field" in out.err
    rows = json.loads(out.out.strip().splitlines()[-1][len("rows: "):])
    assert {(r["mode"], r["K"]) for r in rows} == {("rademacher", 12), ("orthogonal", 12)}
    assert next(r for r in rows if r["mode"] == "orthogonal")["rms_err"] < 1e-4


def test_probe_mode_study_refuses_oracle_with_params(capsys):
    argv = ["--oracle", "--params", "x.npz"]
    with pytest.raises(SystemExit) as jax_exit:
        jax_probe_mode_study.main(argv)
    assert "--oracle trains its own" in capsys.readouterr().err
    with pytest.raises(SystemExit) as port_exit:
        probe_mode_study.main(argv + ["--device", "cpu"])
    assert "--oracle trains its own" in capsys.readouterr().err
    assert port_exit.value.code == jax_exit.value.code == 2


def test_probe_mode_oracle_runs_and_reuses(tmp_path, monkeypatch, capsys):
    """``--oracle`` at 3 atoms, one epoch: the JAX script's rows (exact,
    then each mode and K), finite; ``--reuse`` then reads the cached field
    and reproduces them."""
    monkeypatch.setattr(probe_mode_study, "ORACLE_DIR", str(tmp_path))
    argv = SMALL_PROBE + ["--oracle", "--train_epochs", "1", "--chains", "8", "--probes", "2",
                         "--reuse", "--device", "cpu"]
    assert probe_mode_study.main(argv) == 0
    first = _lines(capsys)
    rows = json.loads(first[-1][len("rows: "):])
    assert [(r["mode"], r["K"]) for r in rows] == [("exact", 9), ("rademacher", 2),
                                                    ("orthogonal", 2)]
    assert all(np.isfinite(r["dF_err"]) and 0 < r["ess_pct"] <= 100 for r in rows)
    assert (tmp_path / "ckpt_a3_f8_l1_e1.npz").exists()
    assert probe_mode_study.main(argv) == 0
    out = capsys.readouterr()
    assert "reusing the trained oracle" in out.err
    assert out.out.strip().splitlines()[-1] == first[-1]


# ---------------------------------------------------------------------------
# the scans and the profile
# ---------------------------------------------------------------------------

def _labels(lines):
    """The printed lines without their numbers: the text before the last
    colon of a row, or a JSON line's keys."""
    out = set()
    for line in lines:
        if line.startswith(("best: ", "rows: ")):
            tag, body = line.split(": ", 1)
            out |= {f"{tag}:{k}" for k in json.loads(body)}
        elif line.startswith("{"):
            out |= {f"row:{k}" for k in json.loads(line)}
        elif ":" in line:
            out.add(line.split(":")[0].strip())
    return out


SDE_SMALL = ["--atoms", "4", "--features", "16", "--layers", "1", "--chains", "3,5",
             "--steps", "2", "--reps", "1"]


def test_sde_scan_rows_match_jax(monkeypatch, capsys):
    dense = ["--chains", "3", "--dtypes", "f32,bf16_agg", "--impls", "dense"]
    _run_jax_script(monkeypatch, "sde_scan.py", SDE_SMALL + dense)
    ref = _lines(capsys)
    assert sde_scan.main(SDE_SMALL + dense + ["--device", "cpu"]) == 0
    ours = _lines(capsys)
    assert len(ref) == 3 and _labels(ref) <= _labels(ours)
    assert [ln.split(":")[0] for ln in ours[:2]] == [ln.split(":")[0] for ln in ref[:2]]
    # every impl, dtype and chain block on the plain versions: no row fails
    argv = SDE_SMALL + ["--impls", "dense,pair_kernel", "--chain_blocks", "1,4",
                        "--device", "cpu"]
    assert sde_scan.main(argv) == 0
    rows = json.loads(_lines(capsys)[-1][len("rows: "):])
    assert len(rows) == 2 * (3 + 2 * 2)
    assert all(r["samples_per_s"] > 0 and r["launches"] == {} for r in rows)


LARGE_SMALL = ["--atoms", "4", "--features", "16", "--layers", "1", "--chains", "2",
               "--probes", "2", "--steps", "2", "--gl_points", "2", "--reps", "1"]


def test_large_scale_scan_rows_match_jax(capsys):
    jax_large_scale_scan.main(LARGE_SMALL + ["--impls", "default"])
    ref = _lines(capsys)
    assert large_scale_scan.main(LARGE_SMALL + ["--impls", "default", "--device", "cpu"]) == 0
    ours = _lines(capsys)
    assert len(ref) == len(ours) == 1 and _labels(ref) <= _labels(ours)
    argv = LARGE_SMALL + ["--impls", "default,pair_kernel,pair_kernel_bf16", "--div_impls",
                          "default,pair_tangent,pair_tangent_bf16", "--device", "cpu"]
    assert large_scale_scan.main(argv) == 0
    rows = [json.loads(ln) for ln in _lines(capsys)]
    assert len(rows) == 9 and all(r["samples_per_sec"] > 0 for r in rows)


def test_scans_record_only_oom_and_the_width_refusal(monkeypatch, capsys):
    """A width refusal (or an OOM) is a data row; any other error stops
    the scan and reaches the caller."""
    import ti_torch.sampling.drivers as drivers

    real_drift = plk.pair_kernel_drift

    def refusing_drift(model, params, template, *, compute_dtype=None, **kw):
        drift = real_drift(model, params, template, compute_dtype=compute_dtype, **kw)
        if compute_dtype is not None:
            return drift

        def refuse(xs, t, conds):
            plk.check_width(256, "pair_layer_tf32x3")

        return refuse

    monkeypatch.setattr(plk, "pair_kernel_drift", refusing_drift)
    argv = LARGE_SMALL + ["--impls", "default,pair_kernel,pair_kernel_bf16", "--device", "cpu"]
    assert large_scale_scan.main(argv) == 0
    rows = [json.loads(ln) for ln in _lines(capsys)]
    assert [("error" in r) for r in rows] == [False, True, False]
    assert rows[1]["error"].startswith("WidthRefusal: pair_layer_tf32x3 is built for F=128, "
                                       "got F=256; F = 64, 128 and 256 run in B1, B2 and B3 on "
                                       "the tensor cores")

    real_sde = drivers.sample_molecular_sde

    def oom_above_4(model, params, template, x0, *a, **kw):
        if x0.shape[0] > 4:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real_sde(model, params, template, x0, *a, **kw)

    monkeypatch.setattr(drivers, "sample_molecular_sde", oom_above_4)
    assert sde_scan.main(SDE_SMALL + ["--dtypes", "f32", "--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert lines[1].startswith("chains=    5 f32           : FAILED (OutOfMemoryError")
    assert json.loads(lines[-1][len("rows: "):])[0]["chains"] == 3

    def broken(*a, **kw):
        raise RuntimeError("not a data point")

    monkeypatch.setattr(drivers, "sample_molecular_sde", broken)
    with pytest.raises(RuntimeError, match="not a data point"):
        sde_scan.main(SDE_SMALL + ["--device", "cpu"])
    monkeypatch.setattr(plk, "pair_kernel_drift",
                        lambda *a, **kw: lambda xs, t, conds: broken())
    with pytest.raises(RuntimeError, match="not a data point"):
        large_scale_scan.main(argv)


def test_width_refusal_is_a_value_error():
    assert issubclass(plk.WidthRefusal, ValueError)
    with pytest.raises(plk.WidthRefusal, match="kernel B7 is built for F=128, got F=256"):
        plk.check_width(256, "kernel B7")


def test_profile_divergence_rows_match_jax(monkeypatch, capsys):
    """Both profiles at 2 chains on an F = 8 x 1 field, one call a timing:
    the JAX script's lines (it skips the fused rows off the TPU) are among
    the port's, and the port's last line holds every row's time."""
    import ti_torch.models.cpainn as port_cpainn
    import ti_torch.utils.timing as port_timing

    jax_model, port_model = jax_cpainn.CPaiNN, port_cpainn.CPaiNN
    monkeypatch.setattr(jax_cpainn, "CPaiNN",
                        lambda **kw: jax_model(**dict(kw, n_features=8, score_layers=1)))
    monkeypatch.setattr(port_cpainn, "CPaiNN", lambda f, l, **kw: port_model(8, 1, **kw))
    jax_time, port_time = jax_timing.device_time, port_timing.device_time
    monkeypatch.setattr(jax_timing, "device_time",
                        lambda fn, *a, reps=8: jax_time(fn, *a, reps=1))
    monkeypatch.setattr(port_timing, "device_time",
                        lambda fn, *a, reps=8, device=None: port_time(fn, *a, reps=1,
                                                                     device=device))
    _run_jax_script(monkeypatch, "profile_divergence.py", ["2"])
    ref = _lines(capsys)
    assert profile_divergence.main(["2", "--device", "cpu"]) == 0
    ours = _lines(capsys)
    assert _labels(ref) <= _labels(ours)
    assert {"primal fused  batch=2", "div fused     batch=2"} <= _labels(ours) - _labels(ref)
    rows = json.loads(ours[-1][len("rows: "):])
    assert rows["chains"] == 2 and len(rows["ms"]) == 14
    assert all(t > 0 for t in rows["ms"].values())
    assert all(n == {} for n in rows["launches"].values())  # the CPU runs no kernel


# ---------------------------------------------------------------------------
# adw_plots
# ---------------------------------------------------------------------------

@pytest.fixture()
def spectra(tmp_path):
    rng = np.random.default_rng(6)
    for name in ("rw", "direct"):
        np.savez(tmp_path / f"{name}.npz", betas=np.array([1.25, 1.5]),
                 eigenvalues_mean=rng.uniform(0.01, 0.1, (2, 4)),
                 lower=rng.uniform(0.005, 0.01, (2, 4)), upper=rng.uniform(0.1, 0.2, (2, 4)))
    return tmp_path


def test_adw_plots_draws_what_jax_draws(spectra, capsys):
    """Both figures (lambda_2 against beta with the direct baseline, and
    the schematic beside it) from the same npz, with the same lines."""
    printed = {}
    for tag, main in (("j", jax_adw_plots.main), ("t", adw_plots.main)):
        rc = main(["--reweighted", str(spectra / "rw.npz"), "--direct",
                   str(spectra / "direct.npz"), "--schematic", "--out",
                   str(spectra / f"{tag}.png")])
        assert rc in (None, 0)  # the JAX script's main returns None
        printed[tag] = capsys.readouterr().out.replace(str(spectra / tag), "<out>")
        assert (spectra / f"{tag}.png").stat().st_size > 1000
        assert (spectra / f"{tag}_schematic.png").stat().st_size > 1000
    assert printed["t"] == printed["j"] == "wrote <out>_schematic.png\nwrote <out>.png\n"


def test_adw_plots_refuses_without_matplotlib(spectra, monkeypatch, capsys):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    assert adw_plots.main(["--reweighted", str(spectra / "rw.npz"), "--out",
                           str(spectra / "x.png")]) == 2
    assert "matplotlib is not available" in capsys.readouterr().err
    assert not (spectra / "x.png").exists()


# ---------------------------------------------------------------------------
# no card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cli, argv", [
    (step_count_study, ["--n_samples", "100"]),
    (adw_f64_study, ["--out", "{tmp}"]),
    (probe_mode_study, []),
    (sde_scan, []),
    (large_scale_scan, []),
    (profile_divergence, []),
], ids=["step_count_study", "adw_f64_study", "probe_mode_study", "sde_scan",
        "large_scale_scan", "profile_divergence"])
def test_card_clis_raise_without_a_card(cli, argv, tmp_path, monkeypatch):
    """No card and no ``--device``: each CLI that computes raises before it
    writes anything; none falls back to the CPU."""
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([a.replace("{tmp}", str(tmp_path / "out")) for a in argv])
    assert not os.listdir(tmp_path)
