"""The port's ``validate_bg_ti_physics`` CLI (ti_torch/cli) against
scripts/validate_bg_ti_physics.py on the CPU (``--device cpu``).

The script trains both stages and evaluates in one ``main``; the port
splits it into ``train(args)`` and ``evaluate(fields, args)``. The test
gives ``evaluate`` two 4-atom fields (F = 8, 1 layer) at flax's
initialisation, carried across with ``params_from_flax`` — the latent
generator at T0 and the ambient T0 -> T1 field — and runs the script's own
evaluation with ``ti_tpu``'s functions on the same fields (its configs,
``sample_latent``, ``sample_ambient(latent_z=, latent_dlogp=)`` and
``calc_importance_weights``), the port on the noise ``ti_tpu``'s sampler
drew. With the exact divergence (both stages on the Gauss path,
``--latent_quad``; tests/test_torch_validate_latent.py holds the
stage-coupled latent route) the JSON keys are the same and every
number agrees at rtol 1e-4. A Hutchinson row with ``--probe_debias``
cannot replay JAX's probes: its keys are present and finite, and the
debiased row is the identity of log w - (var_bg + var_ti)/2 on the run's
own samples and variances. ``main`` trains (one epoch of each stage) and
then evaluates.
"""

import contextlib
import io
import json

import numpy as np
import pytest

from ti_torch.analysis import oracles
from ti_torch.cli import validate_bg_ti_physics as cli
from ti_torch.models.convert import params_from_flax

N_ATOMS = 4
ARGV = ["--features", "8", "--layers", "1", "--atoms", "4", "--n_gen", "32", "--sample_batch",
        "32", "--gl_points", "2", "--latent_quad"]


def _quiet(fn, *a):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        return fn(*a)


def jax_evaluate(fields, args):
    """The script's evaluation (scripts/validate_bg_ti_physics.py, after its
    two trainings) on given JAX fields: the JSON row it prints, and the
    latent noise it drew."""
    from ti_tpu.analysis.weights import calc_ess, calc_importance_weights
    from ti_tpu.config import MDQM9Config
    from ti_tpu.sampling.drivers import sample_ambient, sample_latent

    T0, T1, N = args.T0, args.T1, args.atoms
    d_eff = 3 * (N - 1)

    def sigma(T):
        return args.jitter * np.sqrt(T / 300.0)

    common = dict(n_features=args.features, score_layers=args.layers, batch_size=args.batch,
                  learning_rate=args.lr, scale_trajs=False, solver_type="rk4", n_steps=64,
                  return_dlogp=True, divergence=args.divergence, num_probes=args.num_probes,
                  probe_mode=args.probe_mode, steps_per_dispatch=16,
                  compute_dtype=args.compute_dtype, dlogp_quad="gauss", use_wandb=False)
    lat_cfg = MDQM9Config(T=[T0], sampling_T=T0,
                          dlogp_quad_points=args.gl_points if args.latent_quad else 0, **common)
    amb_cfg = MDQM9Config(gamma="brownian", a=0.1, T0s=[T0, T1], T1s=[T0, T1], sampling_T0=T0,
                          sampling_T1=T1, dlogp_quad_points=args.gl_points, **common)
    (lm, lp, lt), (am, ap, at) = fields["latent"], fields["ambient"]
    lat_out = sample_latent(lat_cfg, lm, lp, lt, n_samples=args.n_gen, save=False,
                            batch_size=min(args.n_gen, args.sample_batch))
    z, x0, dlogp_bg = lat_out["samples"][:, 0], lat_out["samples"][:, -1], lat_out["dlogps"]
    out = sample_ambient(amb_cfg, am, ap, at, x0, latent_z=z, latent_dlogp=dlogp_bg, save=False,
                         batch_size=min(args.n_gen, 256, args.sample_batch))
    x1, dlogp_ti = out["samples"][:, -1], out["dlogps"]
    x1c = x1 - x1.mean(axis=1, keepdims=True)
    width = float(np.sqrt(np.sum(x1c**2, axis=(1, 2)).mean() / d_eff))
    E1 = np.sum(x1c**2, axis=(1, 2)) / (2.0 * sigma(T1) ** 2)
    q, _ = np.linalg.qr(np.eye(N) - 1.0 / N)
    z_sub = np.einsum("ij,njc->nic", q[:, : N - 1].T, z)
    log_pz = -0.5 * np.sum(z**2, axis=(1, 2)) - 0.5 * d_eff * np.log(2 * np.pi)
    log_w = -E1 - log_pz - dlogp_bg - dlogp_ti
    mx = log_w.max()
    w_ref = calc_importance_weights(z_sub.reshape(len(z), -1), E1 + mx, neg_dlogps_bg=dlogp_bg,
                                    neg_dlogps_ti=dlogp_ti)
    np.testing.assert_allclose(w_ref, np.exp(log_w - mx), rtol=1e-4)
    est = float(-(mx + np.log(np.mean(np.exp(log_w - mx)))))
    exact = float(-0.5 * d_eff * np.log(2 * np.pi * sigma(T1) ** 2))
    ess = calc_ess(np.exp(log_w - mx))
    return {"width": width, "width_target": sigma(T1), "width_bg_stage": sigma(T0),
            "neg_log_Z_est": est, "neg_log_Z_exact": exact, "abs_err": abs(est - exact),
            "ess": ess, "ess_frac": ess / len(x1), "n": len(x1)}, np.asarray(z)


@pytest.fixture(scope="module")
def fields():
    """Both stages' fields at flax's initialisation, in both packages."""
    import jax

    from ti_torch.config import MDQM9Config
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.train.ambient import build_ambient_model
    from ti_torch.train.latent import build_latent_model
    from ti_tpu.config import MDQM9Config as JaxConfig
    from ti_tpu.data.mdqm9 import graph_template as jax_template
    from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
    from ti_tpu.train.ambient import build_ambient_model as jax_ambient
    from ti_tpu.train.latent import build_latent_model as jax_latent

    size = dict(n_features=8, score_layers=1)
    jax_fields, port_fields = {}, {}
    for name, t_cond, jbuild, build, seed in (("latent", 0, jax_latent, build_latent_model, 3),
                                              ("ambient", 2, jax_ambient, build_ambient_model, 4)):
        jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=t_cond)
        jm = jbuild(JaxConfig(T=[500], **size))
        jp = jm.init(jax.random.PRNGKey(seed), jt)
        jax_fields[name] = (jm, jp, jt)
        port_fields[name] = (build(MDQM9Config(T=[500], **size), N_ATOMS),
                             params_from_flax(jax.tree_util.tree_map(np.asarray, jp)),
                             graph_template(make_synthetic_molecule(N_ATOMS, seed=0),
                                            t_cond=t_cond))
    return jax_fields, port_fields


def test_evaluate_matches_the_scripts_evaluation(fields, monkeypatch):
    from ti_torch.sampling import drivers

    jax_fields, port_fields = fields
    args = cli.parse([*ARGV, "--device", "cpu"])
    ref, z = _quiet(jax_evaluate, jax_fields, args)
    real = drivers.sample_latent
    monkeypatch.setattr(drivers, "sample_latent", lambda *a, **kw: real(*a, **kw, noise=z))
    row = _quiet(cli.evaluate, port_fields, args, "cpu")
    assert set(row) == set(ref) and row["n"] == ref["n"] == 32
    for k, v in ref.items():
        assert np.isfinite(row[k]), k
        np.testing.assert_allclose(row[k], v, rtol=1e-4, err_msg=k)


def test_debiased_row_on_hutchinson_probes(fields, monkeypatch):
    from ti_torch.sampling import drivers

    _, port_fields = fields
    args = cli.parse([*ARGV, "--device", "cpu", "--divergence", "hutchinson", "--num_probes",
                      "4", "--probe_debias"])
    outs = {}
    for name in ("sample_latent", "sample_ambient"):
        real = getattr(drivers, name)

        def keep(*a, _real=real, _name=name, **kw):
            outs[_name] = _real(*a, **kw)
            return outs[_name]

        monkeypatch.setattr(drivers, name, keep)
    row = _quiet(cli.evaluate, port_fields, args, "cpu")
    for k in ("neg_log_Z_est_debiased", "abs_err_debiased", "ess_frac_debiased",
              "dlogp_var_mean", "neg_log_Z_est", "ess_frac"):
        assert np.isfinite(row[k]), k
    lat, amb = outs["sample_latent"], outs["sample_ambient"]
    z, x1 = lat["samples"][:, 0], amb["samples"][:, -1]
    var = amb["dlogp_vars"] + lat["dlogp_vars"]
    assert (var > 0).all()
    log_w = (-oracles.well_energy(x1, oracles.well_sigma(300, 0.25))
             - oracles.gaussian_log_pz(z, 3 * (N_ATOMS - 1)) - lat["dlogps"] - amb["dlogps"])
    np.testing.assert_allclose(row["neg_log_Z_est"], oracles.neg_log_mean_exp(log_w), rtol=1e-10)
    np.testing.assert_allclose(row["neg_log_Z_est_debiased"],
                               oracles.neg_log_mean_exp(log_w - 0.5 * var), rtol=1e-10)
    np.testing.assert_allclose(row["dlogp_var_mean"], var.mean(), rtol=1e-6)


def test_main_trains_then_evaluates(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main([*ARGV, "--device", "cpu", "--latent_epochs", "1", "--ambient_epochs",
                         "1", "--frames", "64", "--batch", "32", "--divergence", "hutchinson",
                         "--num_probes", "2", "--out_dir", str(tmp_path)]) == 0
    row = json.loads(out.getvalue().strip().splitlines()[-1])
    assert row["n"] == 32 and all(np.isfinite(v) for v in row.values())


def test_needs_a_device_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--latent_epochs", "1"])
