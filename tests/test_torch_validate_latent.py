"""The port's ``validate_latent_physics`` CLI (ti_torch/cli) against
scripts/validate_latent_physics.py, both run in-process on the CPU
(``--device cpu``) at a tiny size.

The field is a 4-atom unconditioned latent cPaiNN (F = 8, 1 layer) at
flax's initialisation, written as the JAX script writes its trained one
(an orbax checkpoint ``{"params"}`` at ``out_dir/oracle_params``; the
script's training is its jit compile here, tens of seconds), read back
with ``load_checkpoint``, carried across with ``params_from_flax`` and
written as the port's ``oracle_params.npz`` with its arch. Both packages
run ``--reuse`` on it (32 chains, RK4-2), the port on the noise the JAX
sampler drew (the test hands ``ti_tpu``'s ``samples[:, 0]`` to the port's
``sample_latent(noise=)``): with the exact divergence, stage-coupled and
on the Gauss path, the JSON keys are the same and every number agrees at
rtol 1e-4. A Hutchinson row cannot replay JAX's probes: its keys are
present and finite. The port's arch check of ``--reuse`` exits, and its
own training round trip reproduces its row.
"""

import contextlib
import io
import json

import numpy as np
import pytest

from scripts import validate_latent_physics as jax_cli
from ti_torch.cli import validate_latent_physics as cli
from ti_torch.models.convert import params_from_flax, save_npz

SIZE = ["--features", "8", "--layers", "1", "--atoms", "4", "--n_gen", "32", "--n_steps", "2"]
ARCH = {"features": 8, "layers": 1, "atoms": 4}
ROUTES = {"exact": [], "gauss": ["--quad_dlogp", "--gl_points", "2"]}


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().strip().splitlines()


@pytest.fixture(scope="module")
def field(tmp_path_factory):
    """The JAX package's latent field as the script saves it, and as the
    port's npz."""
    import jax

    from ti_tpu.config import MDQM9Config
    from ti_tpu.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_tpu.train.common import load_checkpoint, save_checkpoint
    from ti_tpu.train.latent import build_latent_model

    out_dir = str(tmp_path_factory.mktemp("validate_latent"))
    model = build_latent_model(MDQM9Config(n_features=8, score_layers=1, T=[300]))
    variables = model.init(jax.random.PRNGKey(1),
                           graph_template(make_synthetic_molecule(4, seed=0), t_cond=0))
    save_checkpoint(f"{out_dir}/oracle_params", {"params": variables})
    ckpt = load_checkpoint(f"{out_dir}/oracle_params")
    save_npz(f"{out_dir}/oracle_params.npz", params_from_flax(ckpt["params"]), arch=ARCH)
    return out_dir


@pytest.mark.parametrize("route", list(ROUTES))
def test_json_matches_jax(field, route, monkeypatch):
    import ti_tpu.sampling.drivers as jax_drivers
    from ti_torch.sampling import drivers

    real_jax, real = jax_drivers.sample_latent, drivers.sample_latent
    noise = []

    def jax_sample_latent(*a, **kw):
        out = real_jax(*a, **kw)
        noise.append(np.asarray(out["samples"][:, 0]))
        return out

    monkeypatch.setattr(jax_drivers, "sample_latent", jax_sample_latent)
    monkeypatch.setattr(drivers, "sample_latent",
                        lambda *a, **kw: real(*a, **kw, noise=noise[0]))
    argv = ["--reuse", "--out_dir", field, *SIZE, *ROUTES[route]]
    jax_row = json.loads(_run(jax_cli.main, argv)[-1])
    row = json.loads(_run(cli.main, ["--device", "cpu", *argv])[-1])
    assert set(row) == set(jax_row) and row["n"] == jax_row["n"] == 32
    for k, v in jax_row.items():
        assert np.isfinite(row[k]), k
        np.testing.assert_allclose(row[k], v, rtol=1e-4, err_msg=k)


def test_hutchinson_row_is_finite(field):
    row = json.loads(_run(cli.main, ["--device", "cpu", "--reuse", "--out_dir", field, *SIZE,
                                     "--quad_dlogp", "--gl_points", "2", "--divergence",
                                     "hutchinson", "--num_probes", "4"])[-1])
    assert set(row) == {"width", "width_target", "neg_log_Z_est", "neg_log_Z_exact", "abs_err",
                        "ess", "n"}
    assert all(np.isfinite(v) for v in row.values())


def test_reuse_arch_mismatch_exits(field):
    with pytest.raises(SystemExit, match="--reuse architecture mismatch"):
        _run(cli.main, ["--device", "cpu", "--reuse", "--out_dir", field, *SIZE,
                        "--features", "16"])


def test_trains_and_reuses_its_field(tmp_path):
    argv = ["--device", "cpu", "--out_dir", str(tmp_path), "--frames", "64", "--batch", "32",
            *SIZE]
    trained = json.loads(_run(cli.main, ["--epochs", "1", *argv])[-1])
    assert json.loads(_run(cli.main, ["--reuse", *argv])[-1]) == trained


def test_needs_a_device_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--epochs", "1"])
