"""The fan-out (ti_torch.parallel.fanout) against ti_tpu's, and the port's
CLI chain run in-process through ``main(argv)``: train, sample, sample in
two shards, merge; then the fan-out driver over a stub command.

The CLIs run on the CPU (``--device cpu``) at N = 5 atoms, F = 16, one
message layer, on a synthetic workspace in the reference's on-disk layout
(``write_synthetic_workspace``). The stub shards sleep at most 2 s.
"""

import dataclasses
import json
import os
import sys
import textwrap

import numpy as np
import pytest

from ti_torch.cli import fanout_driver, mdqm9_sample_ambient, mdqm9_train_ambient, merge_shards
from ti_torch.config import MDQM9Config
from ti_torch.data.mdqm9 import write_synthetic_workspace
from ti_torch.parallel.fanout import merge_shards as merge
from ti_torch.parallel.fanout import shard_config, shard_slice
from ti_tpu.config import MDQM9Config as JaxMDQM9Config
from ti_tpu.parallel.fanout import merge_shards as jax_merge
from ti_tpu.parallel.fanout import shard_config as jax_shard_config
from ti_tpu.parallel.fanout import shard_slice as jax_shard_slice


def test_shard_slice_and_config_match_jax():
    """ti_tpu's own cases (contiguous, disjoint, exhaustive; a no-op at K =
    1; the shard suffix; a shard past K refused), and both functions equal
    to ti_tpu's over a grid of workloads and configs."""
    assert [shard_slice(10, i, 3) for i in range(3)] == [(0, 4), (4, 7), (7, 10)]
    for n in (0, 1, 5, 16, 257):
        for k in (1, 2, 3, 4, 7):
            assert [shard_slice(n, i, k) for i in range(k)] == \
                [jax_shard_slice(n, i, k) for i in range(k)]
    with pytest.raises(ValueError):
        shard_slice(10, 3, 3)
    cfg = MDQM9Config(seed=5, data_save_name="run")
    assert shard_config(cfg, 0, 1) is cfg
    c0, c1 = shard_config(cfg, 0, 4), shard_config(cfg, 1, 4)
    assert c0.seed != c1.seed != cfg.seed and c0.data_save_name == "run_shard0of4"
    for seed, k in ((0, 2), (5, 4), (123, 3)):
        for i in range(k):
            ours = dataclasses.asdict(shard_config(MDQM9Config(seed=seed, data_save_name="x"), i, k))
            ref = dataclasses.asdict(jax_shard_config(JaxMDQM9Config(seed=seed, data_save_name="x"),
                                                      i, k))
            assert {f: ours[f] for f in ("seed", "shard", "num_shards", "data_save_name")} == \
                {f: ref[f] for f in ("seed", "shard", "num_shards", "data_save_name")}


def _write_shards(d):
    """Molecular (chain axis 0), ADW time-major 2-D (chain axis 1) and 1-D
    shard artifacts, as tests/test_parallel.py writes them."""
    for i, n in enumerate((3, 2)):
        np.save(d / f"samples_run_shard{i}of2.npy", np.full((n, 2, 4, 3), i, np.float32))
        np.save(d / f"dlogps_run_shard{i}of2.npy", np.full((2, n), i, np.float32))
        np.save(d / f"latent_dlogps_run_shard{i}of2.npy", np.full((n,), i, np.float32))


def test_merge_shards_matches_jax(tmp_path):
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    for d in (ours, ref):
        d.mkdir()
        _write_shards(d)
    merged = merge(str(ours), 2)
    jax_merge(str(ref), 2)
    assert len(merged) == 3
    for name in ("samples_run.npy", "dlogps_run.npy", "latent_dlogps_run.npy"):
        np.testing.assert_array_equal(np.load(ours / name), np.load(ref / name))
    assert np.load(ours / "samples_run.npy").shape == (5, 2, 4, 3)
    assert np.load(ours / "dlogps_run.npy").shape == (2, 5)  # the ADW layout, chain axis 1
    (ours / "samples_run_shard1of2.npy").unlink()
    with pytest.raises(FileNotFoundError, match="missing shard artifact"):
        merge(str(ours), 2)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no '\\*_shard0of2\\*.npy' artifacts"):
        merge(str(empty), 2)


def test_merge_cli_deletes_the_shards(tmp_path, capsys):
    _write_shards(tmp_path)
    assert merge_shards.main([str(tmp_path), "2", "--delete"]) == 0
    assert "<- 2 shards" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["dlogps_run.npy", "latent_dlogps_run.npy",
                                            "samples_run.npy"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A trained checkpoint (one epoch through the train CLI) beside the
    synthetic workspace, and the flags every CLI call of the chain shares."""
    root = tmp_path_factory.mktemp("torch_cli")
    write_synthetic_workspace(str(root), n_atoms=5, n_frames=12)
    common = [
        "--device", "cpu", "--preset", "00031:300",
        "--traj_path", str(root / "trajs"), "--sdf_path", str(root),
        "--model_save_path", str(root / "models"), "--data_save_path", str(root / "out"),
        "--n_features", "16", "--score_layers", "1", "--batch_size", "8",
        "--n_epochs", "1", "--n_steps", "4", "--solver_type", "rk4",
        "--model_epoch", "0", "--model_save_name", "smoke",
    ]
    assert mdqm9_train_ambient.main(common + ["--data_save_name", "train"]) == 0
    assert (root / "models" / "smoke" / "smoke_0_weights.npz").exists()
    return root, common


def _sample(common, name, extra=(), capsys=None):
    assert mdqm9_sample_ambient.main(common + ["--data_save_name", name, *extra]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("profile", [[], ["--fast_profile", "--num_probes", "4"]],
                         ids=["rk4_exact", "fast_profile"])
def test_sample_in_two_shards_and_merge(workspace, capsys, profile):
    """The unsharded run, then two shards and the merge: the merged samples
    are the unsharded run's (the trajectory does not depend on the seed),
    the merged dlogps have its shape (and its values with the exact
    divergence), and each shard reports its chains."""
    root, common = workspace
    out = root / "out"
    tag = "fast" if profile else "exact"
    whole = _sample(common + profile, tag, capsys=capsys)
    assert whole["n"] == 12 and whole["num_shards"] == 1
    assert set(whole["launches"]) == {"pair_layer", "pair_tangent"}
    lines = [_sample(common + profile, tag, ["--shard", str(i), "--num_shards", "2"], capsys)
             for i in range(2)]
    assert [(r["n"], r["shard"]) for r in lines] == [(6, 0), (6, 1)]
    ref_s, ref_d = np.load(out / f"samples_{tag}.npy"), np.load(out / f"dlogps_{tag}.npy")
    for stem in ("samples", "dlogps", "latent_noises", "latent_dlogps"):
        os.remove(out / f"{stem}_{tag}.npy")
    assert merge_shards.main([str(out), "2", "--delete"]) == 0
    merged_s, merged_d = np.load(out / f"samples_{tag}.npy"), np.load(out / f"dlogps_{tag}.npy")
    assert merged_s.shape == ref_s.shape == (12, 2, 5, 3)
    np.testing.assert_allclose(merged_s, ref_s, rtol=1e-5, atol=1e-6)
    assert merged_d.shape == ref_d.shape and np.isfinite(merged_d).all()
    if not profile:
        np.testing.assert_allclose(merged_d, ref_d, rtol=1e-5, atol=1e-5)


STUB = textwrap.dedent("""\
    import argparse, os, pathlib, sys, time
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', required=True)
    ap.add_argument('--fail_shard', type=int, default=-1)
    ap.add_argument('--sleep', type=float, default=0.0)
    ap.add_argument('--shard', type=int, required=True)
    ap.add_argument('--num_shards', type=int, required=True)
    a = ap.parse_args()
    if a.shard == a.fail_shard:
        print('boom'); sys.exit(3)
    print('env marker:', os.environ.get('TI_FANOUT_TEST'))
    time.sleep(a.sleep)
    if a.sleep:
        pathlib.Path(a.out, f'finished_{a.shard}').touch()
    else:
        import numpy as np
        # the ADW time-major layout (n_save, n_chains): chain axis 1
        np.save(os.path.join(a.out, f'samples_run_shard{a.shard}of{a.num_shards}.npy'),
                np.full((2, a.shard + 1), a.shard, np.float32))
""")


@pytest.fixture
def stub(tmp_path):
    path = tmp_path / "stub.py"
    path.write_text(STUB)
    out = tmp_path / "out"
    out.mkdir()
    return path, out


def _drive(stub, flags, extra=()):
    path, out = stub
    return fanout_driver.main(["--num_shards", "3", "--data_dir", str(out), "--max_parallel",
                               "2", *flags, "--", sys.executable, str(path), "--out", str(out),
                               *extra])


def test_fanout_driver_launches_and_merges(stub, capsys):
    """One process a shard with --shard/--num_shards appended, at most 2 at
    once, the --env marker ({shard} becoming each shard's index) in each
    shard's log, and the merge."""
    out = stub[1]
    assert _drive(stub, ["--env", "TI_FANOUT_TEST=shard-{shard}"]) == 0
    merged = np.load(out / "samples_run.npy")
    np.testing.assert_array_equal(merged, [[0, 1, 1, 2, 2, 2]] * 2)
    for i in range(3):
        assert f"env marker: shard-{i}" in (out / "fanout_logs" / f"shard_{i}.log").read_text()
    assert "[fanout] merged" in capsys.readouterr().out


def test_fanout_driver_reports_a_failed_shard(stub, capsys):
    assert _drive(stub, [], ["--fail_shard", "1"]) == 1
    assert "FAILED shard 1" in capsys.readouterr().err
    assert not (stub[1] / "samples_run.npy").exists()


def test_fanout_driver_fail_fast_kills_the_healthy_shards(stub, capsys):
    """Shard 0 fails at once; with --fail_fast shard 1 (running, 2 s from
    done) is killed and shard 2 never starts."""
    assert _drive(stub, ["--fail_fast", "--no_merge"], ["--fail_shard", "0", "--sleep", "2"]) == 1
    err = capsys.readouterr().err
    assert "FAILED shard 0" in err and "--fail_fast" in err
    assert not list(stub[1].glob("finished_*")), "healthy shards were not killed"
