"""Phase 18 of chip_smoke.py: the user CLIs (ti_torch/cli), the reference
checkpoint import (ti_torch.utils.torch_import), the trace
(``profile_trace``, ``profile_summary``) and the device timer
(``device_time``) on one NVIDIA H100.

``phase_cli(model, template, card)`` runs after phases 2-17, so the kernel
libraries are built. Every CLI runs in this process through ``main(argv)``
(a process start costs more than its work here), at the 00031 width (19
atoms, F = 128, 5 layers) on a synthetic workspace in the reference's
layout (256 frames a temperature and split, the harmonic well of phase 16).
The launch counts are set to 0 before each step and read after it:

- (a) the latent chain: ``mdqm9_train_latent --preset 00031:300`` for one
  epoch, then ``mdqm9_sample_latent`` on the latent kernel route (256
  chains, RK4-64, GL-8, B3's full frame): exactly 1,440 B1 launches from
  pair_layer_tf32x3 and 40 B3 from pair_tangent_tf32x3, its artifacts equal
  to the bit to ``sample_latent`` called with the same config and seed;
  then ``mdqm9_sample_latent --fast_profile`` as it stands (bf16, the exact
  divergence on the dense forward) at the preset's 256 chains, its nodes in
  lane blocks (``exact_lane_block``): no launch, finite artifacts;
- (b) ``mdqm9_sample_sde --sde_forward_impl pair_kernel`` on the test split
  (256 chains, 20 steps, f32, chain_block 1): exactly 100 B1 launches, its
  samples equal to the bit to ``sample_molecular_sde``;
- (c) ``mdqm9_sample_ambient --fast_profile`` (2 batches of 128: 360 B1, 80
  B3 from pair_tangent_mma), harmonic stand-in energies (OpenMM is not on
  that machine), ``mdqm9_results`` (the full report with the MD references
  at T0 and T1), ``mdqm9_plots`` (figures, or its refusal where matplotlib
  is missing), ``mdqm9_gedmd`` and ``model_selection`` on the transported
  torsions;
- (d) the ADW chain at ``ADWConfig``'s defaults (5 x 256, batch 512, 300k
  samples a beta), two epochs as in phase 14: ``adw_train``, ``adw_sample``
  (the 30,000-chain test split, RK4-64 + GL-8), ``adw_reweight_gedmd`` (50
  bootstraps): no kernel launch, as in ti_tpu;
- (e) the smoke's field written as a reference-layout cPaiNN state dict
  (``torch.save``), loaded through ``cpainn_state_from_torch``: equal to
  the field, its velocity through B1 at 128 chains within f32's bar of the
  plain forward on the CPU, and a main-path batch on it equal to the bit to
  the same batch on the field;
- (f) ``profile_trace`` around one ``fast_profile`` main-path batch of 128
  chains, read back by ``profile_summary``: the card's lanes must hold
  B1's kernel 180 times and B3's 40 times (no CUDA activity in the trace
  fails the phase); the top device ops and the device's busy share;
- (g) ``device_time`` of one B1 f32 launch within 20% of
  ``chip_smoke.cuda_ms`` on the same call.

Nothing here is caught and passed over. A rehearsal on the CPU sets
``DEVICE = "cpu"`` and a small width (``N_ATOMS``, ``LAYERS``, ``PRESET``,
the chain counts); the checks that only the card can meet (launch counts,
the trace's device lanes, (g)) are then logged as skipped.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import tempfile
import time

import numpy as np
import torch

from chip_smoke import BAR, WELL_JITTER, by_lib, cuda_ms, harmonic_energy, log, require

CHAINS, LATENT_CHAINS, N_FRAMES, N_ATOMS, LAYERS = 128, 256, 256, 19, 5
SDE_STEPS = 20
# where the phase runs and the widths it gives the presets: the card and the
# published widths here; a rehearsal on the CPU sets "cpu" and small ones
# (ADW: ADWConfig overrides)
DEVICE, PRESET, ADW = "cuda", {}, {}
KERNEL_ROUTE = ["--fast_profile", "--compute_dtype", "f32", "--traj_forward_impl",
                "pair_kernel", "--div_forward_impl", "pair_tangent"]
# the main path's launches for one batch: GL-8 has 9 trajectory gaps of one
# RK4 step (4 stages) and 8 divergence nodes, one launch a layer
MAIN_B1, MAIN_B3 = 9 * 4, 8


def _card_check(ok: bool, what: str) -> None:
    """A check only the card can meet (its kernels, its trace lanes)."""
    if DEVICE == "cpu":
        log(f"[18 rehearsal] skipped on the CPU: {what}")
        return
    require(ok, what)


def _width() -> list:
    return [a for k, v in PRESET.items() for a in (f"--{k}", str(v))]


def _cli(main, argv) -> dict:
    """Run a CLI's ``main(argv)`` here; exit code 0 required; its last
    printed line as JSON when it is one, else {"stdout": text}."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = main(argv)
    out = text.getvalue().strip()
    require(rc == 0, f"{main.__module__} exits 0 (rc {rc}): {out[-2000:]}")
    last = out.splitlines()[-1] if out else ""
    return json.loads(last) if last.startswith("{") else {"stdout": out}


def _routes() -> dict:
    from ti_torch.ops import _build

    return {k: n for k, n in _build.ROUTE_LAUNCHES.items() if n}


def _sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _latent_chain(root: str, card: str) -> None:
    """(a): train one epoch, sample on the kernel route, against sample_latent."""
    from ti_torch.cli import mdqm9_sample_latent, mdqm9_train_latent
    from ti_torch.data.mdqm9 import MDQM9LatentDataset
    from ti_torch.sampling.drivers import _exact_div_chunk, sample_latent
    from ti_torch.train.common import load_checkpoint
    from ti_torch.train.latent import build_latent_model, checkpoint_path

    flags = ["--preset", "00031:300", "--traj_path", os.path.join(root, "trajs"), "--sdf_path",
             root, "--model_save_path", os.path.join(root, "models"), "--model_save_name", "lat",
             "--model_epoch", "0", "--data_save_path", os.path.join(root, "latent"),
             "--data_save_name", "cli", "--n_latent_samples", str(LATENT_CHAINS), *_width()]
    t0 = time.perf_counter()
    trained = _cli(mdqm9_train_latent.main, ["--device", DEVICE, *flags, "--n_epochs", "1"])
    t_train = time.perf_counter() - t0
    require(trained["epochs"] == 1 and np.isfinite(trained["train_loss"]),
            f"18a: one finite epoch of mdqm9_train_latent: {trained}")
    argv = flags + KERNEL_ROUTE
    line = _cli(mdqm9_sample_latent.main, ["--device", DEVICE, *argv])
    # RK4-64 over GL-8's 9 gaps: 8 steps a gap (4 stages), 8 nodes; a launch a layer
    want = {"pair_layer:pair_layer_tf32x3": 9 * 8 * 4 * LAYERS,
            "pair_tangent:pair_tangent_tf32x3": 8 * LAYERS}
    log(f"[18a latent CLI] mdqm9_train_latent one epoch {t_train:.3f} s (loss "
        f"{trained['train_loss']:.5f}); mdqm9_sample_latent {line['n']} chains on the kernel "
        f"route in {line['seconds']:.3f} s, {line['n'] / line['seconds']:.3f} samples/s (host "
        f"clock, {card}); nfe {line['nfe']}; launches by library {line['route_launches']}")
    require(line["n"] == LATENT_CHAINS, "18a: the latent CLI generates its chains")
    _card_check(line["route_launches"] == want,
                f"18a: the latent CLI launches {want}: {line['route_launches']}")

    cfg = mdqm9_train_latent.parse(argv)
    ds = MDQM9LatentDataset.load(cfg.traj_path, cfg.sdf_path, cfg.mdqm9_traj_filename,
                                 cfg.sdf_filename, split="test", Ts=cfg.T,
                                 scale=cfg.scale_trajs, align=cfg.align)
    params = load_checkpoint(checkpoint_path(os.path.join(cfg.model_save_path,
                                                          cfg.model_save_name),
                                             cfg.model_save_name, cfg.model_epoch))
    t0 = time.perf_counter()
    ref = sample_latent(cfg, build_latent_model(cfg, ds.template.n_atoms), params, ds.template,
                        save=False, device=DEVICE)
    t_ref = time.perf_counter() - t0
    same = all(np.array_equal(np.load(os.path.join(root, "latent", f"{stem}_cli_forward.npy")),
                              ref[stem]) for stem in ("samples", "dlogps"))
    log(f"[18a latent direct] sample_latent, same config and seed: {t_ref:.3f} s; CLI artifacts "
        f"equal to the bit: {same}")
    require(same, "18a: the latent CLI's artifacts equal sample_latent's to the bit")
    require(np.isfinite(ref["samples"]).all() and np.isfinite(ref["dlogps"]).all(),
            "18a: finite samples and dlogp")

    # the published profile as it stands (bf16, the exact divergence on the
    # dense forward, its nodes in lane blocks) at the preset's batch
    pub_argv = flags + ["--fast_profile", "--data_save_name", "pub"]
    cfg_pub = mdqm9_train_latent.parse(pub_argv)
    block = _exact_div_chunk(cfg_pub, build_latent_model(cfg_pub, ds.template.n_atoms),
                             ds.template, torch.device(DEVICE), cfg_pub.batch_size)
    line = _cli(mdqm9_sample_latent.main, ["--device", DEVICE, *pub_argv])
    pub = {stem: np.load(os.path.join(root, "latent", f"{stem}_pub_forward.npy"))
           for stem in ("samples", "dlogps")}
    log(f"[18a latent CLI published] mdqm9_sample_latent --fast_profile: {line['n']} chains in "
        f"a batch of {cfg_pub.batch_size} (bf16, exact divergence, lane block {block} of "
        f"{3 * ds.template.n_atoms}) in {line['seconds']:.3f} s, "
        f"{line['n'] / line['seconds']:.3f} samples/s (host clock, {card}); launches "
        f"{line['route_launches']}")
    require(line["n"] == LATENT_CHAINS and not any(line["route_launches"].values())
            and np.isfinite(pub["samples"]).all() and np.isfinite(pub["dlogps"]).all(),
            "18a: the published latent profile through the CLI: its chains, no kernel, finite")
    _card_check(block is not None, f"18a: the published profile's nodes run in lane blocks at "
                f"{cfg_pub.batch_size} chains: {block}")


def _sde(root: str, card: str) -> None:
    """(b): the SDE CLI on B1's drift against sample_molecular_sde."""
    from ti_torch.cli import mdqm9_sample_sde
    from ti_torch.cli.mdqm9_train_ambient import parse
    from ti_torch.data.mdqm9 import MDQM9AmbientDataset
    from ti_torch.sampling.drivers import sample_molecular_sde
    from ti_torch.train.ambient import build_ambient_model
    from ti_torch.train.common import checkpoint_path, load_checkpoint

    argv = ["--preset", "00031:300", "--traj_path", os.path.join(root, "trajs"), "--sdf_path",
            root, "--model_save_path", os.path.join(root, "models"), "--model_save_name", "smoke",
            "--model_epoch", "0", "--data_save_path", os.path.join(root, "sde"),
            "--data_save_name", "cli", "--sde_forward_impl", "pair_kernel", "--n_steps",
            str(SDE_STEPS), *_width()]
    line = _cli(mdqm9_sample_sde.main, ["--device", DEVICE, *argv])
    want = {"pair_layer:pair_layer_tf32x3": SDE_STEPS * LAYERS}
    log(f"[18b SDE CLI] {line['n']} chains, {line['n_steps']} steps, g {line['g']}, "
        f"{line['impl']}: {line['seconds']:.3f} s, {line['n'] / line['seconds']:.3f} samples/s "
        f"(host clock, {card}); launches by library {line['route_launches']}")
    _card_check(line["route_launches"] == want,
                f"18b: the SDE CLI launches {want}: {line['route_launches']}")
    cfg = parse(argv)
    ds = MDQM9AmbientDataset.load(cfg.traj_path, cfg.sdf_path, cfg.mdqm9_traj_filename,
                                  cfg.sdf_filename, split="test", Ts=[cfg.sampling_T0],
                                  scale=cfg.scale_trajs)
    temps = np.tile(np.array([cfg.sampling_T0, cfg.sampling_T1], np.float32), (len(ds.frames), 1))
    ref = sample_molecular_sde(
        build_ambient_model(cfg, ds.template.n_atoms),
        load_checkpoint(checkpoint_path(os.path.join(root, "models", "smoke"), "smoke", 0)),
        ds.template, ds.frames, temps, torch.Generator(device=DEVICE).manual_seed(cfg.seed),
        g_fn=cfg.sde_g, n_steps=cfg.n_steps, compute_dtype=None, forward_impl="pair_kernel",
        device=DEVICE).cpu().numpy()
    got = np.load(os.path.join(root, "sde", "samples_cli_sde.npy"))
    require(got.shape == (N_FRAMES, 2, N_ATOMS, 3) and np.isfinite(got).all(),
            "18b: finite SDE samples of the expected shape")
    require(np.array_equal(got, ref), "18b: the SDE CLI's samples equal sample_molecular_sde's "
            "to the bit")


def _report(root: str, card: str) -> dict:
    """(c): the ambient CLI's artifacts through results, plots, gEDMD and
    model selection. Returns each step's seconds."""
    from ti_torch.cli import (
        mdqm9_gedmd,
        mdqm9_plots,
        mdqm9_results,
        mdqm9_sample_ambient,
        model_selection,
    )
    from ti_torch.data.mdqm9 import make_synthetic_molecule, scaling_factor_for

    from chip_smoke import ANALYSIS_ARTIFACTS

    secs = {}
    amb = os.path.join(root, "ambient")
    t0 = time.perf_counter()
    line = _cli(mdqm9_sample_ambient.main, [
        "--device", DEVICE, "--preset", "00031:300", "--fast_profile", "--traj_path",
        os.path.join(root, "trajs"), "--sdf_path", root, "--model_save_path",
        os.path.join(root, "models"), "--model_save_name", "smoke", "--model_epoch", "0",
        "--data_save_path", amb, "--data_save_name", "md", "--batch_size", str(CHAINS),
        *_width()])
    secs["sample_ambient"] = time.perf_counter() - t0
    want = {"pair_layer:pair_layer_tf32x3": 2 * MAIN_B1 * LAYERS,
            "pair_tangent:pair_tangent_mma": 2 * MAIN_B3 * LAYERS}
    _card_check(line["route_launches"] == want,
                f"18c: the ambient CLI launches {want}: {line['route_launches']}")

    # the harmonic stand-in energies, in the well's (unscaled) units
    samples = np.load(os.path.join(amb, "samples_md.npy"))
    sf = scaling_factor_for("00031.npy")
    mol = make_synthetic_molecule(N_ATOMS, seed=0)
    p_eq = (mol.positions - mol.positions.mean(axis=0)).astype(np.float32)
    np.save(os.path.join(amb, "E0s_md.npy"), harmonic_energy(samples[:, 0] / sf, 1000.0, p_eq))
    np.save(os.path.join(amb, "E1s_md.npy"), harmonic_energy(samples[:, -1] / sf, 300.0, p_eq))

    res = os.path.join(root, "results")
    t0 = time.perf_counter()
    printed = _cli(mdqm9_results.main, [
        "--sdf", os.path.join(root, "mdqm9.sdf"), "--mol_index", "31", "--tag", "md",
        "--md_ti_dir", amb, "--T0", "1000", "--T1", "300", "--traj_path",
        os.path.join(root, "trajs"), "--out", res, "--device", DEVICE])["stdout"]
    secs["results"] = time.perf_counter() - t0
    names = sorted(f[:-4] for f in os.listdir(res))
    require(names == sorted(ANALYSIS_ARTIFACTS), f"18c: the report's artifacts {names}")
    require(all(np.isfinite(np.load(os.path.join(res, f"{m}.npy"))).all() for m in names),
            "18c: every saved array is finite")
    log(f"[18c results CLI] {samples.shape[0]} transported chains, sample "
        f"{secs['sample_ambient']:.3f} s (launches {line['route_launches']}), report "
        f"{secs['results']:.3f} s ({card}): "
        + " | ".join(printed.splitlines()[:2]))

    figs = os.path.join(root, "figures")
    plot_argv = ["--results_dir", res, "--tag", "md_ti_1", "--ref_tag", "md_T1", "--weights",
                 "weights_md_ti", "--lag", "10", "--out", figs]
    t0 = time.perf_counter()
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        rc = mdqm9_plots.main(plot_argv)
    secs["plots"] = time.perf_counter() - t0
    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False
    if have_mpl:
        pngs = sorted(os.listdir(figs)) if os.path.isdir(figs) else []
        require(rc == 0 and len(pngs) == 4, f"18c: mdqm9_plots renders 4 figures: {pngs}")
        log(f"[18c plots CLI] {pngs} in {secs['plots']:.3f} s")
    else:
        require(rc == 2 and "matplotlib is not available" in err.getvalue(),
                "18c: without matplotlib mdqm9_plots refuses with exit code 2")
        log(f"[18c plots CLI] matplotlib is not installed here: refused with exit code 2 "
            f"({err.getvalue().strip()[:80]}...)")

    t0 = time.perf_counter()
    kin = os.path.join(root, "kinetics")
    _cli(mdqm9_gedmd.main, ["--pattern", os.path.join(res, "torsions_md_ti_1.npy"), "--temps",
                            "300", "--src", "md_ti", "--p", "100", "--n_bootstrap", "100",
                            "--out_dir", kin])
    ev = [np.load(os.path.join(kin, f"md_ti_{k}.npy"))
          for k in ("eigenvalues_mean", "eigenvalues_lower_bound", "eigenvalues_upper_bound")]
    secs["gedmd"] = time.perf_counter() - t0
    require(all(np.isfinite(e).all() for e in ev) and bool(np.all((ev[1] <= ev[0])
                                                                  & (ev[0] <= ev[2]))),
            "18c: mdqm9_gedmd's eigenvalues finite, each interval holding its mean")
    t0 = time.perf_counter()
    scan_path = os.path.join(root, "scan.npz")
    best = _cli(model_selection.main, [
        "--torsions", os.path.join(res, "torsions_md_ti_1.npy"), "--T", "300", "--sigmas", "1.0",
        "5.0", "--ps", "50", "100", "--ntest", "5", "--out", scan_path])["stdout"]
    secs["model_selection"] = time.perf_counter() - t0
    scan = np.load(scan_path)
    require(scan["VAMP"].shape == (2, 2, 5) and np.isfinite(scan["VAMP"]).all(),
            "18c: model_selection's VAMP grid finite")
    log(f"[18c kinetics CLIs] mdqm9_gedmd (p 100, 100 bootstraps, cut from 300 and 1000) "
        f"{secs['gedmd']:.3f} s: lambda {ev[0].ravel()}; model_selection 2 x 2 x 5 "
        f"{secs['model_selection']:.3f} s: {best.splitlines()[0]}")
    return secs


def _adw(root: str, card: str) -> dict:
    """(d): the ADW chain through its three CLIs; no kernel may launch."""
    from ti_torch.cli import adw_reweight_gedmd, adw_sample, adw_train
    from ti_torch.config import ADWConfig
    from ti_torch.data.adw import make_synthetic_adw_csv
    from ti_torch.ops import _build

    d = os.path.join(root, "adw")
    os.makedirs(d)
    cfg = ADWConfig(**ADW)
    t0 = time.perf_counter()
    make_synthetic_adw_csv(os.path.join(d, cfg.traj_filename), betas=cfg.beta0s + cfg.beta1s,
                           n_samples=cfg.n_samples)
    secs = {"data": time.perf_counter() - t0}
    flags = ["--traj_path", d, "--model_save_path", os.path.join(d, "models"),
             "--data_save_path", os.path.join(d, "out"), "--epochs", "2", "--sampling_epoch", "1",
             "--solver_type", "rk4", "--n_step", "64", "--dlogp_quad", "gauss",
             "--dlogp_quad_points", "8",
             *(a for k, v in ADW.items() for a in (f"--{k}", json.dumps(v) if isinstance(v, list)
                                                   else str(v)))]
    _sync()
    _build.reset_launches()
    t0 = time.perf_counter()
    trained = _cli(adw_train.main, ["--device", DEVICE, *flags])
    secs["train"] = time.perf_counter() - t0
    sampled = _cli(adw_sample.main, ["--device", DEVICE, *flags])
    secs["sample"] = sampled["seconds"]
    t0 = time.perf_counter()
    gedmd = _cli(adw_reweight_gedmd.main, [
        "--data_dir", os.path.join(d, "out", cfg.model_save_name), "--epoch", "1", "--betas",
        str(cfg.beta1s[0]), "--n_bootstrap", "50", "--out", os.path.join(d, "gedmd.npz")])
    secs["reweight"] = time.perf_counter() - t0
    _sync()
    routes = _routes()
    spec = np.load(os.path.join(d, "gedmd.npz"))
    log(f"[18d ADW CLIs] {cfg.n_samples} samples a beta ({secs['data']:.2f} s); adw_train 2 "
        f"epochs at {cfg.hidden_size} x {cfg.num_layers}, batch {cfg.batch_size}: "
        f"{secs['train']:.3f} s, losses {trained['train_loss']:.5f} / {trained['val_loss']:.5f}; "
        f"adw_sample {sampled['n']} chains RK4-64 + GL-8 {secs['sample']:.3f} s "
        f"({sampled['n'] / secs['sample']:.0f} samples/s, host clock, {card}), nfe "
        f"{sampled['nfe']}; adw_reweight_gedmd (50 bootstraps) {secs['reweight']:.3f} s: "
        f"{gedmd['stdout'].splitlines()[0]}; kernel launches {routes}")
    require(not routes, f"18d: the ADW chain reaches no kernel, as in ti_tpu: {routes}")
    require(np.isfinite(trained["train_loss"]) and np.isfinite(trained["val_loss"]),
            "18d: finite ADW losses")
    require(all(np.isfinite(spec[k]).all() for k in ("eigenvalues_mean", "lower", "upper")),
            "18d: finite reweighted gEDMD eigenvalues")
    return secs


def reference_state_dict(state, layers: int, conditioning: str = "ambient") -> dict:
    """A ``CPaiNN`` state dict under the reference cPaiNN's names (its
    ``net`` Sequential, ti_torch/utils/torch_import.py's map read backwards):
    what a reference checkpoint of this field would hold."""
    from ti_torch.models.convert import params_to_flax
    from ti_torch.utils.torch_import import _NET_INDEX

    i_edge, i_atom, i_combine, i_painn = _NET_INDEX[conditioning]
    p = params_to_flax(state)["params"]
    sd = {}

    def put(name, arr):
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr))

    def mlp(prefix, tree):
        for leaf, idx in (("Dense_0", 0), ("Dense_1", 3), ("Dense_2", 6)):
            put(f"{prefix}.mlp.{idx}.weight", tree[leaf]["kernel"].T)
            put(f"{prefix}.mlp.{idx}.bias", tree[leaf]["bias"])
        for leaf, idx in (("LayerNorm_0", 1), ("LayerNorm_1", 4)):
            put(f"{prefix}.mlp.{idx}.weight", tree[leaf]["scale"])
            put(f"{prefix}.mlp.{idx}.bias", tree[leaf]["bias"])

    put(f"net.{i_edge}.embedding.weight", p["edge_embed"]["embedding"])
    put(f"net.{i_atom}.embedding.weight", p["atom_embed"]["embedding"])
    mlp(f"net.{i_combine}.mlp", p["combine"])
    base = f"net.{i_painn}.layers"
    for layer in range(layers):
        mlp(f"{base}.{2 * layer}.phi", p[f"message_{layer}"]["phi"])
        mlp(f"{base}.{2 * layer}.w", p[f"message_{layer}"]["w"])
        upd = p[f"update_{layer}"]
        put(f"{base}.{2 * layer + 1}.u.linear.weight", upd["u"]["kernel"].T)
        put(f"{base}.{2 * layer + 1}.v.linear.weight", upd["v"]["kernel"].T)
        mlp(f"{base}.{2 * layer + 1}.mlp", upd["mlp"])
    mlp(f"{base}.{2 * layers}.mlp", p["readout"]["mlp"])
    put(f"{base}.{2 * layers}.V.linear.weight", p["readout"]["V"]["kernel"].T)
    return sd


def _import(root: str, model, template, card: str) -> None:
    """(e): a reference-layout checkpoint of the smoke's field through
    torch_import, B1 and the main path."""
    from ti_torch.config import ambient_preset, fast_profile
    from ti_torch.ops.pair_layer_kernel import pair_kernel_drift
    from ti_torch.sampling.drivers import sample_ambient
    from ti_torch.utils.torch_import import cpainn_state_from_torch

    from chip_smoke import zero_com_x0

    path = os.path.join(root, "reference_cpainn.pt")
    own = {k: t.detach().cpu() for k, t in model.state_dict().items()}
    torch.save(reference_state_dict(own, LAYERS), path)
    t0 = time.perf_counter()
    state = cpainn_state_from_torch(path, LAYERS, "ambient", device=DEVICE)
    t_load = time.perf_counter() - t0
    require(state.keys() == own.keys() and all(torch.equal(state[k].cpu(), own[k]) for k in own),
            "18e: the imported state is the field it was written from")
    require(all(t.device.type == DEVICE for t in state.values()),
            f"18e: cpainn_state_from_torch puts the state on {DEVICE}")

    rng = np.random.default_rng(18)
    x = torch.from_numpy(zero_com_x0(rng, CHAINS, N_ATOMS)).to(DEVICE)
    temps = torch.tensor([[1000.0, 300.0]] * CHAINS, device=DEVICE)
    drift = pair_kernel_drift(model, state, template, device=DEVICE)
    from ti_torch.ops import _build

    _sync()
    _build.reset_launches()
    with torch.no_grad():
        v = drift(x, 0.5, temps)
    _sync()
    routes = _routes()
    _card_check(routes == {("pair_layer", "pair_layer_tf32x3"): LAYERS},
                f"18e: one forward on the imported state launches {LAYERS} B1: {routes}")
    cmp = min(16, CHAINS)  # chains held against the CPU's plain forward (each on its own)
    plain = pair_kernel_drift(model, {k: t.cpu() for k, t in state.items()}, template,
                              device="cpu")
    with torch.no_grad():
        ref = plain(x[:cmp].cpu(), 0.5, temps[:cmp].cpu())
    err = float((v[:cmp].cpu() - ref).abs().max() / ref.abs().max())
    require(bool(torch.isfinite(v).all()) and err <= BAR[torch.float32],
            f"18e: the imported field's velocity on {DEVICE} within {BAR[torch.float32]:g} of "
            f"max |plain| of the CPU's plain forward: {err:.3e}")

    cfg = fast_profile(ambient_preset("00031", **PRESET))
    x0 = zero_com_x0(rng, CHAINS, N_ATOMS)
    _build.reset_launches()
    imported = sample_ambient(cfg, model, state, template, x0, save=False, batch_size=CHAINS,
                              device=DEVICE)
    routes = _routes()
    field = sample_ambient(cfg, model, None, template, x0, save=False, batch_size=CHAINS,
                           device=DEVICE)
    same = (np.array_equal(imported["samples"], field["samples"])
            and np.array_equal(imported["dlogps"], field["dlogps"]))
    log(f"[18e checkpoint import] reference-layout state dict ({len(own)} "
        f"tensors) -> cpainn_state_from_torch on {DEVICE} in {t_load:.3f} s; one B1 forward at "
        f"{CHAINS} chains against the CPU's plain forward on {cmp}: max err / max |plain| "
        f"{err:.3e} (bar {BAR[torch.float32]:g}); main-path batch on it: launches "
        f"{by_lib(routes)}, equal to the field's to the bit: {same} ({card})")
    _card_check(routes == {("pair_layer", "pair_layer_tf32x3"): MAIN_B1 * LAYERS,
                           ("pair_tangent", "pair_tangent_mma"): MAIN_B3 * LAYERS},
                f"18e: the main path on the imported state launches its B1 and B3: {routes}")
    require(same, "18e: the main path on the imported state equals it on the field, to the bit")


def _trace(root: str, model, template, card: str) -> dict:
    """(f): profile_trace around one main-path batch, read back."""
    from ti_torch.cli import profile_summary
    from ti_torch.config import ambient_preset, fast_profile
    from ti_torch.sampling.drivers import sample_ambient
    from ti_torch.utils import profiling
    from ti_torch.utils.logging import profile_trace

    from chip_smoke import zero_com_x0

    cfg = fast_profile(ambient_preset("00031", **PRESET))
    x0 = zero_com_x0(np.random.default_rng(19), CHAINS, N_ATOMS)
    logdir = os.path.join(root, "trace")
    with profile_trace(logdir, device=DEVICE):
        t0 = time.perf_counter()
        sample_ambient(cfg, model, None, template, x0, save=False, batch_size=CHAINS,
                       device=DEVICE)
        _sync()
        wall = time.perf_counter() - t0
    trace_file = profiling.find_trace_file(logdir)
    trace = profiling.load_trace(trace_file)
    lanes = profiling.summarize_lanes(trace)
    dev = [lane for lane in lanes if lane.process.endswith("[cuda]")]
    counts = {name: sum(o.count for lane in dev for o in lane.ops if name in o.name)
              for name in ("pair_layer_tf32x3", "pair_tangent_mma")}
    busy = sum(lane.busy_us for lane in dev) / 1e3
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        profile_summary.main([logdir, "--lane", "cuda", "--top", "10"])
    log(f"[18f trace] profile_trace around one main-path batch of {CHAINS} chains: {wall:.3f} s "
        f"of host clock under the profiler ({card}); trace "
        f"{os.path.getsize(trace_file) / 2**20:.1f} MiB, {len(lanes)} lanes, {len(dev)} on the "
        f"card; B1 and B3 calls on the card's lanes "
        f"{counts}; device busy {busy:.3f} ms = {busy / (1e3 * wall):.1%} of the batch's wall "
        f"clock\n" + text.getvalue().rstrip())
    _card_check(bool(dev), "18f: the trace holds the card's lanes (torch.profiler's CUDA "
                "activity, CUPTI); a CPU-only trace fails")
    _card_check(counts == {"pair_layer_tf32x3": MAIN_B1 * LAYERS,
                           "pair_tangent_mma": MAIN_B3 * LAYERS},
                f"18f: the card's lanes hold B1 {MAIN_B1 * LAYERS} and B3 {MAIN_B3 * LAYERS} "
                f"times: {counts}")
    return {"wall": wall, "busy_ms": busy}


def _timing(model, card: str) -> None:
    """(g): device_time of one B1 f32 launch against chip_smoke.cuda_ms."""
    from ti_torch.ops.pair_layer_kernel import pair_layer
    from ti_torch.utils.timing import device_time, host_round_trip_latency

    from chip_smoke import LENGTH_SCALE, layer_inputs

    params = {k: t.detach() for k, t in model.state_dict().items()}
    w, base, _ = layer_inputs(params, torch.float32, 0, seed=1)
    dt = 1e3 * device_time(lambda i: pair_layer(*base, w, LENGTH_SCALE), reps=20)
    ev = cuda_ms(lambda: pair_layer(*base, w, LENGTH_SCALE), 20)
    lat = 1e3 * host_round_trip_latency()
    log(f"[18g timing] B1 f32 at {CHAINS} chains: device_time {dt:.4f} ms (best of 3 x 20, CUDA "
        f"events) against cuda_ms {ev:.4f} ms (mean of 20), ratio {dt / ev:.3f}; a synchronise "
        f"round trip {lat:.4f} ms ({card})")
    require(abs(dt - ev) <= 0.2 * ev, "18g: device_time within 20% of cuda_ms")


def phase_cli(model, template, card: str) -> dict:
    """18. The CLIs, the checkpoint import, the trace and the timer; returns
    each step's seconds."""
    from ti_torch.data.mdqm9 import write_synthetic_workspace
    from ti_torch.train.common import checkpoint_path, save_checkpoint

    t_phase = time.perf_counter()
    secs = {}
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_workspace(root, N_ATOMS, N_FRAMES, jitter=WELL_JITTER)
        os.makedirs(os.path.join(root, "models", "smoke"))
        save_checkpoint(checkpoint_path(os.path.join(root, "models", "smoke"), "smoke", 0),
                        {k: t.detach().cpu() for k, t in model.state_dict().items()})
        for step, fn in (("a", lambda: _latent_chain(root, card)),
                         ("b", lambda: _sde(root, card)),
                         ("c", lambda: _report(root, card)),
                         ("d", lambda: _adw(root, card)),
                         ("e", lambda: _import(root, model, template, card)),
                         ("f", lambda: _trace(root, model, template, card))):
            t0 = time.perf_counter()
            fn()
            _sync()
            secs[step] = time.perf_counter() - t0
    if DEVICE == "cuda":
        t0 = time.perf_counter()
        _timing(model, card)
        secs["g"] = time.perf_counter() - t0
    else:
        log("[18 rehearsal] skipped on the CPU: (g) device_time against cuda_ms")
    secs["phase"] = time.perf_counter() - t_phase
    log("[18 CLIs] " + ", ".join(f"({k}) {v:.3f} s" for k, v in secs.items()) + f" ({card})")
    return secs
