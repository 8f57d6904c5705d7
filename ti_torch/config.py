"""Typed configuration with JSON/CLI overrides and named preset grids.

A copy of ti_tpu/config.py (numpy-free, JAX-free; only the log prefix
differs) so the PyTorch port reads the same settings files and presets
without importing ti_tpu.

Replaces the reference's untyped JSON→argparse bridge (adw/thermo/
utils.py:54-67, mdqm9/thermo/utils.py:31-47 — where every key becomes a CLI
flag with its type inferred from the JSON value and bools are 0/1 ints)
with real dataclasses. JSON files and --key value overrides still work;
``clone_config`` keeps the reference's provenance-snapshot habit
(mdqm9/thermo/utils.py:50-64). The leave-one-temperature-out experiment
grid (14 ambient configs, §2 item 36) is generated programmatically by
``ambient_preset``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence


def _apply_overrides(cfg, overrides):
    for k, v in overrides.items():
        if not hasattr(cfg, k):
            raise KeyError(f"unknown config key {k!r} for {type(cfg).__name__}")
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            v = bool(int(v)) if not isinstance(v, bool) else v
        elif cur is not None and not isinstance(v, type(cur)) and not isinstance(cur, (list, tuple)):
            v = type(cur)(v)
        setattr(cfg, k, v)
    return cfg


@dataclasses.dataclass
class ADWConfig:
    """ADW experiment (reference adw/config/settings.json)."""

    seed: int = 0
    n_samples: int = 300_000
    hidden_size: int = 256
    num_layers: int = 5
    # "f32" (default) or "f64": the reference trains ADW in float64
    # (adw/train.py:29). f64 enables jax_enable_x64 and is a CPU-only
    # parity mode — TPUs have no native f64 (the trained-field f64-vs-f32
    # comparison is recorded in BASELINE.md; f32 physics passes the same
    # quadrature-ΔF oracle, so f32 stays the TPU default)
    dtype: str = "f32"
    lr: float = 1e-4
    wd: float = 1e-5
    batch_size: int = 512
    epochs: int = 300
    a: float = 0.9  # brownian gamma parameter
    gamma: str = "brownian"
    beta0s: List[float] = dataclasses.field(default_factory=lambda: [1.0])
    beta1s: List[float] = dataclasses.field(default_factory=lambda: [1.25])
    traj_path: str = "data/adw"
    traj_filename: str = "samples.csv"
    model_save_path: str = "trained_models/adw"
    model_save_name: str = "velocity"
    data_save_path: str = "model_outputs/adw"
    # sampling
    sampling_epoch: int = -1  # -1 = latest
    return_dlogp: bool = True
    atol: float = 1e-4
    rtol: float = 1e-4
    n_step: int = 400
    solver_type: str = "dopri5"  # or euler/heun/rk4
    divergence: str = "exact"
    num_probes: int = 8  # stochastic-divergence probe/query count (hutchinson/hutchpp)
    probe_mode: str = "rademacher"  # or "orthogonal": Haar probe frame, exact at K=dim (ops/divergence.py)
    probe_crn: bool = False  # share probes across chains (good for ESS/marginals, biases absolute dF — BASELINE.md)
    steps_per_dispatch: int = 0  # 0 = whole rollout in one device dispatch
    dlogp_quad_points: int = 0  # 0 = stage-coupled dlogp; K = quadrature nodes
    dlogp_quad: str = "simpson"  # or "gauss" (Gauss-Legendre, nodes/save interval)
    shard: int = 0  # multi-host fan-out (parallel/fanout.py)
    num_shards: int = 1
    use_wandb: bool = False
    project_name: str = "adw-ti-tpu"


@dataclasses.dataclass
class MDQM9Config:
    """MDQM9 ambient/latent experiments (reference mdqm9/config/*)."""

    seed: int = 0
    dataset: str = "mdqm9"
    mdqm9_traj_filename: str = "00031.npy"
    sdf_filename: str = "mdqm9.sdf"
    traj_path: str = "data/mols/rotated_replica_exchange_trajs"
    sdf_path: str = "data/mols"
    # interpolant / loss
    a: float = 1.0
    gamma: str = "sin2"
    t_distr: str = "uniform"
    # remat the two loss forwards (extra FLOPs for activation memory;
    # measured 1.29x slower at batch 256 and does NOT fix the batch-1024
    # compile failure — prefer grad_accum; kept as an option)
    loss_remat: int = 0
    # gradient-accumulation microbatches per optimizer step: the
    # batch-scale mechanism (batch = grad_accum x microbatch; flat
    # per-molecule cost measured to batch 4096 — BASELINE.md)
    grad_accum: int = 1
    # training forward implementation: "edge" (per-molecule vmapped
    # gather/scatter, reference-shaped) or "dense" (the sampling hot
    # path's batched (N x N) pair formulation, cpainn_dense.apply_dense)
    train_impl: str = "edge"
    # training compute dtype (dense impl only): f32 / bf16 / bf16_agg —
    # the same mixed-precision profiles as the sampling path
    train_compute_dtype: str = "f32"
    # model
    # radius-graph cutoff (reference mdqm9/thermo/utils.py:112-125). All 17
    # reference configs use 1000.0 ⇒ the complete graph; values >= 1000 keep
    # the static complete-graph fast path, finite values mask non-bonded
    # edges with dist > cutoff per evaluation (CPaiNN.cutoff)
    cutoff: float = 1000.0
    temp_length: float = 100.0
    n_features: int = 128
    score_layers: int = 5
    # optimization
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    batch_size: int = 12
    n_epochs: int = 150
    scale_trajs: bool = True
    use_pretrained: bool = False
    model_epoch: str = ""
    # temperatures
    T0s: List[int] = dataclasses.field(default_factory=lambda: list(range(400, 1001, 100)))
    T1s: List[int] = dataclasses.field(default_factory=lambda: list(range(400, 1001, 100)))
    T: List[int] = dataclasses.field(default_factory=lambda: list(range(300, 1001, 100)))
    sampling_T0: int = 1000
    sampling_T1: int = 300
    sampling_T: int = 300
    align: bool = True
    # sampling
    return_dlogp: bool = True
    atol: float = 1e-5
    rtol: float = 1e-5
    n_steps: int = 100
    solver_type: str = "dopri5"
    divergence: str = "exact"
    num_probes: int = 8  # stochastic-divergence probe/query count (hutchinson/hutchpp)
    probe_mode: str = "rademacher"  # or "orthogonal": Haar probe frame, exact at K=dim (ops/divergence.py)
    probe_crn: bool = False  # share probes across chains (good for ESS/marginals, biases absolute dF — BASELINE.md)
    # record the probe-noise variance of the hutchinson dlogp (gauss path
    # only) into dlogp_vars_* artifacts: exp(-phi) consumers debias the
    # ~var/2 offset in -log E[w] with phi += var/2
    # (analysis.free_energy.debias_phis; BASELINE.md 10506 probe rows)
    return_dlogp_var: bool = False
    compute_dtype: str = "f32"  # or "bf16": mixed-precision sampling path
    steps_per_dispatch: int = 0  # 0 = whole rollout in one device dispatch
    dlogp_quad_points: int = 0  # 0 = stage-coupled dlogp; K = quadrature nodes
    dlogp_quad: str = "simpson"  # or "gauss" (Gauss-Legendre, nodes/save interval)
    # trajectory-segment drift of the segmented gauss quadrature-dlogp
    # path: "default" = vmap(v_fn); "pair_kernel" / "pair_kernel_bf16" =
    # the fused pair-layer Pallas kernel (f32 / bf16-VMEM profile) drives
    # the velocity-only trajectory while the divergence nodes keep the
    # differentiable XLA forward (drivers._traj_drift_of)
    traj_forward_impl: str = "default"
    # divergence-node estimator impl of the same gauss path: "default" =
    # jax.linearize of the XLA forward + vmapped probe lanes;
    # "pair_tangent" / "pair_tangent_bf16" = the pair-tangent Pallas kernel
    # (f32 / bf16-VMEM profile) carries the probe lanes through the message
    # layers in VMEM (drivers._div_drift_of; ops/pair_tangent_kernel.py)
    div_forward_impl: str = "default"
    # SDE (Euler–Maruyama, no dlogp) surface — scripts/mdqm9_sample_sde.py:
    # noise scale (g <= 0.1 holds the ODE route's marginal KS floor on the
    # trained oracle, BASELINE.md SDE rows) and drift implementation
    # ("dense" | "pair_kernel" = the fused pair-layer Pallas kernel)
    sde_g: float = 0.1
    sde_forward_impl: str = "dense"
    shard: int = 0  # multi-host fan-out (parallel/fanout.py)
    num_shards: int = 1
    n_latent_samples: int = 10_000
    latent_traj_path: str = ""
    # io
    model_save_path: str = "trained_models/mdqm9"
    model_save_name: str = "00031_no_300"
    data_save_path: str = "generated_data/ambient"
    data_save_name: str = "00031_no_300_1000to300K"
    use_wandb: bool = False
    project_name: str = "mdqm9-ti-tpu"


# Verbatim reference-config compatibility (MIGRATION.md): keys a reference
# JSON may carry that have no field here. Aliases are remapped; dead keys
# (present in the reference configs but never read by any reference script,
# or with no analog in this framework) are accepted with a warning so a
# reference user's existing files load unchanged. CLI/keyword overrides
# stay strict — a typo there should fail loudly.
_KEY_ALIASES = {
    # reference latent configs call the sampling count n_samples
    # (mdqm9/sample_latent.py:19); ADWConfig has its own distinct n_samples
    "MDQM9Config": {"n_samples": "n_latent_samples"},
}
_IGNORED_REFERENCE_KEYS = {
    "ADWConfig": {
        "beta_trains",  # never read by any reference script
        "sampling_model",  # pickled-module path; use model_save_path + sampling_epoch
    },
    "MDQM9Config": {
        "train_size",  # in every mdqm9 JSON, never read (data pre-split on disk)
        "num_workers",  # torch DataLoader workers; host ingest here is eager
    },
}


def load_config(path: str, cls=None, **overrides):
    """Load a JSON config into a typed dataclass (+keyword overrides).

    Reference-layout JSONs load verbatim: known dead reference keys are
    skipped with a warning and reference key aliases are remapped
    (_IGNORED_REFERENCE_KEYS / _KEY_ALIASES); unknown keys still raise."""
    import sys

    with open(path) as f:
        data = json.load(f)
    kind = data.pop("_kind", None)
    if cls is None:
        cls = {"adw": ADWConfig, "mdqm9": MDQM9Config}.get(kind or "", MDQM9Config)
    for src, dst in _KEY_ALIASES.get(cls.__name__, {}).items():
        if src in data:
            data[dst] = data.pop(src)
    for k in _IGNORED_REFERENCE_KEYS.get(cls.__name__, frozenset()) & set(data):
        print(
            f"[ti_torch.config] ignoring reference-only key {k!r} = "
            f"{data.pop(k)!r} ({path})",
            file=sys.stderr,
        )
    cfg = cls()
    _apply_overrides(cfg, data)
    _apply_overrides(cfg, overrides)
    return cfg


def clone_config(cfg, save_path: str, name: str) -> str:
    """Snapshot the exact settings next to the model weights
    (reference clone_config, mdqm9/thermo/utils.py:50-64)."""
    out_dir = os.path.join(save_path, name)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "settings.json")
    payload = dataclasses.asdict(cfg)
    payload["_kind"] = "adw" if isinstance(cfg, ADWConfig) else "mdqm9"
    with open(out, "w") as f:
        json.dump(payload, f, indent=4)
    return out


def ambient_preset(
    mol: str = "00031", leave_out: Optional[int] = 300, **overrides
) -> MDQM9Config:
    """The leave-one-temperature-out grid: train on all temps except
    ``leave_out``, sample 1000K -> leave_out (reference
    mdqm9/config/ambient/{mol}_settings_no_{T}.json)."""
    temps = [t for t in TEMP_GRID if t != leave_out]
    cfg = MDQM9Config(
        mdqm9_traj_filename=f"{mol}.npy",
        n_features=128 if mol == "00031" else 256,
        T0s=temps,
        T1s=temps,
        sampling_T0=1000,
        sampling_T1=leave_out if leave_out is not None else 300,
        model_save_name=f"{mol}_no_{leave_out}",
        data_save_name=f"{mol}_no_{leave_out}_1000to{leave_out}K",
    )
    return _apply_overrides(cfg, overrides)


def latent_preset(mol: str = "00031", Ts: Optional[Sequence[int]] = None, **overrides) -> MDQM9Config:
    """Latent (Boltzmann-generator) presets (reference
    mdqm9/config/latent/*.json): all temperatures or a single one.

    Constants from the reference latent grid: temp_length=75 (vs the
    ambient stack's 100), n_samples=25000, n_steps=400; batch_size is 10
    in 00031_latent_allTs_settings.json and 256 in the other two files.
    align: the JSONs say "0", but the reference's type-inferred loader
    keeps it a STRING and ``if self.align:`` (mdqm9/data/
    mdqm9_latent.py:103) treats "0" as truthy — Kabsch alignment was
    effectively always ON in the reference runs, so align=True here IS
    the behavioral parity setting."""
    Ts = list(Ts) if Ts is not None else list(TEMP_GRID)
    all_ts = len(Ts) > 1
    cfg = MDQM9Config(
        mdqm9_traj_filename=f"{mol}.npy",
        n_features=128 if mol == "00031" else 256,
        T=Ts,
        n_steps=400,
        temp_length=75.0,
        n_latent_samples=25_000,
        batch_size=10 if (all_ts and mol == "00031") else 256,
        model_save_name=f"{mol}_latent_{'allTs' if all_ts else str(Ts[0]) + 'K'}",
        data_save_path="generated_data/latent",
    )
    return _apply_overrides(cfg, overrides)


def fast_profile(cfg: MDQM9Config, family: str = "ambient", **overrides) -> MDQM9Config:
    """Apply the physics-qualified THROUGHPUT profile to a sampling config.

    The parity default stays f32 + exact divergence (the reference's
    estimator); this helper switches the knobs of the benchmarked fast
    path in one call, applying ONLY settings with qualification evidence
    for the given experiment ``family`` (BASELINE.md):

    - ``family="ambient"`` (T0->T1 transport): RK4-8/16 + Gauss-Legendre-8
      decoupled dlogp, bf16_agg mixed precision, Hutchinson divergence
      with the SCALE-QUALIFIED probe count (probe-study rows: 16 probes at
      00031 capacity where 16/24/32 all sit at the exact-divergence floor;
      32 at 10506 capacity where fewer probes cost ESS and 8 collapses
      it), bounded dispatches. Scale inferred from ``n_features``
      (>=256 = 10506 capacity).
    - ``family="latent"`` (noise->data BG): RK4-64 (the step count the
      latent partition-identity oracle qualified,
      scripts/validate_latent_physics.py) + GL-8 dlogp, bf16 (the profile
      the production BG->TI CLI chain ran end-to-end; round 5: qualified
      at 10506 capacity too — bf16 matches f32 on the trained
      29-atom/F=256 generator, |err| 0.355 vs 0.365 / ESS 49.6 vs 49.8%,
      BASELINE.md latent-10506 row), bounded dispatches; the divergence
      estimator is left at the config's value — the Hutchinson probe
      ladder is ambient-qualified only.

    Explicit ``**overrides`` win over the profile.
    """
    if not isinstance(cfg, MDQM9Config):
        raise TypeError(
            "fast_profile applies to MDQM9Config sampling configs; the ADW "
            "experiment's qualified fast path is RK4-64 + GL-8 exact dlogp "
            "(set solver_type/n_step/dlogp_quad* directly)"
        )
    if family == "ambient":
        large = cfg.n_features >= 256
        prof = dict(
            solver_type="rk4",
            n_steps=16 if large else 8,
            dlogp_quad="gauss",
            dlogp_quad_points=8,
            divergence="hutchinson",
            num_probes=32 if large else 16,
            # round-3 probe-mode study (BASELINE.md): at 00031 scale (d=57)
            # orthogonal-16 holds the exact-divergence ESS floor on both
            # seeds and the Haar-frame QR is measured free; at 10506 scale
            # (d=87) orthogonal shows no benefit — rademacher stays
            probe_mode="rademacher" if large else "orthogonal",
            compute_dtype="bf16_agg",
            steps_per_dispatch=25,
            # round-4: the fused pair-layer kernel drives the velocity-only
            # trajectory segments (divergence nodes keep the XLA forward).
            # Qualified at 00031 capacity (dF err 0.044 / ESS 21.8% ==
            # the default trajectory's 0.037 / 21.8% on the trained oracle,
            # BASELINE.md round-4 row). At 10506 capacity the f32 kernel
            # sits at the VMEM ceiling; the bf16-VMEM variant is the
            # round-5-QUALIFIED choice there (dF err 0.347 / ESS 9.8% vs
            # the field's exact floor 0.397 / 10.5% on the trained
            # 29-atom/F=256 oracle — BASELINE.md round-5 10506 rows).
            traj_forward_impl="pair_kernel_bf16" if large else "pair_kernel",
            # round-5: the pair-TANGENT kernel drives the divergence nodes
            # at 00031 capacity (probe lanes in VMEM, lane-blocked) —
            # physics-qualified on the trained oracle (dF err 0.130 / ESS
            # 17.1% at the bench combo; the kernel's full orthogonal frame
            # reproduces the exact floor to 3 digits — BASELINE.md round-5
            # 00031 rows) at 1.70x the default divergence path. At 10506
            # capacity it stays default pending the divk_10506 measurement
            # + qualification.
            div_forward_impl="default" if large else "pair_tangent_bf16",
        )
    elif family == "latent":
        prof = dict(
            solver_type="rk4",
            n_steps=64,
            dlogp_quad="gauss",
            # round-5 10506-capacity finding: the BG dlogp integrand is
            # steep near the noise end and GL-8 TRUNCATES at 29-atom
            # capacity (-log Z err 0.31 at GL-8 even with EXACT
            # divergence; 0.019 at GL-16 — BASELINE.md latent rows).
            # GL-8 stays qualified at small capacity.
            dlogp_quad_points=16 if cfg.n_features >= 256 else 8,
            compute_dtype="bf16",
            steps_per_dispatch=25,
        )
    else:
        raise ValueError(f"unknown family {family!r} (ambient/latent)")
    prof.update(overrides)
    return _apply_overrides(cfg, prof)


TEMP_GRID = tuple(range(300, 1001, 100))
