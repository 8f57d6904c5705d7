"""Chip smoke test of the PyTorch port (ti_torch) on one NVIDIA H100.

Builds the hand-written CUDA kernels from ti_torch/csrc, holds each against
its plain PyTorch version at its path's shapes, and runs the port's five
paths and its trainer at the 00031 width (19 atoms, F = 128, 5 message
layers), and the 10506 profile at its width (29 atoms, F = 256), through
their entry points, checking what comes out and showing,
with the launch counts set to 0 just before each path and read just after,
that the path went through its kernels:

- MDQM9 ambient transport with dlogp at 128 chains (``sample_ambient``):
  with the exact divergence in f32 (``div_forward_impl="pair_tangent"``:
  kernels B1 and B3 in f32), under ``fast_profile`` (B1 in f32, B3 in
  bf16_agg), and with the bf16_agg trajectory
  (``traj_forward_impl="pair_kernel_bf16"``: B1 and B3 in bf16_agg);
- the SDE at 8192 chains (``sample_molecular_sde``, pair-kernel drift,
  ``chain_block=4``: kernel B2), in bf16_agg and in f32;
- the fused-MLP path: ``fused_velocity_fn`` at 128 chains (B4, B6) and the
  exact-dlogp sampler through ``molecular_v_fn_of(impl="dense_fused")``
  at 32 chains (B4, B5), B4, B5 and B6 on the tensor cores;
- the whole-network exact divergence ``divergence_kernel_batch`` at 128
  chains (B7, on the tensor cores);
- the reference's own sampler (``sample_ambient(ambient_preset("00031"))``:
  dopri5 with the exact divergence in every stage), the edge-form Euler
  sampler that bench.py prices, and stage-coupled RK4 through B4 and B5;
- ambient training (``train_ambient``, plain PyTorch under autograd: no
  kernel has a backward), and a field it trained on the card through the
  main path's kernels B1 and B3;
- the latent family: ``sample_latent`` on the latent kernel route (B1 and
  B3 in f32) and on the published latent profile, ``train_latent``, the
  BG→TI composition into ``sample_ambient``, and the Simpson and
  unsegmented Gauss quadrature samplers;
- the ADW family at its published width (``FCNetMultiBeta`` 5 x 256, batch
  512, 300k samples): ``train_adw`` in f32 (and its update in f64),
  ``sample_adw`` of the 30,000-chain test split and the reweighted gEDMD
  spectrum (plain PyTorch: no kernel is on that path);
- the large molecule's fast profile at its width (10506: 29 atoms, F =
  256, 5 layers): ``sample_ambient`` and the SDE through kernel B1 in
  bf16_agg at F = 256;
- the analysis layer over the main path's transported samples: z-matrix
  marginals on the card, the paper's multi-source results report and the
  torsion-space gEDMD kinetics;
- the parallel layer (chip_smoke_parallel.py): the main path chain-sharded
  on NCCL, the lane-sharded divergence, data-parallel training and the
  sampling fan-out CLI;
- the user CLIs (chip_smoke_cli.py): the latent train and sample chain and
  the SDE through B1 and B3, the results, figures, kinetics and ADW CLIs, a
  reference checkpoint through ``torch_import``, a ``profile_trace`` of the
  main path and ``device_time``;
- the study CLIs (chip_smoke_studies.py): the SDE and 10506 scans through
  B1 and B2 (and B3 at F = 256 at the scan's nodes), the divergence profile
  through B4, B5 and B6, the probe-mode, step-count and f32-against-f64
  studies and the ADW figure;
- B1 and B2 in f32 at F = 256 (chip_smoke_validate.py): the 10506 profile's
  f32 trajectory and the f32 SDE at its width, and the three
  physics-validation CLIs against their closed forms;
- B3 at F = 256 in both types (chip_smoke_b3_f256.py): against its plain
  version, timed, and the 10506 profile's divergence nodes through it;
- B1/B2 and B3 at F = 64 in both types (chip_smoke_f64.py): against their
  plain versions, timed, and ``validate_mdqm9_physics`` on its kernel routes
  at its own default width, and the SDE through B2 at that width.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. the card, TF32 off, the kernel build (seconds, ``-Xptxas -v``; the
     tensor-core kernels must build without register spills);
  2. kernel B1 (pair layer) against its plain version, each type on the
     tensor cores (``variant="tc"``: 3xTF32 for f32, ``mma.sync`` bf16 for
     bf16_agg) at 128 chains and at ragged shapes (130 chains at 19 and 29
     atoms), timed in turns beside the f32-FMA kernel (``variant="fma"``),
     with bounds and the tensor-core kernels' registers and spills;
  3. kernel B3 (pair tangent): bf16_agg K = 16 on the tensor cores
     (``mma.sync`` bf16) against its plain version, timed, and a ragged
     shape (130 chains, K = 8, L = 2); f32 K = 57 at 128 chains on the
     tensor cores (3xTF32, ``pair_tangent_tf32x3``) against its plain version,
     two launches to the bit, timed in turns beside the f32-FMA kernel
     (``variant="fma"``) with both bounds and its registers, and ragged
     shapes (130 chains; K = 16 and 5, partial last tiles; N = 29 and 32,
     2 lanes a tile);
  4. the exact slice (full orthogonal frame, B3 in f32) against the same
     sampler built from the plain versions: samples rtol 1e-4 / atol 1e-5,
     dlogp rtol 1e-3 (atol 1e-3 x max |dlogp| for chains near 0); its launch
     counts (every B1 launch from pair_layer_tf32x3, every B3 launch from
     pair_tangent_tf32x3), seconds and samples/s;
  5. the slice as users run it (``fast_profile``), artifacts written to a
     temporary directory, launch counts (counted per library: every B1
     launch from pair_layer_tf32x3, every B3 launch from pair_tangent_mma)
     and samples/s; its trajectory against the exact slice's, to the bit;
     the dlogp of B3 in bf16_agg with the full orthogonal frame (K = 57)
     against the exact slice's; then one divergence node of that path
     (``pair_tangent_div_fn``, 128 chains, K = 16, bf16_agg) timed beside its
     5 B3 launches: the rest is plain glue; one trajectory forward in f32
     and in bf16_agg, in turns: the host's time to enqueue it beside its
     time synchronised, and the aten ops of its glue; and the slice with the
     bf16_agg trajectory (every B1 launch from pair_layer_mma), its
     samples/s beside the headline's and its dlogp against the exact
     slice's;
  6. kernel B2 (chain-blocked pair layer) against its plain version and
     against B1 at 130 chains, C = 2, 3, 4, 5 and 8: f32 (on B1's 3xTF32
     kernel, pair_layer_tf32x3.cu) and bf16_agg (pair_layer_mma.cu) within
     the bar and equal to B1 to the bit, and ``variant="fma"``
     (pair_layer.cu, C chains a CTA) at C = 2, 3 and 4 within the bar; at
     8192 chains bf16_agg C = 4 and its ``variant="fma"`` (timed below)
     against its plain version and every C against B1 to the bit; its time
     there for C = 1, 2, 3 and 4 in turns beside ``variant="fma"`` at C = 4,
     with the bound and the weight bytes each launch streams; B2 in f32 at
     8192 chains, C = 4, and its ``variant="fma"`` against its plain
     version and every C against B1 to the bit, timed in turns beside ``variant="fma"`` (pair_layer.cu, f32
     FMA, 4 chains a CTA) with both bounds;
  7. the SDE: at 256 chains in f32 (C = 2) against the same SDE built from
     the plain version on the same noise; then at 8192 chains, bf16_agg,
     C = 4, 20 steps (``bench.py`` takes 100), with B2's launch count (all
     from pair_layer_mma), samples/s and the centre-of-mass checks; then the
     same in f32 (all 100 B2 launches from pair_layer_tf32x3), its
     samples/s;
  8. kernels B4, B5 and B6 against their plain versions at full width, with
     their times and bounds; B4 on the tensor cores (3xTF32,
     ``fused_edge_mlp_tf32x3``) at every path's row count (46,208, 43,776
     and 11,552) and at ragged ones (R = 1, 5, 63, 64, 65, 1,007 and 4,097),
     two launches to the bit, against the f32-FMA kernel
     (``variant="fma"``) and timed in turns beside it at each path's row
     count with both bounds, its registers and CTAs an SM; B5 at K = 57,
     R = 11,552 on the tensor cores
     (3xTF32, ``fused_edge_mlp_jvp_tf32x3``) against its plain version and
     the f32-FMA kernel (``variant="fma"``), two launches to the bit, timed
     in turns beside it with both bounds and its registers, and ragged
     shapes (R = 5, 65 and 4,097; K = 1, 3 and 87); B6 on the tensor cores
     (3xTF32, ``fused_mlp_tf32x3``, 16-row tiles) at the combine (4F -> F),
     latent combine (3F -> F), update (2F -> 3F) and readout (F -> 2)
     widths, at the 2432 node rows of 128 chains and at R = 1, 5, 15, 16,
     17, 63, 64, 65 and 4,097, two launches to the bit, against the f32-FMA
     kernel (``variant="fma"``) and timed in turns beside it at 2432 rows
     with both bounds, back to back as every kernel (the ``kernels`` line)
     and as device time from CUDA-graph replays (which the faster-than
     checks read: back to back the wrapper's host time paces it), its
     registers and the CTAs an SM holds at once;
  9. the fused paths: ``fused_velocity_fn`` against ``dense_velocity_fn``
     with its B4/B6 launch counts (every B4 launch from
     fused_edge_mlp_tf32x3, every B6 launch from fused_mlp_tf32x3), and the
     ``dense_fused`` exact sampler against
     the ``dense`` one with its B4/B5 launch counts (every B4 launch from
     fused_edge_mlp_tf32x3, every B5 launch from fused_edge_mlp_jvp_tf32x3),
     seconds and samples/s;
 10. kernel B7 on the tensor cores (3xTF32, div_kernel_tf32x3) against its
     plain version at 130 chains, L = 4 and 6, and at ragged shapes (N = 5,
     29 and 32; L = 1, 3 and 57; one chain) (bar 1e-4), two launches to the
     bit; ``divergence_kernel_batch`` at 128 chains, t = 0.5, launching B7
     once, from div_kernel_tf32x3, against ``divergence_exact(chunk=19)``
     over the dense forward and B3's full orthogonal frame in f32 (5
     launches, all from pair_tangent_tf32x3) (rtol 3e-4); B7 timed in turns
     beside the f32-FMA kernel (``variant="fma"``) at the plan's chunks a
     CTA and at 3, with both bounds, its registers and the MACs each kernel
     computes; the times of its plain version, the whole call and both
     yardsticks, and ``dense_divergence`` chain by chain;
 11. the reference's own sampler: ``sample_ambient(ambient_preset("00031"))``
     with no overrides (dopri5 at atol = rtol = 1e-5, the exact divergence
     inside every stage, 12 chains, 100 save points), its per-chain NFE,
     seconds and samples/s, against stage-coupled RK4 at 64 steps (rtol
     1e-3 / atol 1e-3); bench.py's reference shape: the edge-form Euler
     sampler (32 of its 64 steps, exact dlogp, batch 12) and its ms per evaluation in
     turns beside the dense form's, the edge velocity against the dense one
     (rtol 2e-3 / atol 2e-4) and the sampler against the same over the dense
     form; stage-coupled RK4 (8 steps, exact dlogp, 12 chains) through
     ``impl="dense_fused"`` against ``impl="dense"``, every B4 launch from
     fused_edge_mlp_tf32x3 and every B5 launch from
     fused_edge_mlp_jvp_tf32x3, with their counts;
 12. ambient training on the card at the 00031 width (T0s = T1s = [1000,
     300], frames from ``make_synthetic_frames``): one update's loss and
     gradients on the card against the CPU from the same weights, batch, t
     and z (edge f32 at batch 12: loss rtol 1e-5, gradients rtol 1e-4 with
     atol 1e-5 of each leaf's largest |gradient|; dense bf16_agg at batch
     64: loss and the whole gradient within 2e-2); about 20 timed update
     steps each of edge f32 at batch 12, dense f32 and dense bf16_agg at
     batch 256 and grad_accum 4 x 256 in bf16_agg (ms a step, molecules/s,
     peak memory; finite losses, moved parameters); ``train_ambient`` for a
     few steps and its ``params`` through ``sample_ambient`` under
     ``fast_profile`` at 128 chains (B1 from pair_layer_tf32x3 and B3 from
     pair_tangent_mma launch; finite samples and dlogp);
 13. the latent family (``phase_latent``): the latent kernel route
     (``fast_profile(latent_preset("00031", Ts=[300]), family="latent")``
     in f32 with ``traj_forward_impl="pair_kernel"`` and
     ``div_forward_impl="pair_tangent"``) through ``sample_latent`` at 256
     chains, 1,440 B1 launches from pair_layer_tf32x3 and 40 B3 from
     pair_tangent_tf32x3, samples/s, and 64 chains against the plain
     versions (dlogp at phase 4's bar; the samples no farther from the same
     trajectory in f64 than twice the plain route's); the published latent
     profile (bf16, the exact divergence, no kernel) at 160 chains with its
     peak memory, and
     the multi-temperature preset at its batch of 10; one ``train_latent``
     update card against CPU (phase 12's bars), 16 trainer steps and that
     field through the kernel route; the BG→TI composition (a generator at
     1000 K, then ``sample_ambient`` under ``fast_profile`` at 128 chains,
     the noise and dlogp passed through, ``calc_importance_weights``);
     Simpson-9 and unsegmented GL-8 over t in [0, 0.25] at 64 chains in
     f32, each against its rule recomputed through B3's full frame (rtol
     1e-3, atol 1e-3 max |dlogp|), beside stage-coupled RK4-16 (the gap
     reported);
 14. the ADW family (``phase_adw``): a 300k-sample synthetic dataset at
     beta 1.0 and 1.25; ms an update step (CUDA events) in f32 and f64 at
     batch 512; one update card against CPU in f32 (phase 12's bars) and in
     f64 (1e-10); two epochs of ``train_adw`` on the card; ``sample_adw`` of
     the 30,000-chain test split on RK4-64 + GL-8 and on the default dopri5
     (atol = rtol = 1e-4, 400 save points), samples/s, NFE and no kernel
     launch, the first 64 chains against the CPU at phase 4's bars;
     ``reweighted_gedmd_spectrum`` (50 bootstraps) finite on both;
 15. the large molecule's fast profile (``phase_10506``, 10506: 29 atoms,
     F = 256 x 5 layers): kernel B1 in bf16_agg at F = 256
     (``pair_layer_mma_f256``, csrc/pair_layer_mma.cu built with
     -DPK_F=256) against its plain version at 16 and 128 chains (bar 2e-2),
     B2 = B1 to the bit, timed with its bound;
     ``sample_ambient(fast_profile(ambient_preset("10506")))`` at 16 chains
     for two batches (720 B1 launches, all from pair_layer_mma_f256),
     samples/s, the path's first layer on its own inputs against its plain
     version (bar 2e-2), the path's drift (5 layers) on the first batch's
     states at t = 0 and 1 and the first batch's samples no farther from the
     plain f32 route's than twice the plain bf16_agg route's (each layer's
     rounding feeds the next, and grows along the trajectory);
     ``sample_molecular_sde`` at 512 chains, bf16_agg, 20 steps (100 B1
     launches), finite;
 16. the analysis layer (``phase_analysis``) over the main path's
     transported samples: ``sample_ambient`` under ``fast_profile`` at 2
     batches of 128 chains with its artifacts saved (360 B1 launches from
     pair_layer_tf32x3, 80 B3 from pair_tangent_mma), read back; harmonic
     stand-in energies and MD-reference frames; ``generate_full_report``
     with its z-matrices on the card against the same on the CPU; the NeRF
     reconstruction and its log|det J| at 29 atoms x 65,536 conformations;
     the torsion-space generator spectrum and a model-selection grid;
 17. the parallel layer (``phase_parallel``, chip_smoke_parallel.py): NCCL
     at world size 1, ``parallel_sampler`` over the main path at 128 chains
     against the unsharded run (180 B1 launches from pair_layer_tf32x3, 40 B3
     from pair_tangent_mma), the lane-sharded exact divergence and
     ``parallel_update`` against their unsharded forms, and the fan-out CLI
     (two shards of 128 chains on the one card, merged) against one
     unsharded CLI run;
 18. the user CLIs (``phase_cli``, chip_smoke_cli.py), in this process
     through ``main(argv)`` on a synthetic workspace: the latent chain
     (train, then 256 chains on the latent kernel route: 1,440 B1 from
     pair_layer_tf32x3, 40 B3 from pair_tangent_tf32x3, equal to the bit to
     ``sample_latent``), the SDE CLI (100 B1, equal to the bit to
     ``sample_molecular_sde``), results, plots, gEDMD and model selection
     over the ambient CLI's artifacts, the ADW chain (no kernel), a
     reference-layout checkpoint through ``torch_import`` and the main
     path, a ``profile_trace`` of one main-path batch (B1 x 180 and B3 x 40
     on the card's lanes) and ``device_time`` against ``cuda_ms``;
 19. the study CLIs (``phase_studies``, chip_smoke_studies.py), in this
     process through ``main(argv)`` at cut sizes: ``sde_scan`` (B1 and B2,
     f32 and bf16_agg, exactly layers x steps launches a run),
     ``large_scale_scan`` at the 10506 width (360 launches of
     pair_layer_mma_f256 or pair_layer_tf32x3_f256 a 16-chain batch; the
     rows whose nodes reach B3 at F = 256 launch it 40 times a batch from
     pair_tangent_mma_f256), ``profile_divergence`` (B4,
     B5 and B6 through its fused rows), ``probe_mode_study`` on the smoke's
     field (the K = d orthogonal frame exact within 1e-3), ``step_count_study``
     and ``adw_f64_study`` (ADW trained on the card in f32 and f64) and
     ``adw_plots`` (its refusal where matplotlib is missing);
 20. kernel B1 and B2 in f32 at F = 256 and the physics-validation CLIs
     (``phase_validate``, chip_smoke_validate.py): B1 (16 and 128 chains)
     and B2 (C = 4, 512 chains) from pair_layer_tf32x3_f256 against their
     plain versions, timed; the f32 SDE at F = 256 (100 B2 launches); a
     10506 fast-profile batch with ``traj_forward_impl="pair_kernel"`` (360
     B1 launches from pair_layer_tf32x3_f256) against the plain f32
     trajectory, beside the bf16_agg trajectory's samples/s;
     ``validate_mdqm9_physics`` through its kernel route on the smoke's
     field at 4 atoms (1,320 B1 from pair_layer_tf32x3, 50 B3 from
     pair_tangent_mma) against its default route (its closed-form bars on a
     field it trains are phase 22's);
     ``validate_latent_physics`` and ``validate_bg_ti_physics`` to the BG
     and composed identities;
 21. kernel B3 at F = 256 (``phase_b3_f256``, chip_smoke_b3_f256.py):
     pair_tangent_mma_f256 (bf16_agg) and pair_tangent_tf32x3_f256 (f32)
     against their plain versions at the 10506 node shape (16 chains, 29
     atoms, K = 32; f32 also at K = 87) and at ragged shapes, two launches
     to the bit, timed in turns with the plain versions beside their bounds;
     the 10506 fast profile with ``div_forward_impl="pair_tangent_bf16"``
     and ``"pair_tangent"`` (360 B1 and 40 B3 launches a batch), samples
     equal to the bit to the default node route's, dlogps against B3's
     plain version at the nodes on the same probes, samples/s beside the
     default route's;
 22. kernels B1/B2 and B3 at F = 64 (``phase_f64``, chip_smoke_f64.py):
     the four ``_f64`` libraries' registers (0 spills; the F = 128 and 256
     builds of B3 keep theirs), each kernel against its plain version at
     the CLI's shape (4 atoms, 1,024 chains, K = 12) and at 19 atoms, 128
     chains, timed in turns beside its bound, B2 at C = 2-4 to B1's bits,
     ragged shapes; ``validate_mdqm9_physics`` at its defaults (epochs cut)
     on the f32 and the bf16_agg kernel flags (792 B1 and 30 B3 launches a
     run, all ``_f64``) against its default route on the same field and
     the closed-form bars; the SDE on that field through B2 (C = 4);
 23. the ``kernels`` line, the card line and the result line.

Exits with code 2 when no CUDA card is available.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_ATOMS, F, LAYERS, CHAINS, LENGTH_SCALE = 19, 128, 5, 128, 10.0
H100_FP32 = 67e12     # FLOP/s, f32 outside the tensor cores (data sheet, 700 W)
H100_BF16 = 989e12    # FLOP/s, dense bf16 tensor cores
H100_TF32 = 495e12    # FLOP/s, dense TF32 tensor cores
H100_HBM = 3.35e12    # bytes/s
BAR = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # max |kernel - plain| / max |plain|
SDE_CHAINS, SDE_STEPS, BENCH_SDE_STEPS = 8192, 20, 100  # bench.py:378 runs 100 steps
# the stage-coupled RK4 reference of phase 11(a), cut from 256 steps (187 s on a
# slow host): its gap to dopri5 read 1.356e-6 in the samples and 4.1e-4 in the
# dlogps at 256 steps, 8.0e-7 and 5.4e-4 at 96 (dopri5's own error) and 4.4e-6
# and 5.4e-3 at 64 (|dlogp| 50-125; PERF.md section 6), an order of magnitude
# inside the bar of 1e-3 + 1e-3 |ref|
REF_RK4_STEPS = 64
# Euler steps a run of phase 11(b)'s timed edge-form sampler (bench.py's shape
# takes 64; the metric is ms an evaluation; cut for the smoke's time)
REF_SHAPE_STEPS = 32
# batch of phase 12(a)'s dense bf16_agg step held against the CPU's (cut from
# 256: the CPU's step took 31.8 s there)
CPU_DENSE_BATCH = 64
FUSED_CHAINS = 32  # the dense_fused exact sampler's batch
LAYER_WEIGHT_BYTES = 2 * 15 * F * F  # one message layer's bf16 matrices, streamed a CTA
# the harmonic well of phase 16's frames and stand-in energies: the width
# tools/torch_ambient_oracle.py trains on (its --jitter), wide enough that
# the random field's transported samples keep exp(-phi) above underflow
WELL_JITTER = 0.4
# the arrays phase 16's report saves (MD→TI with energies, the MD references
# at T0 and T1), under the reference's names (results_00031.py:291-340)
ANALYSIS_ARTIFACTS = (
    *(f"{kind}_{src}" for kind in ("torsions", "bond_angles", "bond_lengths")
      for src in ("md_ti_0", "md_ti_1")),
    "torsions_md_T0", "torsions_md_T1", "bond_angles_md_T0", "bond_angles_md_T1",
    "bond_lengths_md_0", "bond_lengths_md_1",
    "ess_md_ti_percentage", "ess_md_ti_ci_percentage", "df_md_ti", "dF_md_ti_ci",
    "weights_md_ti",
)
SOURCES = {  # kernel: (CUDA source, the TPU kernel it replaces)
    "pair_layer": ("ti_torch/csrc/pair_layer_tf32x3.cu", "ti_tpu/ops/pair_layer_kernel.py:83"),
    "pair_layer_bf16_agg": ("ti_torch/csrc/pair_layer_mma.cu",
                            "ti_tpu/ops/pair_layer_kernel.py:83"),
    "pair_layer_bf16_agg_f256": ("ti_torch/csrc/pair_layer_mma.cu",
                                 "ti_tpu/ops/pair_layer_kernel.py:83"),
    "pair_layer_cb": ("ti_torch/csrc/pair_layer_mma.cu", "ti_tpu/ops/pair_layer_kernel.py:190"),
    "pair_layer_f256": ("ti_torch/csrc/pair_layer_tf32x3.cu",
                        "ti_tpu/ops/pair_layer_kernel.py:83"),
    "pair_layer_cb_f256": ("ti_torch/csrc/pair_layer_tf32x3.cu",
                           "ti_tpu/ops/pair_layer_kernel.py:190"),
    "pair_tangent": ("ti_torch/csrc/pair_tangent_mma.cu", "ti_tpu/ops/pair_tangent_kernel.py:76"),
    "pair_tangent_f32": ("ti_torch/csrc/pair_tangent_tf32x3.cu",
                         "ti_tpu/ops/pair_tangent_kernel.py:76"),
    "pair_tangent_bf16_agg_f256": ("ti_torch/csrc/pair_tangent_mma.cu",
                                   "ti_tpu/ops/pair_tangent_kernel.py:76"),
    "pair_tangent_f32_f256": ("ti_torch/csrc/pair_tangent_tf32x3.cu",
                              "ti_tpu/ops/pair_tangent_kernel.py:76"),
    "pair_layer_f64": ("ti_torch/csrc/pair_layer_tf32x3.cu", "ti_tpu/ops/pair_layer_kernel.py:83"),
    "pair_layer_bf16_agg_f64": ("ti_torch/csrc/pair_layer_mma.cu",
                                "ti_tpu/ops/pair_layer_kernel.py:83"),
    "pair_layer_cb_f64": ("ti_torch/csrc/pair_layer_mma.cu",
                          "ti_tpu/ops/pair_layer_kernel.py:190"),
    "pair_tangent_f32_f64": ("ti_torch/csrc/pair_tangent_tf32x3.cu",
                             "ti_tpu/ops/pair_tangent_kernel.py:76"),
    "pair_tangent_bf16_agg_f64": ("ti_torch/csrc/pair_tangent_mma.cu",
                                  "ti_tpu/ops/pair_tangent_kernel.py:76"),
    "fused_edge_mlp": ("ti_torch/csrc/fused_edge_mlp_tf32x3.cu",
                       "ti_tpu/ops/pallas_kernels.py:180"),
    "fused_edge_mlp_jvp": ("ti_torch/csrc/fused_edge_mlp_jvp_tf32x3.cu",
                           "ti_tpu/ops/pallas_kernels.py:232"),
    "fused_mlp": ("ti_torch/csrc/fused_mlp_tf32x3.cu", "ti_tpu/ops/pallas_kernels.py:343"),
    "div_kernel": ("ti_torch/csrc/div_kernel_tf32x3.cu", "ti_tpu/ops/div_kernel.py:117"),
}


def log(*a):
    print(*a, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def torch_default_weights_(model, seed: int = 0):
    """Redraw ``model``'s weights from ``seed`` with PyTorch's default laws
    (``nn.Linear``: kaiming-uniform weights and uniform biases;
    ``nn.Embedding``: N(0, 1); LayerNorm 1 and 0; the equivariant maps N(0,
    1/f_in)), in construction order: the random field every phase but 12(c)
    runs on. A fresh ``CPaiNN`` draws as flax's ``model.init`` does, a
    field 100-300 times stronger at the 00031 width (|v| 20-170 against
    0.16-0.6 at |x| ~ 0.1): over RK4-8 the same plain code in f32 and in f64
    ends 24-44 apart there, so no two f32 implementations can be held to
    each other along a trajectory, and at its first update the loss is
    ~5e3 and f32 puts the gradient 3.4e-5 of each leaf's largest off f64."""
    from torch import nn

    from ti_torch.models.cpainn import EquivariantLinear

    torch.manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding, nn.LayerNorm)):
                mod.reset_parameters()
            elif isinstance(mod, EquivariantLinear):
                nn.init.normal_(mod.weight, std=mod.weight.shape[1] ** -0.5)
    return model


def cuda_ms(fn, n: int, warm: int = 2) -> float:
    """Mean device time of ``fn`` over n calls, CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int, replays: int = 5) -> float:
    """Mean device time of ``fn`` over n calls captured in a CUDA graph and
    replayed, CUDA events: the kernels' time without the host's enqueue
    time between them, which back-to-back calls of a small kernel's
    wrapper measure instead."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()  # warm-up outside the graph
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays)


def compare(outs, refs, dtype, what: str, bar=None) -> float:
    """Max abs error over the outputs; fails past the scaled bar (``bar``,
    else the dtype's)."""
    bar = BAR[dtype] if bar is None else bar
    worst_abs, worst_rel = 0.0, 0.0
    for a, r in zip(outs, refs):
        require(a.shape == r.shape and a.dtype == r.dtype, f"{what}: output shape/dtype")
        require(bool(torch.isfinite(a.float()).all()), f"{what}: finite outputs")
        err = (a.float() - r.float()).abs().max().item()
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / max(r.float().abs().max().item(), 1e-30))
    log(f"[{what}] max abs err {worst_abs:.3e}, max err / max |plain| {worst_rel:.3e} "
        f"(bar {bar:g})")
    require(worst_rel <= bar, f"{what}: kernel disagrees with its plain version")
    return worst_abs


def layer_inputs(params, dtype, k: int, seed: int, b: int = CHAINS, n: int = N_ATOMS,
                 f: int = F):
    """Layer 0 of ``params`` (width ``f``) packed for both tensor-core types,
    and random inputs with k lanes for b chains of n atoms."""
    from ti_torch.ops.pair_layer_kernel import pack_layer, with_mma_weights, with_tf32_weights

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")).to(dtype)

    w = with_mma_weights(with_tf32_weights(pack_layer(params, 0, f, dtype, "cuda")))
    x = 0.3 * torch.randn(b, n, 3, generator=g, device="cuda")
    base = (x, rnd(b, n, f), rnd(b, 3, n, f, scale=0.3), rnd(b, n * n, f))
    lanes = (torch.randn(b, k, n, 3, generator=g, device="cuda"), rnd(b, k, n, f, scale=0.1),
             rnd(b, k, 3, n, f, scale=0.1), rnd(b, k, n * n, f, scale=0.1))
    return w, base, lanes


def ptxas_kernels(text: str) -> list:
    """(entry function, its registers line, its spill line) from ``-Xptxas -v``."""
    found, name, spill = [], "?", ""
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            found.append((name, ln.strip(), spill))
    return found


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(flops: float, peak: float, moved: int):
    t_ops, t_bytes = flops / peak, moved / H100_HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def forward_costs(drift, xs, temps, n_fwd: int = 20) -> tuple:
    """One trajectory forward's host time to enqueue and its time
    synchronised, in ms (means over n_fwd forwards run one at a time, so the
    launch queue never fills), and the aten ops it dispatches that are
    neither views nor allocations: each launches about one kernel on the
    card (the pair-layer kernels, called through ctypes, are not among them)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view and func.overloadpacket.__name__ not in ("empty", "empty_strided"):
                self.n += 1
            return func(*args, **(kwargs or {}))

    enqueue = forward = 0.0
    with torch.no_grad():
        for _ in range(3):
            drift(xs, 0.5, temps)
        torch.cuda.synchronize()
        for _ in range(n_fwd):
            t0 = time.perf_counter()
            drift(xs, 0.5, temps)
            enqueue += (time.perf_counter() - t0) / n_fwd
            torch.cuda.synchronize()
            forward += (time.perf_counter() - t0) / n_fwd
        with Ops() as ops:
            drift(xs, 0.5, temps)
        torch.cuda.synchronize()
    return 1e3 * enqueue, 1e3 * forward, ops.n


def zero_com_x0(rng, b: int, n: int = N_ATOMS) -> np.ndarray:
    x0 = (0.1 * rng.standard_normal((b, n, 3))).astype(np.float32)
    return x0 - x0.mean(axis=1, keepdims=True)


def ambient_temps(b: int) -> np.ndarray:
    """T0 = 1000 K -> T1 = 300 K for every chain (fast_profile's sampling pair)."""
    return np.tile(np.array([1000.0, 300.0], np.float32), (b, 1))


CHAIN_BLOCKS = (2, 3, 4, 5, 8)  # B2's chain blocks held to B1's bits; pair_layer.cu takes 1..4
B2_LIBS = {torch.float32: "pair_layer_tf32x3", torch.bfloat16: "pair_layer_mma"}


def b2_is_b1(base, w, dtype, b: int) -> None:
    """Every chain block of CHAIN_BLOCKS launches the tensor-core kernel of
    the weights' type and gives B1's outputs to the bit."""
    from ti_torch.ops import _build
    from ti_torch.ops.pair_layer_kernel import pair_layer

    b1 = pair_layer(*base, w, LENGTH_SCALE)
    for c in CHAIN_BLOCKS:
        again = pair_layer(*base, w, LENGTH_SCALE, c)
        torch.cuda.synchronize()
        require(_build.ROUTES["pair_layer_cb"] == B2_LIBS[dtype],
                f"B2 {dtype} C={c} launches {B2_LIBS[dtype]}: {_build.ROUTES['pair_layer_cb']}")
        require(all(torch.equal(a, q) for a, q in zip(again, b1)),
                f"B2 {dtype} C={c} B={b} equals B1 to the bit")
    log(f"[B2 {dtype} B={b}] C={', '.join(map(str, CHAIN_BLOCKS))} ({B2_LIBS[dtype]}) equal C=1 "
        f"(B1) to the bit")


def phase_b2(params, rows_kernels, card: str) -> None:
    """6. B2 against its plain version and B1 at 130 and 8192 chains, in
    bf16_agg and f32; its times at 8192 chains."""
    from ti_torch.ops import _build
    from ti_torch.ops.pair_layer_kernel import mma_tile_plan, pair_layer, pair_layer_plain

    for dtype in (torch.float32, torch.bfloat16):
        w, base, _ = layer_inputs(params, dtype, 0, seed=3, b=130)  # 130: not a multiple of 4
        ref = pair_layer_plain(*base, w, LENGTH_SCALE)
        for c in CHAIN_BLOCKS:
            out = pair_layer(*base, w, LENGTH_SCALE, c)
            torch.cuda.synchronize()
            compare(out, ref, dtype, f"B2 pair_layer_cb {dtype} C={c} B=130")
        b2_is_b1(base, w, dtype, 130)
        for c in (2, 3, 4):  # variant="fma": pair_layer.cu, C chains a CTA
            out = pair_layer(*base, w, LENGTH_SCALE, c, variant="fma")
            torch.cuda.synchronize()
            require(_build.ROUTES["pair_layer_cb"] == "pair_layer",
                    f"B2 {dtype} C={c} variant=fma launches pair_layer.cu")
            compare(out, ref, dtype, f"B2 pair_layer_cb {dtype} C={c} B=130 variant=fma")
    # at the SDE's 8192 chains: C = 4 (the SDE's) against the plain version,
    # and every C against C = 1 to the bit
    w, base, _ = layer_inputs(params, torch.bfloat16, 0, seed=4, b=SDE_CHAINS)
    blocks = (1, 2, 3, 4)
    out = pair_layer(*base, w, LENGTH_SCALE, 4)
    torch.cuda.synchronize()
    ref = pair_layer_plain(*base, w, LENGTH_SCALE)
    err = compare(out, ref, torch.bfloat16, f"B2 pair_layer_cb bf16_agg C=4 B={SDE_CHAINS}")
    compare(pair_layer(*base, w, LENGTH_SCALE, 4, variant="fma"), ref, torch.bfloat16,
            f"B2 pair_layer_cb bf16_agg C=4 B={SDE_CHAINS} variant=fma (timed below)")
    del ref
    b2_is_b1(base, w, torch.bfloat16, SDE_CHAINS)
    bnd, by = bound_ms(2.0 * 15 * F * F * SDE_CHAINS * N_ATOMS ** 2, H100_BF16,
                       nbytes(*base, w.mats, w.vecs, *out))
    ms = {c: [] for c in blocks}
    fma = []
    for turn in ("mma", "fma", "fma", "mma"):  # in turns
        if turn == "fma":
            fma.append(cuda_ms(lambda: pair_layer(*base, w, LENGTH_SCALE, 4, variant="fma"), 2, warm=1))
        else:
            for c in blocks:
                ms[c].append(cuda_ms(lambda: pair_layer(*base, w, LENGTH_SCALE, c), 5, warm=1))
    plain = cuda_ms(lambda: pair_layer_plain(*base, w, LENGTH_SCALE), 2, warm=1)
    best = {c: min(t) for c, t in ms.items()}
    for c in blocks:
        plan = mma_tile_plan(SDE_CHAINS, N_ATOMS, c)
        streamed = plan.ctas * LAYER_WEIGHT_BYTES
        log(f"[B2 bf16_agg B={SDE_CHAINS} C={c}] {' and '.join(f'{t:.3f}' for t in ms[c])} ms per "
            f"launch ({best[c] / bnd:.2f}x the bound); {plan.ctas} CTAs of {plan.tiles} row tiles, "
            f"{plan.smem} bytes of shared memory; weights streamed from L2 "
            f"{streamed / 1e9:.3f} GB a launch")
    log(f"[B2 bf16_agg B={SDE_CHAINS}] variant=fma C=4 (f32 FMA, pair_layer.cu) "
        f"{' and '.join(f'{t:.3f}' for t in fma)} ms, in turns with the above; plain {plain:.3f} ms; "
        f"bound {bnd:.4f} ms ({by}); C=4 {min(fma) / best[4]:.2f}x faster than fma")
    require(best[4] < min(fma), "B2 on the tensor cores is faster than the f32-FMA kernel")
    rows_kernels["pair_layer_cb"] = dict(err=err, ms=best[4], plain=plain, bound=bnd, by=by)
    del w, base, out
    torch.cuda.empty_cache()
    # B2 in f32 at the same 8192 chains: on B1's 3xTF32 kernel, timed in
    # turns beside variant="fma" (pair_layer.cu, 4 chains a CTA, f32 FMA)
    w, base, _ = layer_inputs(params, torch.float32, 0, seed=4, b=SDE_CHAINS)
    out = pair_layer(*base, w, LENGTH_SCALE, 4)
    torch.cuda.synchronize()
    require(_build.ROUTES["pair_layer_cb"] == "pair_layer_tf32x3",
            "B2 in f32 launches pair_layer_tf32x3.cu")
    ref = pair_layer_plain(*base, w, LENGTH_SCALE)
    err32 = compare(out, ref, torch.float32, f"B2 pair_layer_cb f32 C=4 B={SDE_CHAINS} (3xTF32)")
    compare(pair_layer(*base, w, LENGTH_SCALE, 4, variant="fma"), ref, torch.float32,
            f"B2 pair_layer_cb f32 C=4 B={SDE_CHAINS} variant=fma (timed below)")
    require(_build.ROUTES["pair_layer_cb"] == "pair_layer", "B2 f32 variant=fma launches pair_layer.cu")
    del ref
    b2_is_b1(base, w, torch.float32, SDE_CHAINS)
    ms32 = {"tc": [], "fma": []}
    for turn in ("tc", "fma", "fma", "tc"):  # in turns
        variant = None if turn == "tc" else "fma"
        ms32[turn].append(cuda_ms(lambda: pair_layer(*base, w, LENGTH_SCALE, 4, variant=variant),
                                  3 if turn == "tc" else 2, warm=1))
    require(_build.ROUTES["pair_layer_cb"] == "pair_layer_tf32x3", "B2 in f32 timed on the tensor cores")
    plain32 = cuda_ms(lambda: pair_layer_plain(*base, w, LENGTH_SCALE), 1, warm=1)
    flops = 2.0 * 15 * F * F * SDE_CHAINS * N_ATOMS ** 2
    moved = nbytes(*base, w.mats, w.vecs, *out)
    bnd_tc, by_tc = bound_ms(3 * flops, H100_TF32, moved)
    bnd_fma, by_fma = bound_ms(flops, H100_FP32, moved)
    tc_ms, fma_ms = min(ms32["tc"]), min(ms32["fma"])
    log(f"[B2 f32 B={SDE_CHAINS} C=4] ms per launch, in turns: 3xTF32 (tensor cores, "
        f"pair_layer_tf32x3, B1's tiles) {' and '.join(f'{t:.3f}' for t in ms32['tc'])}, "
        f"variant=fma (pair_layer.cu, f32 FMA, 4 chains a CTA) "
        f"{' and '.join(f'{t:.3f}' for t in ms32['fma'])}; 3xTF32 {fma_ms / tc_ms:.2f}x faster; "
        f"plain {plain32:.3f} ms; bound {bnd_tc:.4f} ms ({by_tc}, 3 x {flops:.4e} FLOP at 495 "
        f"TFLOP/s TF32), f32 FMA bound {bnd_fma:.4f} ms ({by_fma}, 67 TFLOP/s); 3xTF32 at "
        f"{tc_ms / bnd_tc:.2f}x its bound, fma at {fma_ms / bnd_fma:.2f}x its bound; max abs err "
        f"{err32:.3e} ({card})")
    require(tc_ms < fma_ms, "B2 in f32 on the tensor cores is faster than the f32-FMA kernel")
    del w, base, out
    torch.cuda.empty_cache()


def phase_sde(model, template, card: str) -> dict:
    """7. The SDE path: f32 C=2 against the plain version, then the 8192-chain
    runs through sample_molecular_sde, bf16_agg and f32. Returns the
    bf16_agg run's launch counts."""
    from ti_torch.ops import _build
    from ti_torch.ops.pair_layer_kernel import pair_kernel_drift
    from ti_torch.sampling.drivers import sample_molecular_sde
    from ti_torch.sampling.integrators import sample_sde

    rng = np.random.default_rng(2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(g_fn=0.1, n_steps=SDE_STEPS, n_save=2)
    b = 256
    x0, temps = zero_com_x0(rng, b), ambient_temps(b)
    noise = torch.randn((SDE_STEPS, b, N_ATOMS, 3), generator=gen, device="cuda")
    got = sample_molecular_sde(model, None, template, x0, temps, forward_impl="pair_kernel",
                               chain_block=2, noise=noise, device="cuda", **kw)
    drift = pair_kernel_drift(model, None, template, device="cuda", kernel=False)
    conds = torch.as_tensor(temps, device="cuda")
    with torch.no_grad():
        ref = sample_sde(lambda x, t: drift(x, t, conds), torch.as_tensor(x0, device="cuda"),
                         project_zero_mean=True, noise=noise, **kw).movedim(0, 1)
    err = (got - ref).abs().max().item()
    log(f"[SDE f32 C=2 B={b}] kernel against plain version, same noise: max abs err {err:.3e}")
    require(bool(torch.allclose(got, ref, rtol=1e-4, atol=1e-5)),
            "SDE f32: the kernel SDE agrees with the plain-version SDE (rtol 1e-4, atol 1e-5)")

    x0, temps = zero_com_x0(rng, SDE_CHAINS), ambient_temps(SDE_CHAINS)
    sde_kw = dict(forward_impl="pair_kernel", compute_dtype="bf16_agg", chain_block=4,
                  device="cuda")
    sample_molecular_sde(model, None, template, x0, temps, gen, g_fn=0.1, n_steps=1, n_save=2,
                         **sde_kw)  # warm-up, not counted
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    xs = sample_molecular_sde(model, None, template, x0, temps, gen, **kw, **sde_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"[SDE bf16_agg C=4] {SDE_CHAINS} chains, {SDE_STEPS} Euler-Maruyama steps (bench.py "
        f"runs {BENCH_SDE_STEPS}), g=0.1, T0=1000 -> T1=300: {wall:.3f} s, "
        f"{SDE_CHAINS / wall:.3f} samples/s (host clock, {card}); launches {launches}")
    want = {k: 0 for k in launches}
    want["pair_layer_cb"] = SDE_STEPS * LAYERS
    require(launches == want, f"SDE launch counts {launches} == {want}")
    by_route = {k: n for k, n in _build.ROUTE_LAUNCHES.items() if n}
    require(by_route == {("pair_layer_cb", "pair_layer_mma"): want["pair_layer_cb"]},
            f"every B2 launch of the SDE comes from pair_layer_mma.cu: {by_route}")
    require(xs.shape == (SDE_CHAINS, 2, N_ATOMS, 3) and bool(torch.isfinite(xs).all()),
            "SDE: finite samples of the expected shape")
    com = xs.mean(dim=2).abs().amax(dim=(0, 2))
    log(f"[SDE] max |centre of mass| over chains at t0 {com[0].item():.3e}, at t1 "
        f"{com[1].item():.3e} (the random-weight drift's own centre of mass moves it)")
    require(com[0].item() <= 1e-6, "SDE: zero centre of mass at t0")
    # one step from the same x0 and noise with and without g: the noise moves
    # every chain but adds nothing to its centre of mass
    one = torch.randn((1, SDE_CHAINS, N_ATOMS, 3), generator=gen, device="cuda")
    noisy, still = (sample_molecular_sde(model, None, template, x0, temps, g_fn=g, noise=one,
                                         n_steps=1, n_save=2, **sde_kw) for g in (0.1, 0.0))
    dcom = (noisy.mean(dim=2) - still.mean(dim=2)).abs().max().item()
    moved = (noisy - still).abs().max().item()
    log(f"[SDE] one step with and without noise: positions differ by up to {moved:.3e}, "
        f"centres of mass by {dcom:.3e}")
    require(moved > 1e-3 and dcom <= 1e-6, "SDE: the projected noise keeps each chain's COM")
    # the same SDE in f32: B2 on B1's 3xTF32 kernel
    sde32 = dict(forward_impl="pair_kernel", chain_block=4, device="cuda")
    sample_molecular_sde(model, None, template, x0, temps, gen, g_fn=0.1, n_steps=1, n_save=2,
                         **sde32)  # warm-up, not counted
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    xs32 = sample_molecular_sde(model, None, template, x0, temps, gen, **kw, **sde32)
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0
    routes32 = {k: n for k, n in _build.ROUTE_LAUNCHES.items() if n}
    log(f"[SDE f32 C=4] {SDE_CHAINS} chains, {SDE_STEPS} Euler-Maruyama steps, g=0.1: "
        f"{wall32:.3f} s, {SDE_CHAINS / wall32:.3f} samples/s (host clock, {card}); launches by "
        f"library { {f'{k}:{lib}': n for (k, lib), n in routes32.items()} }")
    require(routes32 == {("pair_layer_cb", "pair_layer_tf32x3"): SDE_STEPS * LAYERS},
            f"every B2 launch of the f32 SDE comes from pair_layer_tf32x3.cu: {routes32}")
    require(xs32.shape == (SDE_CHAINS, 2, N_ATOMS, 3) and bool(torch.isfinite(xs32).all()),
            "f32 SDE: finite samples of the expected shape")
    return launches


def phase_fused_kernels(params, rows_kernels, report, card: str) -> None:
    """8. B4, B5, B6 against their plain versions at full width; B4, B5 and
    B6 on the tensor cores against the f32-FMA kernels, timed in turns."""
    import ctypes

    from ti_torch.ops import _build
    from ti_torch.ops import pallas_kernels as pk
    from ti_torch.ops.mlp_block import mlp_weights
    from ti_torch.ops.pair_layer_kernel import pack_layer, with_tf32_weights

    f32 = torch.float32
    g = torch.Generator(device="cuda").manual_seed(5)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    w = with_tf32_weights(pack_layer(params, 0, F, f32, "cuda"))
    mac_row = 15 * F * F
    fmt = lambda ts: " and ".join(f"{t:.4f}" for t in ts)
    # B4 at the row counts its paths give it: the 3xTF32 tensor-core kernel
    # and, timed beside it in turns, the f32-FMA kernel
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for r, what in ((CHAINS * N_ATOMS ** 2, f"the dense grid of {CHAINS} chains"),
                    (CHAINS * N_ATOMS * (N_ATOMS - 1), f"fused_velocity_fn's edges, {CHAINS} chains"),
                    (FUSED_CHAINS * N_ATOMS ** 2, f"the dense_fused sampler's {FUSED_CHAINS} chains")):
        in_feat, pe = rn(r, 2 * F), rn(r, F)
        ref = pk.fused_edge_mlp_reference(in_feat, pe, w.phi, w.w)
        out = pk.fused_edge_mlp(in_feat, pe, w)
        torch.cuda.synchronize()
        require(_build.ROUTES["fused_edge_mlp"] == "fused_edge_mlp_tf32x3",
                "B4 launches fused_edge_mlp_tf32x3.cu by default")
        err = compare([out], [ref], f32, f"B4 fused_edge_mlp R={r} (3xTF32)")
        old = pk.fused_edge_mlp(in_feat, pe, w, variant="fma")
        torch.cuda.synchronize()
        require(_build.ROUTES["fused_edge_mlp"] == "fused_edge_mlp",
                "variant='fma' launches fused_edge_mlp.cu")
        compare([old], [ref], f32, f"B4 fused_edge_mlp R={r} variant=fma")
        compare([out], [old], f32, f"B4 R={r} 3xTF32 against variant=fma")
        again = pk.fused_edge_mlp(in_feat, pe, w)
        torch.cuda.synchronize()
        require(torch.equal(again, out), "B4 3xTF32: two launches on the same inputs agree to the bit")
        del ref, old, again
        reps = 20
        ms = {v: [] for v in ("tc", "fma")}
        for variant in ("tc", "fma", "fma", "tc"):
            ms[variant].append(cuda_ms(lambda: pk.fused_edge_mlp(in_feat, pe, w, variant=variant),
                                       reps, warm=2))
        plain = cuda_ms(lambda: pk.fused_edge_mlp_reference(in_feat, pe, w.phi, w.w), 5)
        tc_ms, fma_ms = min(ms["tc"]), min(ms["fma"])
        moved = nbytes(in_feat, pe, w.mats, w.vecs, out)
        flops = 2.0 * mac_row * r
        bnd_fma, by_fma = bound_ms(flops, H100_FP32, moved)
        bnd_tc, by_tc = bound_ms(3 * flops, H100_TF32, moved)
        plan = pk.edge_plan(r, sms)
        log(f"[B4 R={r}] ({what}; {plan.ctas} CTAs, {plan.resident} resident, {plan.waves} "
            f"wave(s)) ms per launch, {reps} launches a reading, in turns: 3xTF32 (tensor cores, "
            f"fused_edge_mlp_tf32x3) {fmt(ms['tc'])}, variant=fma (f32 FMA) {fmt(ms['fma'])}; "
            f"3xTF32 {fma_ms / tc_ms:.2f}x faster; plain {plain:.4f} ms; bound {bnd_tc:.4f} ms "
            f"({by_tc}, 3 x {flops:.4e} FLOP at 495 TFLOP/s TF32), f32 FMA bound {bnd_fma:.4f} ms "
            f"({by_fma}, 67 TFLOP/s); 3xTF32 at {tc_ms / bnd_tc:.2f}x its bound, fma at "
            f"{fma_ms / bnd_fma:.2f}x its bound; {moved / 1e6:.1f} MB moved ({card})")
        require(tc_ms < fma_ms, f"B4 on the tensor cores is faster than the f32-FMA kernel at R={r}")
        require(tc_ms < plain, f"B4 on the tensor cores is faster than its plain version at R={r}")
        if r == FUSED_CHAINS * N_ATOMS ** 2:  # the shape of the launches counted on its path
            rows_kernels["fused_edge_mlp"] = dict(err=err, ms=tc_ms, plain=plain, bound=bnd_tc,
                                                  by=by_tc)
        del in_feat, pe, out
    for fn, regs, spill in ptxas_kernels(report["fused_edge_mlp_tf32x3"]["ptxas"]):
        log(f"[B4 build] {fn}: {regs}; {spill}")
    lib = _build.load("fused_edge_mlp_tf32x3")
    lib.fused_edge_mlp_tf32x3_smem_bytes.restype = ctypes.c_ulonglong
    per_sm = lib.fused_edge_mlp_tf32x3_ctas_per_sm()
    log(f"[B4 occupancy] {per_sm} CTAs of 256 threads an SM, "
        f"{lib.fused_edge_mlp_tf32x3_smem_bytes()} bytes of shared memory each")
    require(per_sm == pk.EDGE_CTAS_PER_SM, f"B4 runs {pk.EDGE_CTAS_PER_SM} CTAs an SM: {per_sm}")
    # ragged counts: one row, partial tiles, a tile, a tile and one row,
    # 1,007 and 4,097
    for r in (1, 5, 63, 64, 65, 1007, 4097):
        in_feat, pe = rn(r, 2 * F), rn(r, F)
        out = pk.fused_edge_mlp(in_feat, pe, w)
        torch.cuda.synchronize()
        compare([out], [pk.fused_edge_mlp_reference(in_feat, pe, w.phi, w.w)], f32,
                f"B4 fused_edge_mlp R={r} (3xTF32)")
    del in_feat, pe, out
    torch.cuda.empty_cache()

    # B5 at one exact node of 32 chains: the 3xTF32 tensor-core kernel and,
    # timed beside it in turns, the f32-FMA kernel
    r, k = FUSED_CHAINS * N_ATOMS ** 2, 3 * N_ATOMS
    in_feat, pe, din, dpe = rn(r, 2 * F), rn(r, F), rn(k, r, 2 * F), rn(k, r, F)
    ref = pk.edge_mlp_jvp_reference(in_feat, pe, din, dpe, w.phi, w.w)
    out = pk.fused_edge_mlp_jvp(in_feat, pe, din, dpe, w)
    torch.cuda.synchronize()
    require(_build.ROUTES["fused_edge_mlp_jvp"] == "fused_edge_mlp_jvp_tf32x3",
            "B5 launches fused_edge_mlp_jvp_tf32x3.cu by default")
    err = compare([out], [ref], f32, f"B5 fused_edge_mlp_jvp K={k} R={r} (3xTF32)")
    old = pk.fused_edge_mlp_jvp(in_feat, pe, din, dpe, w, variant="fma")
    torch.cuda.synchronize()
    require(_build.ROUTES["fused_edge_mlp_jvp"] == "fused_edge_mlp_jvp",
            "variant='fma' launches fused_edge_mlp_jvp.cu")
    compare([old], [ref], f32, f"B5 fused_edge_mlp_jvp K={k} R={r} variant=fma")
    compare([out], [old], f32, "B5 3xTF32 against variant=fma")
    again = pk.fused_edge_mlp_jvp(in_feat, pe, din, dpe, w)
    torch.cuda.synchronize()
    require(torch.equal(again, out), "B5 3xTF32: two launches on the same inputs agree to the bit")
    del ref, old, again
    reps = 3
    ms = {v: [] for v in ("tc", "fma")}
    for variant in ("tc", "fma", "fma", "tc"):
        ms[variant].append(cuda_ms(lambda: pk.fused_edge_mlp_jvp(in_feat, pe, din, dpe, w,
                                                                 variant=variant), reps, warm=1))
    plain = cuda_ms(lambda: pk.edge_mlp_jvp_reference(in_feat, pe, din, dpe, w.phi, w.w), 2,
                    warm=1)
    tc_ms, fma_ms = min(ms["tc"]), min(ms["fma"])
    moved = nbytes(in_feat, pe, din, dpe, w.mats, w.vecs, out)
    flops = 2.0 * mac_row * r * (k + 1)
    bnd_fma, by_fma = bound_ms(flops, H100_FP32, moved)
    bnd_tc, by_tc = bound_ms(3 * flops, H100_TF32, moved)
    log(f"[B5 K={k} R={r}] ms per launch, {reps} launches a reading, in turns: 3xTF32 (tensor "
        f"cores, fused_edge_mlp_jvp_tf32x3) {fmt(ms['tc'])}, variant=fma (f32 FMA) "
        f"{fmt(ms['fma'])}; 3xTF32 {fma_ms / tc_ms:.2f}x faster; plain {plain:.3f} ms; bound "
        f"{bnd_tc:.4f} ms ({by_tc}, 3 x {flops:.4e} FLOP at 495 TFLOP/s TF32), f32 FMA bound "
        f"{bnd_fma:.4f} ms ({by_fma}, 67 TFLOP/s); 3xTF32 at {tc_ms / bnd_tc:.2f}x its bound, "
        f"fma at {fma_ms / bnd_fma:.2f}x its bound; {moved / 1e9:.3f} GB moved ({card})")
    for fn, regs, spill in ptxas_kernels(report["fused_edge_mlp_jvp_tf32x3"]["ptxas"]):
        log(f"[B5 build] {fn}: {regs}; {spill}")
    require(tc_ms < fma_ms, "B5 on the tensor cores is faster than the f32-FMA kernel")
    require(tc_ms < plain, "B5 on the tensor cores is faster than its plain version")
    rows_kernels["fused_edge_mlp_jvp"] = dict(err=err, ms=tc_ms, plain=plain, bound=bnd_tc,
                                              by=by_tc)
    del in_feat, pe, din, dpe, out
    torch.cuda.empty_cache()
    # ragged shapes: one row and a partial tile (R = 5), a tile and one row
    # (65), a partial last tile (4,097 = 64 x 64 + 1); one lane, 3 and 87 (the
    # exact node at 29 atoms)
    for r, k in ((5, 1), (65, 3), (4097, 87)):
        in_feat, pe, din, dpe = rn(r, 2 * F), rn(r, F), rn(k, r, 2 * F), rn(k, r, F)
        out = pk.fused_edge_mlp_jvp(in_feat, pe, din, dpe, w)
        torch.cuda.synchronize()
        compare([out], [pk.edge_mlp_jvp_reference(in_feat, pe, din, dpe, w.phi, w.w)], f32,
                f"B5 fused_edge_mlp_jvp K={k} R={r} (3xTF32)")
    del in_feat, pe, din, dpe, out
    torch.cuda.empty_cache()

    # B6 at the node rows of 128 chains, each MLP of fused_velocity_fn (and
    # the latent conditioning's 3F -> F combine: the combine's first 3F rows):
    # the 3xTF32 tensor-core kernel and, timed beside it in turns, the
    # f32-FMA kernel; then ragged row counts
    r = CHAINS * N_ATOMS
    combine = mlp_weights(params, "combine")
    mlps = (("combine", combine), ("latent combine", combine._replace(w1=combine.w1[:3 * F])),
            ("update_0.mlp", mlp_weights(params, "update_0.mlp")),
            ("readout.mlp", mlp_weights(params, "readout.mlp")))
    reps = 50
    for name, mw in mlps:
        pack = pk.pack_mlp(mw, "cuda")
        f_in, f_out = pack.f_in, pack.f_out
        what = f"B6 fused_mlp {name} {f_in}->{f_out}"
        x = rn(r, f_in)
        ref = pk._mlp_block(x, pack.w)
        out = pk.fused_mlp(x, pack)
        torch.cuda.synchronize()
        require(_build.ROUTES["fused_mlp"] == "fused_mlp_tf32x3",
                "B6 launches fused_mlp_tf32x3.cu by default")
        err = compare([out], [ref], f32, f"{what} R={r} (3xTF32)")
        old = pk.fused_mlp(x, pack, variant="fma")
        torch.cuda.synchronize()
        require(_build.ROUTES["fused_mlp"] == "fused_mlp", "variant='fma' launches fused_mlp.cu")
        compare([old], [ref], f32, f"{what} R={r} variant=fma")
        compare([out], [old], f32, f"{what} R={r} 3xTF32 against variant=fma")
        again = pk.fused_mlp(x, pack)
        torch.cuda.synchronize()
        require(torch.equal(again, out), "B6 3xTF32: two launches on the same inputs agree to the bit")
        # back to back, as every kernel of the kernels line is timed, and
        # device time from CUDA-graph replays: back to back the wrapper's host
        # time (about 0.02 ms) is of the order of the kernel's, so the
        # faster-than checks read the graph times
        ms = {v: [] for v in ("tc", "fma")}
        b2b = {v: [] for v in ("tc", "fma")}
        for variant in ("tc", "fma", "fma", "tc"):
            call = lambda: pk.fused_mlp(x, pack, variant=variant)
            ms[variant].append(graph_ms(call, reps))
            b2b[variant].append(cuda_ms(call, reps, warm=5))
        plain = graph_ms(lambda: pk._mlp_block(x, pack.w), reps)
        plain_b2b = cuda_ms(lambda: pk._mlp_block(x, pack.w), reps, warm=5)
        tc_ms, fma_ms = min(ms["tc"]), min(ms["fma"])
        moved = nbytes(x, *pack.w, out)
        flops = 2.0 * r * (f_in + F + f_out) * F
        bnd_fma, by_fma = bound_ms(flops, H100_FP32, moved)
        bnd_tc, by_tc = bound_ms(3 * flops, H100_TF32, moved)
        plan = pk.mlp_plan(r, f_in, f_out)
        log(f"[B6 {name} {f_in}->{f_out} R={r}] ({plan.ctas} CTAs of {pk.MLP_ROWS} rows) device ms "
            f"per launch, {reps} launches a CUDA graph, in turns: 3xTF32 (tensor cores, "
            f"fused_mlp_tf32x3) {fmt(ms['tc'])}, variant=fma (f32 FMA) {fmt(ms['fma'])}; 3xTF32 "
            f"{fma_ms / tc_ms:.2f}x faster; back to back (the kernels line's method, the host's "
            f"pace) 3xTF32 {fmt(b2b['tc'])}, variant=fma {fmt(b2b['fma'])}; plain {plain:.4f} ms "
            f"in a graph, {plain_b2b:.4f} ms back to back; bound {bnd_tc:.5f} ms ({by_tc}, "
            f"3 x {flops:.4e} FLOP at 495 TFLOP/s TF32), f32 FMA bound {bnd_fma:.5f} ms ({by_fma}, "
            f"67 TFLOP/s); 3xTF32 at {tc_ms / bnd_tc:.2f}x its bound, fma at "
            f"{fma_ms / bnd_fma:.2f}x its bound; {moved / 1e6:.2f} MB moved ({card})")
        require(tc_ms < fma_ms, f"B6 {name} on the tensor cores is faster than the f32-FMA kernel")
        require(tc_ms < plain, f"B6 {name} on the tensor cores is faster than its plain version")
        if name == "update_0.mlp":  # 5 of the 7 launches of a forward
            rows_kernels["fused_mlp"] = dict(err=err, ms=min(b2b["tc"]), plain=plain_b2b,
                                             bound=bnd_tc, by=by_tc)
        # ragged counts: one row, parts of a tile, a tile and one row, 4,097
        for rr in (1, 5, 15, 16, 17, 63, 64, 65, 4097):
            xr = rn(rr, f_in)
            out = pk.fused_mlp(xr, pack)
            torch.cuda.synchronize()
            compare([out], [pk._mlp_block(xr, pack.w)], f32, f"{what} R={rr} (3xTF32)")
        del x, ref, out, old, again
    for fn, regs, spill in ptxas_kernels(report["fused_mlp_tf32x3"]["ptxas"]):
        log(f"[B6 build] {fn}: {regs}; {spill}")
    lib = _build.load("fused_mlp_tf32x3")
    lib.fused_mlp_tf32x3_smem_bytes.restype = ctypes.c_ulonglong
    per_sm = lib.fused_mlp_tf32x3_ctas_per_sm()
    plan = pk.mlp_plan(r, 2 * F, 3 * F)
    log(f"[B6 occupancy] {per_sm} CTAs an SM, each 256 threads, {lib.fused_mlp_tf32x3_rows()} rows "
        f"and {lib.fused_mlp_tf32x3_smem_bytes()} bytes of shared memory; {plan.ctas} CTAs at {r} "
        f"rows on {sms} SMs")
    require(lib.fused_mlp_tf32x3_rows() == pk.MLP_ROWS
            and lib.fused_mlp_tf32x3_smem_bytes() == pk.tc_mlp_smem_bytes(),
            "B6's rows a CTA and shared memory are the wrapper's")
    require(per_sm == pk.MLP_CTAS_PER_SM and per_sm * sms >= plan.ctas,
            f"every CTA of B6 at {r} rows is resident at once: {per_sm} an SM")


def phase_fused_paths(model, template, card: str) -> tuple:
    """9. fused_velocity_fn against dense_velocity_fn, and the dense_fused
    exact sampler against the dense one. Returns both runs' launch counts."""
    from ti_torch.models.cpainn import state_of
    from ti_torch.models.cpainn_dense import dense_velocity_fn
    from ti_torch.models.cpainn_fused import fused_velocity_fn
    from ti_torch.ops import _build
    from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of

    rng = np.random.default_rng(3)
    xs = torch.as_tensor(zero_com_x0(rng, CHAINS), device="cuda")
    conds = torch.as_tensor(ambient_temps(CHAINS), device="cuda")
    fused = fused_velocity_fn(model, None, template, device="cuda")
    p = {k: t.detach().to("cuda") for k, t in state_of(model, None).items()}
    dense = dense_velocity_fn(model, p, template)
    fused(xs, 0.5, conds)  # warm-up, not counted
    torch.cuda.synchronize()
    _build.reset_launches()
    v_fused = fused(xs, 0.5, conds)
    torch.cuda.synchronize()
    fwd_launches = dict(_build.LAUNCHES)
    fwd_routes = {key: n for key, n in _build.ROUTE_LAUNCHES.items() if n}
    with torch.no_grad():
        v_dense = dense(xs, 0.5, conds)
        ms_f = cuda_ms(lambda: fused(xs, 0.5, conds), 5)
        ms_d = cuda_ms(lambda: dense(xs, 0.5, conds), 5)
    err = (v_fused - v_dense).abs().max().item()
    log(f"[fused_velocity_fn B={CHAINS}] against dense_velocity_fn: max abs err {err:.3e}; "
        f"{ms_f:.3f} ms per forward (dense {ms_d:.3f} ms; {card}); launches {fwd_launches}, B4 and "
        f"B6 by library { {f'{k}:{lib}': n for (k, lib), n in fwd_routes.items()} }")
    want = {k: 0 for k in fwd_launches}
    want.update(fused_edge_mlp=LAYERS, fused_mlp=LAYERS + 2)
    require(fwd_launches == want, f"fused forward launch counts {fwd_launches} == {want}")
    require(fwd_routes == {("fused_edge_mlp", "fused_edge_mlp_tf32x3"): LAYERS,
                           ("fused_mlp", "fused_mlp_tf32x3"): LAYERS + 2},
            f"every B4 launch of fused_velocity_fn comes from fused_edge_mlp_tf32x3.cu and every "
            f"B6 launch from fused_mlp_tf32x3.cu: {fwd_routes}")
    require(bool(torch.allclose(v_fused, v_dense, rtol=1e-4, atol=1e-5)),
            "fused_velocity_fn agrees with dense_velocity_fn (rtol 1e-4, atol 1e-5)")

    b, gl, n_steps = FUSED_CHAINS, 8, 8
    x0, temps = zero_com_x0(rng, b), ambient_temps(b)
    kw = dict(solver="rk4", n_steps=n_steps, dlogp_quad="gauss", dlogp_quad_points=gl,
              steps_per_dispatch=25, divergence="exact", device="cuda")
    fused_sampler = make_ode_sampler(
        molecular_v_fn_of(model, None, template, impl="dense_fused", device="cuda"), **kw)
    dense_sampler = make_ode_sampler(molecular_v_fn_of(model, None, template, device="cuda"), **kw)
    for sampler in (fused_sampler, dense_sampler):  # warm-up, not counted: the first torch.func
        sampler(x0, temps, torch.Generator(device="cuda").manual_seed(0))  # call pays one-time set-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out_f = fused_sampler(x0, temps, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t0
    smp_launches = dict(_build.LAUNCHES)
    smp_routes = {key: n for key, n in _build.ROUTE_LAUNCHES.items() if n}
    t0 = time.perf_counter()
    out_d = dense_sampler(x0, temps, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    # (1 + GL) gaps x 1 RK4 step x 4 stages of trajectory forwards, and per
    # node two forwards (the JVPs' primal and the velocity) and one B5 per layer
    forwards = (1 + gl) * max(1, -(-n_steps // (1 + gl))) * 4 + 2 * gl
    want = {k: 0 for k in smp_launches}
    want.update(fused_edge_mlp=forwards * LAYERS, fused_edge_mlp_jvp=gl * LAYERS)
    s_err = (out_f.xs - out_d.xs).abs().max().item()
    d_ref = out_d.dlogp[:, -1]
    d_err = (out_f.dlogp[:, -1] - d_ref).abs().max().item()
    log(f"[dense_fused exact sampler B={b}] {wall_f:.3f} s, {b / wall_f:.3f} samples/s "
        f"(dense: {wall_d:.3f} s, {b / wall_d:.3f} samples/s; host clock, {card}); samples max "
        f"abs err {s_err:.3e}, dlogp max abs err {d_err:.3e} (max |dlogp| "
        f"{d_ref.abs().max().item():.4f}); launches {smp_launches}, B4 and B5 by library "
        f"{ {f'{k}:{lib}': n for (k, lib), n in smp_routes.items()} }")
    require(smp_launches == want, f"dense_fused sampler launch counts {smp_launches} == {want}")
    require(smp_routes == {("fused_edge_mlp", "fused_edge_mlp_tf32x3"): want["fused_edge_mlp"],
                           ("fused_edge_mlp_jvp", "fused_edge_mlp_jvp_tf32x3"): want["fused_edge_mlp_jvp"]},
            f"every B4 launch of the dense_fused sampler comes from fused_edge_mlp_tf32x3.cu and "
            f"every B5 launch from fused_edge_mlp_jvp_tf32x3.cu: {smp_routes}")
    require(bool(torch.isfinite(out_f.xs).all() and torch.isfinite(out_f.dlogp).all()),
            "dense_fused sampler: finite")
    require(bool(torch.allclose(out_f.xs, out_d.xs, rtol=1e-4, atol=1e-5)),
            "dense_fused sampler: samples agree with dense (rtol 1e-4, atol 1e-5)")
    d_atol = 1e-3 * d_ref.abs().max().item()
    require(bool(torch.allclose(out_f.dlogp, out_d.dlogp, rtol=1e-3, atol=d_atol)),
            "dense_fused sampler: dlogp agrees with dense (rtol 1e-3, atol 1e-3 max|dlogp|)")
    return fwd_launches, smp_launches


def phase_reference(model, template, card: str) -> dict:
    """11. The reference's own sampler and bench.py's reference shape: (a)
    ``sample_ambient(ambient_preset("00031"))`` with no overrides (dopri5 at
    atol = rtol = 1e-5, the exact divergence inside every stage, 12 chains)
    against stage-coupled RK4 at ``REF_RK4_STEPS`` steps; (b) the edge-form Euler sampler
    bench.py prices (exact dlogp, batch 12; ``REF_SHAPE_STEPS`` of its 64
    steps), its ms per evaluation,
    the edge velocity against the dense one and the sampler against the
    same over the dense form; (c) stage-coupled RK4 through
    ``impl="dense_fused"`` (B4, B5) against ``impl="dense"``, with its
    launch counts. Returns (c)'s launch counts."""
    from ti_torch.config import ambient_preset
    from ti_torch.ops import _build
    from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of, sample_ambient

    rng = np.random.default_rng(11)
    dense_of = molecular_v_fn_of(model, None, template, device="cuda")

    # (a) the reference sampler, the preset as it stands
    with tempfile.TemporaryDirectory() as tmp:
        cfg = ambient_preset("00031", data_save_path=tmp)
        b = cfg.batch_size
        require((cfg.solver_type, cfg.dlogp_quad_points, cfg.divergence, cfg.atol, cfg.rtol,
                 cfg.n_steps, cfg.steps_per_dispatch, b) == ("dopri5", 0, "exact", 1e-5, 1e-5,
                                                              100, 0, 12),
                "ambient_preset('00031') is the reference's route (dopri5, stage-coupled exact "
                "dlogp, atol = rtol = 1e-5, 100 save points, batch 12)")
        x0 = zero_com_x0(rng, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample_ambient(cfg, model, None, template, x0, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        files = sorted(os.listdir(tmp))
    nfe = out["nfe_per_chain"]
    log(f"[reference sampler, ambient_preset('00031') as it stands] {b} chains: {wall:.3f} s, "
        f"{b / wall:.4f} samples/s (host clock, {card}); NFE per chain min {int(nfe.min())} max "
        f"{int(nfe.max())} (mean {float(nfe.mean()):.1f}), {1e3 * wall / int(nfe.max()):.3f} ms "
        f"per evaluation of the slowest chain; all {out['samples'].shape[1]} save times reached "
        f"(t = 0, 1/99, ..., 1) by every chain; artifacts {files}")
    require(out["samples"].shape == (b, cfg.n_steps, N_ATOMS, 3), "reference sampler: shape")
    require(np.isfinite(out["samples"]).all() and np.isfinite(out["dlogps"]).all(),
            "reference sampler: finite samples and dlogp")
    require(len(files) == 4, f"reference sampler wrote its four artifacts: {files}")
    t0 = time.perf_counter()
    fine = make_ode_sampler(dense_of, solver="rk4", n_steps=REF_RK4_STEPS, n_save=2,
                            return_dlogp=True, divergence="exact", device="cuda")(x0,
                                                                                 ambient_temps(b))
    torch.cuda.synchronize()
    wall_fine = time.perf_counter() - t0
    s_err = float(np.abs(out["samples"][:, -1] - fine.xs[:, -1].cpu().numpy()).max())
    d_ref = fine.dlogp[:, -1].cpu().numpy()
    d_err = float(np.abs(out["dlogps"] - d_ref).max())
    log(f"[reference sampler] against stage-coupled RK4, {REF_RK4_STEPS} steps ({wall_fine:.3f} s): "
        f"samples "
        f"max abs err {s_err:.3e} (max |x| {float(np.abs(out['samples']).max()):.4f}), dlogp max "
        f"abs err {d_err:.3e} (max |dlogp| {float(np.abs(d_ref).max()):.4f}); bar rtol 1e-3 / "
        f"atol 1e-3, 100 x the solver's tolerance (tests/test_integrators.py holds dopri5 at "
        f"1e-7 to 2e-5 of fine RK4)")
    require(np.allclose(out["samples"][:, -1], fine.xs[:, -1].cpu().numpy(), rtol=1e-3, atol=1e-3),
            f"reference sampler: samples agree with RK4-{REF_RK4_STEPS} (rtol 1e-3, atol 1e-3)")
    require(np.allclose(out["dlogps"], d_ref, rtol=1e-3, atol=1e-3),
            f"reference sampler: dlogp agrees with RK4-{REF_RK4_STEPS} (rtol 1e-3, atol 1e-3)")

    # (b) bench.py's reference shape: Euler steps as pure RHS evaluations over the edge form
    edge_of = molecular_v_fn_of(model, None, template, impl="edge", device="cuda")
    x0, temps = zero_com_x0(rng, 12), ambient_temps(12)
    xt, tt = torch.as_tensor(x0, device="cuda"), torch.as_tensor(temps, device="cuda")
    with torch.no_grad():
        v_edge, v_dense = edge_of(tt)(xt, 0.5), dense_of(tt)(xt, 0.5)
    v_err = (v_edge - v_dense).abs().max().item()
    require(bool(torch.allclose(v_edge, v_dense, rtol=2e-3, atol=2e-4)),
            f"edge-form velocity agrees with the dense form (rtol 2e-3, atol 2e-4): {v_err:.3e}")
    kw = dict(solver="euler", n_steps=REF_SHAPE_STEPS, n_save=2, return_dlogp=True,
              divergence="exact", steps_per_dispatch=REF_SHAPE_STEPS, device="cuda")
    edge_s, dense_s = make_ode_sampler(edge_of, **kw), make_ode_sampler(dense_of, **kw)
    make_ode_sampler(edge_of, **dict(kw, n_steps=2))(x0, temps)  # warm-up, not timed
    walls = {}
    for name, sampler in (("edge", edge_s), ("dense", dense_s), ("dense", dense_s),
                          ("edge", edge_s)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = sampler(x0, temps)
        torch.cuda.synchronize()
        walls.setdefault(name, []).append(time.perf_counter() - t0)
        if name == "edge":
            edge_sol = sol
        else:
            dense_sol = sol
    t_eval = min(walls["edge"]) / REF_SHAPE_STEPS
    fmt = lambda ws: " and ".join(f"{1e3 * w / REF_SHAPE_STEPS:.3f}" for w in ws)
    log(f"[reference shape, bench.py:353-363] edge-form Euler, {REF_SHAPE_STEPS} steps, exact "
        f"dlogp, batch 12: "
        f"ms per evaluation, in turns, edge {fmt(walls['edge'])}, dense {fmt(walls['dense'])} "
        f"(host clock, {card}); priced at REF_NFE = 500: {12.0 / (500 * t_eval):.4f} samples/s; "
        f"edge velocity against dense max abs err {v_err:.3e}")
    d_ref = dense_sol.dlogp[:, -1]
    d_atol = 1e-3 * d_ref.abs().max().item()
    require(bool(torch.isfinite(edge_sol.xs).all() and torch.isfinite(edge_sol.dlogp).all()),
            "edge-form sampler: finite")
    require(bool(torch.allclose(edge_sol.xs, dense_sol.xs, rtol=1e-4, atol=1e-5)),
            "edge-form sampler: samples agree with the dense form (rtol 1e-4, atol 1e-5)")
    require(bool(torch.allclose(edge_sol.dlogp, dense_sol.dlogp, rtol=1e-3, atol=d_atol)),
            "edge-form sampler: dlogp agrees with the dense form (rtol 1e-3, atol 1e-3 max|dlogp|)")

    # (c) stage-coupled RK4 through B4 and B5
    n_steps = 8
    kw = dict(solver="rk4", n_steps=n_steps, return_dlogp=True, divergence="exact",
              device="cuda")
    fused_s = make_ode_sampler(
        molecular_v_fn_of(model, None, template, impl="dense_fused", device="cuda"), **kw)
    dense_s = make_ode_sampler(dense_of, **kw)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out_f = fused_s(x0, temps)
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    routes = {key: n for key, n in _build.ROUTE_LAUNCHES.items() if n}
    t0 = time.perf_counter()
    out_d = dense_s(x0, temps)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    # every evaluation: the velocity and the JVPs' primal (one B4 a layer
    # each) and the 57 lanes at once (one B5 a layer); 4 stages a step
    evals = 4 * n_steps
    want = {k: 0 for k in launches}
    want.update(fused_edge_mlp=2 * evals * LAYERS, fused_edge_mlp_jvp=evals * LAYERS)
    s_err = (out_f.xs - out_d.xs).abs().max().item()
    d_ref = out_d.dlogp[:, -1]
    d_err = (out_f.dlogp[:, -1] - d_ref).abs().max().item()
    log(f"[stage-coupled RK4 dense_fused B=12] {n_steps} steps, {evals} evaluations: "
        f"{wall_f:.3f} s (dense: {wall_d:.3f} s; host clock, {card}); samples max abs err "
        f"{s_err:.3e}, dlogp max abs err {d_err:.3e} (max |dlogp| {d_ref.abs().max().item():.4f}); "
        f"launches {launches}, B4 and B5 by library "
        f"{ {f'{k}:{lib}': n for (k, lib), n in routes.items()} }")
    require(launches == want, f"stage-coupled dense_fused launch counts {launches} == {want}")
    require(routes == {("fused_edge_mlp", "fused_edge_mlp_tf32x3"): want["fused_edge_mlp"],
                       ("fused_edge_mlp_jvp", "fused_edge_mlp_jvp_tf32x3"): want["fused_edge_mlp_jvp"]},
            f"every B4 launch of the stage-coupled sampler comes from fused_edge_mlp_tf32x3.cu "
            f"and every B5 launch from fused_edge_mlp_jvp_tf32x3.cu: {routes}")
    require(bool(torch.isfinite(out_f.xs).all() and torch.isfinite(out_f.dlogp).all()),
            "stage-coupled dense_fused: finite")
    require(bool(torch.allclose(out_f.xs, out_d.xs, rtol=1e-4, atol=1e-5)),
            "stage-coupled dense_fused: samples agree with dense (rtol 1e-4, atol 1e-5)")
    require(bool(torch.allclose(out_f.dlogp, out_d.dlogp, rtol=1e-3,
                                atol=1e-3 * d_ref.abs().max().item())),
            "stage-coupled dense_fused: dlogp agrees with dense (rtol 1e-3, atol 1e-3 max|dlogp|)")
    return launches


TRAIN_CHAINS = 128  # the trained field's fast_profile batch


def phase_training(card: str) -> None:
    """12. Ambient training on the card, at the 00031 width (T0s = T1s =
    [1000, 300], frames from ``make_synthetic_frames``): (a) one update's
    loss and gradients on the card against the CPU from the same weights
    (``torch_default_weights_``), batch, t and z, in edge f32 at batch 12 (loss rtol 1e-5; gradients rtol
    1e-4 with atol 1e-5 of each leaf's largest |gradient|, TF32 off) and in
    dense bf16_agg at batch 64 (loss and the whole gradient within 2e-2 of
    the CPU's); (b) ~20 timed update steps (CUDA events after warm-up) of
    edge f32 at batch 12, dense f32 and dense bf16_agg at batch 256 and
    grad_accum 4 x 256 in bf16_agg: ms a step, molecules/s, peak memory;
    (c) ``train_ambient`` for a few steps, its ``params`` through
    ``sample_ambient(fast_profile(ambient_preset("00031")))`` at 128 chains:
    B1 (f32) and B3 (bf16_agg) launch and samples and dlogp are finite.
    (c) starts from the flax-law weights a fresh model draws; (a) and (b)
    from the smoke's random field."""
    from ti_torch.config import ambient_preset, fast_profile
    from ti_torch.data.mdqm9 import (
        MDQM9AmbientDataset,
        make_synthetic_frames,
        make_synthetic_molecule,
    )
    from ti_torch.interpolants import linear
    from ti_torch.losses import molecular_velocity_loss
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops import _build
    from ti_torch.sampling.drivers import sample_ambient
    from ti_torch.train import common, train_ambient

    t_phase = time.perf_counter()
    mol = make_synthetic_molecule(N_ATOMS, seed=0)
    temps_grid = (1000, 300)
    base = dict(T0s=list(temps_grid), T1s=list(temps_grid), scale_trajs=False, use_wandb=False)
    cfg = ambient_preset("00031", **base)
    require((cfg.n_features, cfg.score_layers) == (F, LAYERS), "the 00031 width")
    interp = linear(a=cfg.a, gamma=cfg.gamma)
    frames = {T: make_synthetic_frames(mol, 1024, T, seed=T) for T in temps_grid}
    stack = np.concatenate([frames[T] for T in temps_grid])
    stack_t = np.concatenate([np.full(1024, float(T), np.float32) for T in temps_grid])
    ds = MDQM9AmbientDataset.from_arrays(stack, stack_t, mol)
    template = ds.template
    init = torch_default_weights_(CPaiNN(F, LAYERS, n_atoms=N_ATOMS))

    def model_on(device):
        m = CPaiNN(F, LAYERS, n_atoms=N_ATOMS)
        m.load_state_dict(init.state_dict())
        return m.to(device)

    # (a) one update's loss and gradients, card against CPU
    rng = np.random.default_rng(12)
    for impl, dtype, b in (("edge", "f32", 12), ("dense", "bf16_agg", CPU_DENSE_BATCH)):
        c = ambient_preset("00031", **base, train_impl=impl, train_compute_dtype=dtype)
        idx0, idx1 = rng.choice(len(stack), b), rng.choice(len(stack), b)
        batch = [stack[idx0], stack[idx1], np.stack([stack_t[idx0], stack_t[idx1]], -1),
                 rng.uniform(0.0, 1.0, b).astype(np.float32),
                 rng.standard_normal((b, N_ATOMS, 3)).astype(np.float32)]
        got = {}
        for dev in ("cuda", "cpu"):
            m = model_on(dev)
            params = dict(m.named_parameters())
            x0, x1, tp, t, z = (torch.from_numpy(a).to(dev) for a in batch)
            t0 = time.perf_counter()
            loss = molecular_velocity_loss(common.make_batched_apply(c, m, template), params,
                                           x0, x1, tp, interp, t=t, z=z)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            got[dev] = (loss.item(), {k: g.cpu() for k, g in grads.items()},
                        time.perf_counter() - t0)
        (lg, gg, sg), (lc, gc, sc) = got["cuda"], got["cpu"]
        loss_rel = abs(lg - lc) / abs(lc)
        if dtype == "f32":
            worst = max(((gg[k] - gc[k]).abs() - 1e-4 * gc[k].abs()).max().item()
                        / max(gc[k].abs().max().item(), 1e-30) for k in gc)
            log(f"[train step card vs CPU {impl} {dtype} B={b}] loss {lg:.7f} vs {lc:.7f} "
                f"(rel {loss_rel:.2e}, bar 1e-5); gradients: worst (|diff| - 1e-4 |cpu|) / leaf "
                f"max {worst:.2e} (bar 1e-5), {len(gc)} leaves; card {sg:.2f} s, CPU {sc:.2f} s")
            require(loss_rel <= 1e-5, f"train step {impl} f32: loss on the card agrees with the CPU")
            require(worst <= 1e-5, f"train step {impl} f32: gradients on the card agree with the CPU")
        else:
            flat_g = torch.cat([gg[k].ravel() for k in sorted(gc)])
            flat_c = torch.cat([gc[k].ravel() for k in sorted(gc)])
            rel = ((flat_g - flat_c).abs().max() / flat_c.abs().max()).item()
            log(f"[train step card vs CPU {impl} {dtype} B={b}] loss {lg:.6f} vs {lc:.6f} "
                f"(rel {loss_rel:.2e}, bar 2e-2); gradient max |diff| / max |cpu| {rel:.2e} "
                f"(bar 2e-2); card {sg:.2f} s, CPU {sc:.2f} s")
            require(loss_rel <= 2e-2 and rel <= 2e-2,
                    f"train step {impl} {dtype}: loss and gradient on the card agree with the CPU")
        require(all(torch.isfinite(g).all() for g in gg.values()), "finite gradients on the card")

    # (b) timed update steps on the card
    steps, warm = 20, 3
    for impl, dtype, b, accum in (("edge", "f32", 12, 1), ("dense", "f32", 256, 1),
                                  ("dense", "bf16_agg", 256, 1), ("dense", "bf16_agg", 256, 4)):
        c = ambient_preset("00031", **base, train_impl=impl, train_compute_dtype=dtype)
        m = model_on("cuda")
        params = dict(m.named_parameters())
        apply = common.make_batched_apply(c, m, template)
        opt = common.make_optimizer(list(params.values()), 1e-4)
        gen = torch.Generator(device="cuda").manual_seed(0)
        step = common.make_update_step(
            lambda g, x0, x1, tp: molecular_velocity_loss(apply, params, x0, x1, tp, interp,
                                                          generator=g), opt, accum_steps=accum)
        x0s, T0 = ds.epoch_batches(torch.Generator().manual_seed(1), b * accum, device="cuda")
        x1s, T1 = ds.epoch_batches(torch.Generator().manual_seed(2), b * accum, device="cuda")
        tps = torch.stack([T0, T1], -1)
        nb = len(x0s)
        before = {k: p.detach().clone() for k, p in params.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [step(gen, x0s[i % nb], x1s[i % nb], tps[i % nb]) for i in range(warm)]
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses += [step(gen, x0s[i % nb], x1s[i % nb], tps[i % nb])
                   for i in range(warm, warm + steps)]
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / steps
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        moved = max((p.detach() - before[k]).abs().max().item() for k, p in params.items())
        name = f"{impl} {dtype} B={b}" + (f" x {accum} accumulated" if accum > 1 else "")
        log(f"[train steps {name}] {ms:.3f} ms a step, {b * accum / ms * 1e3:.1f} molecules/s, "
            f"peak memory {peak:.2f} GiB ({steps} steps after {warm}, CUDA events, one host sync "
            f"a step; {card}); losses {losses[warm]:.4f} .. {losses[-1]:.4f}; largest parameter "
            f"move {moved:.3e}")
        require(all(math.isfinite(v) for v in losses) and opt.nan_count == 0,
                f"train steps {name}: finite losses")
        require(moved > 0.0, f"train steps {name}: the parameters moved")
        del m, params, opt, step, x0s, x1s
        torch.cuda.empty_cache()

    # (c) the trainer's output runs the main path
    with tempfile.TemporaryDirectory() as tmp:
        small = MDQM9AmbientDataset.from_arrays(
            np.concatenate([frames[T][:48] for T in temps_grid]),
            np.concatenate([np.full(48, float(T), np.float32) for T in temps_grid]), mol)
        c = ambient_preset("00031", **base, n_epochs=2, model_save_path=tmp)
        t0 = time.perf_counter()
        res = train_ambient(c, small, small)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        n_steps = c.n_epochs * (len(small) // c.batch_size)
        require(all(p.is_cuda for p in res["params"].values()), "train_ambient ran on the card")
        require(sorted(os.listdir(os.path.join(tmp, c.model_save_name)))
                == sorted(["settings.json"] + [f"{c.model_save_name}_{e}_weights.npz"
                                               for e in ("0", "1", "best0", "best1")]),
                "train_ambient wrote its checkpoints")
        cfg_s = fast_profile(ambient_preset("00031"), data_save_path=tmp)
        x0 = make_synthetic_frames(mol, TRAIN_CHAINS, 1000, seed=999)
        sample_ambient(cfg_s, res["model"], res["params"], template, x0, save=False,
                       batch_size=TRAIN_CHAINS, device="cuda")  # warm-up, not counted
        torch.cuda.synchronize()
        _build.reset_launches()
        out = sample_ambient(cfg_s, res["model"], res["params"], template, x0, save=False,
                             batch_size=TRAIN_CHAINS, device="cuda")
        torch.cuda.synchronize()
        routes = {k: n for k, n in _build.ROUTE_LAUNCHES.items() if n}
    log(f"[trained field] train_ambient: {n_steps} steps of batch {c.batch_size} ({c.train_impl} "
        f"{c.train_compute_dtype}) in {t_train:.2f} s, losses {res['history']['train_loss']}; "
        f"fast_profile at {TRAIN_CHAINS} chains launches by library "
        f"{ {f'{k}:{lib}': n for (k, lib), n in routes.items()} }; dlogp mean "
        f"{out['dlogps'].mean():.4f}")
    require(routes.get(("pair_layer", "pair_layer_tf32x3"), 0) > 0
            and routes.get(("pair_tangent", "pair_tangent_mma"), 0) > 0,
            f"the trained field's main path launches B1 (f32) and B3 (bf16_agg): {routes}")
    require(np.isfinite(out["samples"]).all() and np.isfinite(out["dlogps"]).all(),
            "the trained field's main path: finite samples and dlogp")
    log(f"[phase 12] {time.perf_counter() - t_phase:.1f} s")


LATENT_CHAINS, LATENT_CMP = 256, 64  # latent_preset's batch; the plain-version comparison's
# the published latent profile (bf16, exact divergence as 57 lanes at once)
# needs 0.031 + 0.3233 GiB a chain at a node (tools/latent_memory_probe.py):
# 82.8 GiB at 256 chains. At 224 (72.5 GiB) it ran out of memory after the
# earlier phases (13.2 GiB of the allocator's cache reserved but unallocated),
# so it runs at 160 (51.8 GiB)
PUBLISHED_LATENT_CHAINS = 160
# phase 13(e): 64 chains (cut from 128 for the smoke's time), 16 RK4
# steps, Simpson-9 and GL-8 over t in [0, 0.25].
# Along this random field's trajectories the divergence has kinks (the norms of
# equivariant features that pass near zero), which no rule of 8-9 nodes
# resolves: the rules are held to themselves recomputed through B3, and their
# gap to stage-coupled RK4 is reported
QUAD_CHAINS, QUAD_STEPS, QUAD_POINTS, QUAD_T1 = 64, 16, 9, 0.25


def counted(fn):
    """Run ``fn`` with the launch counts set to 0 just before and read just
    after: (its result, host seconds to the synchronise, launches by
    (kernel, library))."""
    from ti_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, {k: n for k, n in _build.ROUTE_LAUNCHES.items() if n}


def by_lib(routes) -> dict:
    return {f"{k}:{lib}": n for (k, lib), n in routes.items()}


def well_frames(n: int, T: float, seed: int) -> np.ndarray:
    """Exact Boltzmann samples of the origin-centred isotropic well the
    latent oracles use (sigma_T = 0.25 sqrt(T/300)), centre of mass removed."""
    f = 0.25 * math.sqrt(T / 300.0) * np.random.default_rng(seed).standard_normal(
        (n, N_ATOMS, 3))
    return (f - f.mean(axis=1, keepdims=True)).astype(np.float32)


def latent_noise(b: int, seed: int) -> np.ndarray:
    z = np.random.default_rng(seed).standard_normal((b, N_ATOMS, 3)).astype(np.float32)
    return z - z.mean(axis=1, keepdims=True)


def phase_latent(ambient_model, card: str) -> None:
    """13. The latent family at the 00031 width (19 atoms, F = 128, 5
    layers), on origin-centred harmonic wells:
    (a) the latent kernel route, ``fast_profile(latent_preset("00031",
        Ts=[300]), family="latent", compute_dtype="f32",
        traj_forward_impl="pair_kernel", div_forward_impl="pair_tangent")``,
        through ``sample_latent`` at 256 chains (RK4-64, GL-8, the exact
        divergence as B3's full orthogonal frame): 1,440 B1 launches from
        pair_layer_tf32x3 and 40 B3 from pair_tangent_tf32x3, samples/s, the
        noise COM-free and everything finite; on 64 of those chains against
        the same sampler built from the plain versions: dlogp at phase 4's
        bar, the samples (72 RK4 steps carry f32 rounding past phase 4's
        bar on this field) no farther from the f64 trajectory than twice the
        plain route's;
    (b) the published latent profile (``fast_profile(..., family="latent")``
        as it stands: bf16, the dense forward, no kernel) at
        PUBLISHED_LATENT_CHAINS chains, its peak memory and samples/s, and
        the multi-temperature preset ``latent_preset("00031")``
        (conditioning "latent") at its batch of 10;
    (c) ``train_latent`` on the card: one update's loss and gradients
        against the CPU (edge f32 at batch 12, phase 12's bars), 16 steps of
        the trainer, then its field through route (a) at 256 chains;
    (d) the BG→TI composition: a generator for T0 = 1000 K on route (a) at
        128 chains, its samples through ``sample_ambient`` under
        ``fast_profile(ambient_preset("00031"))`` with the noise and dlogp
        passed through (180 B1, 40 B3), and ``calc_importance_weights``;
    (e) Simpson-9 and the unsegmented GL-8 sampler at 64 chains in f32
        (``impl="dense_fused"``: B4, B5) over t in [0, 0.25], each against
        its rule recomputed by hand from B3's full frame at its nodes (phase
        4's bars), and beside stage-coupled RK4-16 with the exact divergence
        in every stage (the gap reported; Simpson's trajectory equal to it).
    Phases (a), (b), (d) and (e) run on ``torch_default_weights_``; (c)
    trains from flax's initialisation."""
    from ti_torch.analysis.weights import calc_ess, calc_importance_weights
    from ti_torch.config import ambient_preset, fast_profile, latent_preset
    from ti_torch.data.mdqm9 import MDQM9LatentDataset, graph_template, make_synthetic_molecule
    from ti_torch.interpolants import one_sided_linear
    from ti_torch.losses import molecular_velocity_loss
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops.pair_layer_kernel import pair_kernel_drift
    from ti_torch.ops.pair_tangent_kernel import pair_tangent_div_fn
    from ti_torch.sampling.drivers import (
        make_ode_sampler,
        molecular_v_fn_of,
        sample_ambient,
        sample_latent,
    )
    from ti_torch.sampling.integrators import (
        gauss_dlogp_schedule,
        sample_ode,
        sample_ode_times,
        simpson_dlogp,
    )
    from ti_torch.train import common, train_latent
    from ti_torch.train.latent import build_latent_model

    t_phase = time.perf_counter()
    mol = make_synthetic_molecule(N_ATOMS, seed=0)
    tpl = {k: graph_template(mol, t_cond=k) for k in (0, 1, 2)}

    def kernel_route(Ts, **over):
        return fast_profile(latent_preset("00031", Ts=Ts, **over), family="latent",
                            compute_dtype="f32", traj_forward_impl="pair_kernel",
                            div_forward_impl="pair_tangent")

    def route_launches(cfg, batches=1):
        """B1 and B3 launches of ``batches`` batches on the segmented Gauss
        path: (1 + GL) gaps of m RK steps, GL nodes, one launch a layer."""
        gl = cfg.dlogp_quad_points
        m = min(-(-cfg.n_steps // (gl + 1)), cfg.steps_per_dispatch)
        return (batches * (gl + 1) * m * {"rk4": 4}[cfg.solver_type] * LAYERS,
                batches * gl * LAYERS)

    # (a) the latent kernel route
    cfg = kernel_route([300])
    require((cfg.batch_size, cfg.n_steps, cfg.dlogp_quad, cfg.dlogp_quad_points, cfg.divergence,
             cfg.n_features, cfg.score_layers) == (LATENT_CHAINS, 64, "gauss", 8, "exact", F, LAYERS),
            "the latent kernel route at the 00031 width")
    n_b1, n_b3 = route_launches(cfg)
    require((n_b1, n_b3) == (1440, 40), f"1,440 B1 and 40 B3 launches a batch: {(n_b1, n_b3)}")
    want = {("pair_layer", "pair_layer_tf32x3"): n_b1, ("pair_tangent", "pair_tangent_tf32x3"): n_b3}
    model = torch_default_weights_(build_latent_model(cfg, N_ATOMS))
    noise = latent_noise(LATENT_CHAINS, seed=3)
    small = sample_latent(cfg, model, None, tpl[0], noise=noise[:LATENT_CMP], save=False,
                          batch_size=LATENT_CMP, device="cuda")  # also the warm-up
    out, secs, routes = counted(lambda: sample_latent(cfg, model, None, tpl[0], noise=noise,
                                                      save=False, device="cuda"))
    drift = float(np.abs(out["samples"][:, -1].mean(axis=1)).max())
    log(f"[latent kernel route] {LATENT_CHAINS} chains in {secs:.3f} s, "
        f"{LATENT_CHAINS / secs:.3f} samples/s (host clock, {card}); launches by library "
        f"{by_lib(routes)}; dlogp mean {out['dlogps'].mean():.4f}; largest |centre of mass| of "
        f"a generated sample {drift:.3e} (the field is not COM-preserving)")
    require(routes == want, f"every B1 launch of the latent route from pair_layer_tf32x3 and "
            f"every B3 launch from pair_tangent_tf32x3: {routes}")
    require(out["samples"].shape == (LATENT_CHAINS, 2, N_ATOMS, 3)
            and np.isfinite(out["samples"]).all() and np.isfinite(out["dlogps"]).all(),
            "latent kernel route: shapes and finite samples and dlogp")
    require(np.array_equal(out["samples"][:, 0], noise)
            and float(np.abs(noise.mean(axis=1)).max()) < 1e-6,
            "latent kernel route: the samples start at the COM-free noise")
    plain = make_ode_sampler(
        molecular_v_fn_of(model, None, tpl[0], device="cuda"), solver=cfg.solver_type,
        n_steps=cfg.n_steps, n_save=2, divergence="exact",
        steps_per_dispatch=cfg.steps_per_dispatch, dlogp_quad_points=cfg.dlogp_quad_points,
        dlogp_quad="gauss",
        traj_drift=pair_kernel_drift(model, None, tpl[0], device="cuda", kernel=False),
        div_drift=pair_tangent_div_fn(model, None, tpl[0], num_probes=3 * N_ATOMS,
                                      probe_mode="orthogonal", device="cuda", kernel=False),
        device="cuda")
    t0 = time.perf_counter()
    ref = plain(noise[:LATENT_CMP], torch.zeros(LATENT_CMP, 0, device="cuda"),
                torch.Generator(device="cuda").manual_seed(0))
    t_plain = time.perf_counter() - t0
    ref_s, ref_d = ref.xs.cpu().numpy(), ref.dlogp[:, -1].cpu().numpy()
    s_err = float(np.max(np.abs(small["samples"] - ref_s)))
    d_err = float(np.max(np.abs(small["dlogps"] - ref_d)))
    # 72 RK4 steps carry f32 rounding far on this field (its velocity has kinks
    # where the norms of equivariant features pass near zero): the samples of
    # both f32 routes are held to the same trajectory in f64 (the edge form),
    # the kernel route no farther from it than twice the plain route is
    gl = cfg.dlogp_quad_points
    bounds = np.concatenate([[0.0], 0.5 * (np.polynomial.legendre.leggauss(gl)[0] + 1.0), [1.0]])
    steps = n_b1 // ((gl + 1) * 4 * LAYERS)  # RK4 steps a gap
    v64 = molecular_v_fn_of(copy.deepcopy(model).double(), None, tpl[0], impl="edge",
                            device="cuda")(torch.zeros(LATENT_CMP, 0, dtype=torch.float64,
                                                       device="cuda"))
    x64 = torch.as_tensor(noise[:LATENT_CMP], dtype=torch.float64, device="cuda")
    with torch.no_grad():
        for a, b in zip(bounds[:-1], bounds[1:]):
            x64 = sample_ode(v64, x64, t0=float(a), t1=float(b), n_steps=steps).xs[:, -1]
    x64 = x64.cpu().numpy()
    k_err = float(np.abs(small["samples"][:, -1] - x64).max())
    p_err = float(np.abs(ref_s[:, -1] - x64).max())
    log(f"[latent kernel route] {LATENT_CMP} chains against the plain versions ({t_plain:.2f} s): "
        f"samples max abs err {s_err:.3e}, dlogp max abs err {d_err:.3e} (max |dlogp| "
        f"{np.abs(ref_d).max():.4f}); final samples against the f64 trajectory: kernel route "
        f"{k_err:.3e}, plain route {p_err:.3e} (max |x| {np.abs(x64).max():.3f})")
    require(k_err <= 2.0 * p_err,
            "latent kernel route: samples as close to the f64 trajectory as the plain route's")
    require(np.allclose(small["dlogps"], ref_d, rtol=1e-3, atol=1e-3 * np.abs(ref_d).max()),
            "latent kernel route: dlogp agrees with the plain versions (rtol 1e-3, atol 1e-3 "
            "max|dlogp|)")

    # (b) the published profile, and the multi-temperature preset
    cfg_pub = fast_profile(latent_preset("00031", Ts=[300]), family="latent")
    require((cfg_pub.compute_dtype, cfg_pub.traj_forward_impl, cfg_pub.div_forward_impl,
             cfg_pub.divergence) == ("bf16", "default", "default", "exact"),
            "the published latent profile")
    b = PUBLISHED_LATENT_CHAINS
    sample_latent(cfg_pub, model, None, tpl[0], noise=noise[:16], save=False, batch_size=16,
                  device="cuda")  # warm-up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pub, secs, routes = counted(lambda: sample_latent(cfg_pub, model, None, tpl[0],
                                                      noise=noise[:b], save=False, batch_size=b,
                                                      device="cuda"))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    diff = pub["dlogps"] - out["dlogps"][:b]
    log(f"[latent published profile] {b} chains (bf16, exact divergence, dense forward) in "
        f"{secs:.3f} s, {b / secs:.3f} samples/s, peak memory {peak:.2f} GiB (host clock, "
        f"{card}); launches {by_lib(routes)}; dlogp minus route (a)'s: mean {diff.mean():.4f}, "
        f"max |.| {np.abs(diff).max():.4f}")
    require(not routes, f"the published latent profile runs no kernel: {routes}")
    require(np.isfinite(pub["samples"]).all() and np.isfinite(pub["dlogps"]).all(),
            "published latent profile: finite samples and dlogp")
    cfg_all = fast_profile(latent_preset("00031"), family="latent")
    model_all = torch_default_weights_(build_latent_model(cfg_all, N_ATOMS), seed=2)
    require((cfg_all.batch_size, model_all.conditioning, len(cfg_all.T)) == (10, "latent", 8),
            "the multi-temperature latent preset")
    sample_latent(cfg_all, model_all, None, tpl[1], n_samples=10, save=False, device="cuda")
    allt, secs, routes = counted(lambda: sample_latent(cfg_all, model_all, None, tpl[1],
                                                       n_samples=10, save=False, device="cuda"))
    log(f"[latent all temperatures] 10 chains at {cfg_all.sampling_T} K (conditioning latent, "
        f"bf16) in {secs:.3f} s, {10 / secs:.3f} samples/s ({card}); launches {by_lib(routes)}")
    require(np.isfinite(allt["samples"]).all() and np.isfinite(allt["dlogps"]).all(),
            "multi-temperature latent preset: finite samples and dlogp")

    # (c) latent training on the card
    frames = well_frames(96, 300, seed=5)
    ds = MDQM9LatentDataset.from_arrays(frames, np.full(96, 300.0), mol, t_cond=0)
    x0s, x1s, _ = ds.epoch_batches(torch.Generator().manual_seed(0), 12)
    t = torch.from_numpy(np.random.default_rng(13).uniform(0.0, 1.0, 12).astype(np.float32))
    c_edge = latent_preset("00031", Ts=[300], train_impl="edge", train_compute_dtype="f32")
    init = torch_default_weights_(build_latent_model(c_edge, N_ATOMS)).state_dict()
    got = {}
    for dev in ("cuda", "cpu"):
        m = build_latent_model(c_edge, N_ATOMS)
        m.load_state_dict(init)
        m.to(dev)
        params = dict(m.named_parameters())
        t0 = time.perf_counter()
        loss = molecular_velocity_loss(common.make_batched_apply(c_edge, m, tpl[0]), params,
                                       x0s[0].to(dev), x1s[0].to(dev),
                                       torch.zeros(12, 0, device=dev), one_sided_linear(),
                                       t=t.to(dev))
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        got[dev] = (loss.item(), {k: g.cpu() for k, g in grads.items()},
                    time.perf_counter() - t0)
    (lg, gg, sg), (lc, gc, sc) = got["cuda"], got["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    worst = max(((gg[k] - gc[k]).abs() - 1e-4 * gc[k].abs()).max().item()
                / max(gc[k].abs().max().item(), 1e-30) for k in gc)
    log(f"[latent train step card vs CPU edge f32 B=12] loss {lg:.7f} vs {lc:.7f} (rel "
        f"{loss_rel:.2e}, bar 1e-5); gradients: worst (|diff| - 1e-4 |cpu|) / leaf max "
        f"{worst:.2e} (bar 1e-5), {len(gc)} leaves; card {sg:.2f} s, CPU {sc:.2f} s")
    require(loss_rel <= 1e-5 and worst <= 1e-5,
            "latent train step: loss and gradients on the card agree with the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        c = latent_preset("00031", Ts=[300], batch_size=12, n_epochs=2, scale_trajs=False,
                          model_save_path=tmp, use_wandb=False)
        res, t_train, _ = counted(lambda: train_latent(c, ds))
        require(all(p.is_cuda for p in res["params"].values()), "train_latent ran on the card")
        require(sorted(os.listdir(os.path.join(tmp, c.model_save_name)))
                == sorted(["settings.json"] + [f"{c.model_save_name}_{e}.npz" for e in (0, 1)]),
                "train_latent wrote its checkpoints")
    n_steps = res["state"].count
    require(n_steps == 16 and res["state"].nan_count == 0, f"16 finite steps: {n_steps}")
    trained, secs, routes = counted(lambda: sample_latent(cfg, res["model"], res["params"],
                                                          tpl[0], noise=noise, save=False,
                                                          device="cuda"))
    log(f"[latent trained field] train_latent: {n_steps} steps of batch 12 (edge f32) in "
        f"{t_train:.2f} s, losses {res['history']['train_loss']}; route (a) at {LATENT_CHAINS} "
        f"chains in {secs:.3f} s, launches {by_lib(routes)}; dlogp mean "
        f"{trained['dlogps'].mean():.4f}")
    require(routes == want, f"the trained field's latent route launches B1 and B3: {routes}")
    require(np.isfinite(trained["samples"]).all() and np.isfinite(trained["dlogps"]).all(),
            "the trained field's latent route: finite samples and dlogp")

    # (d) the BG→TI composition: generator at T0 = 1000 K, then ambient 1000 -> 300 K
    cfg_bg = kernel_route([1000], sampling_T=1000)
    model_bg = torch_default_weights_(build_latent_model(cfg_bg, N_ATOMS), seed=1)
    lat, secs_bg, routes = counted(lambda: sample_latent(cfg_bg, model_bg, None, tpl[0],
                                                         n_samples=TRAIN_CHAINS,
                                                         batch_size=TRAIN_CHAINS, save=False,
                                                         device="cuda"))
    require(routes == want, f"the generator at 1000 K runs route (a): {routes}")
    z, x0, dlogp_bg = lat["samples"][:, 0], lat["samples"][:, -1], lat["dlogps"]
    cfg_amb = fast_profile(ambient_preset("00031"))
    require((cfg_amb.sampling_T0, cfg_amb.sampling_T1) == (1000, 300), "ambient 1000 -> 300 K")
    with tempfile.TemporaryDirectory() as tmp:
        cfg_amb.data_save_path = tmp
        amb, secs_ti, routes = counted(lambda: sample_ambient(
            cfg_amb, ambient_model, None, tpl[2], x0, latent_z=z, latent_dlogp=dlogp_bg,
            batch_size=TRAIN_CHAINS, device="cuda"))
        saved_z = np.load(os.path.join(tmp, f"latent_noises_{cfg_amb.data_save_name}.npy"))
    require(routes == {("pair_layer", "pair_layer_tf32x3"): 180,
                       ("pair_tangent", "pair_tangent_mma"): 40},
            f"the TI stage launches 180 B1 and 40 B3 (bf16_agg): {routes}")
    require(np.array_equal(amb["latent_noises"], z) and np.array_equal(saved_z, z)
            and np.array_equal(amb["latent_dlogps"], dlogp_bg)
            and np.array_equal(amb["samples"][:, 0], x0),
            "the latent noise, dlogp and samples pass through the ambient stage unchanged")
    # the weights as tests/test_bg_ti_composition.py forms them (reduced
    # energies drawn about 5): the random fields have no target to reweight to
    E1 = np.random.default_rng(0).normal(5.0, 0.2, len(z))
    w = calc_importance_weights(amb["latent_noises"], E1, neg_dlogps_bg=amb["latent_dlogps"],
                                neg_dlogps_ti=amb["dlogps"])
    log_w = -E1 + 0.5 * np.sum(z.astype(np.float64) ** 2, axis=(1, 2)) \
        + 0.5 * z[0].size * np.log(2 * np.pi) - dlogp_bg - amb["dlogps"]
    log(f"[BG→TI] generator {TRAIN_CHAINS} chains at 1000 K in {secs_bg:.3f} s, ambient "
        f"1000 -> 300 K in {secs_ti:.3f} s ({card}); launches {by_lib(routes)}; log-weights "
        f"{log_w.min():.2f} .. {log_w.max():.2f}, ESS {calc_ess(w):.3f} of {len(w)}")
    require(np.all(np.isfinite(w)) and np.all(w > 0), "BG→TI: finite, positive weights")
    require(np.allclose(np.log(w), log_w, rtol=1e-6, atol=1e-4),  # f32 noise and dlogps
            "BG→TI: the analysis layer's weights combine both dlogps")

    # (e) Simpson and the unsegmented Gauss sampler: each against its own rule
    # recomputed from B3's full frame at its nodes, and beside stage-coupled RK4
    v_of = molecular_v_fn_of(model, None, tpl[0], impl="dense_fused", device="cuda")
    x0q, temps0 = noise[:QUAD_CHAINS], torch.zeros(QUAD_CHAINS, 0, device="cuda")
    quads = {}
    simpson = f"Simpson-{QUAD_POINTS}"
    for name, over in (("stage-coupled RK4", {}), (simpson, dict(dlogp_quad_points=QUAD_POINTS)),
                       ("GL-8 unsegmented", dict(dlogp_quad="gauss", dlogp_quad_points=8))):
        sampler = make_ode_sampler(v_of, solver="rk4", n_steps=QUAD_STEPS, n_save=2, t1=QUAD_T1,
                                   divergence="exact", device="cuda", **over)
        sol, secs, routes = counted(lambda: sampler(x0q, temps0))
        quads[name] = (sol.xs.cpu().numpy(), sol.dlogp[:, -1].cpu().numpy())
        log(f"[quadrature {name}] {QUAD_CHAINS} chains, {QUAD_STEPS} RK4 steps over t in "
            f"[0, {QUAD_T1}], f32 (dense_fused): {secs:.3f} s, nfe {sol.nfe}; launches "
            f"{by_lib(routes)}")
        require(set(routes) == {("fused_edge_mlp", "fused_edge_mlp_tf32x3"),
                                ("fused_edge_mlp_jvp", "fused_edge_mlp_jvp_tf32x3")},
                f"{name}: B4 and B5 on the tensor cores: {routes}")
        require(np.isfinite(quads[name][0]).all() and np.isfinite(quads[name][1]).all(),
                f"{name}: finite")
    # the rules by hand: the trajectory at the nodes, the divergence there from
    # B3's full orthogonal frame (f32, an independent route), the weights
    v = v_of(temps0)
    x0t = torch.as_tensor(x0q, device="cuda")
    frame = pair_tangent_div_fn(model, None, tpl[0], num_probes=3 * N_ATOMS,
                                probe_mode="orthogonal", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        grid = sample_ode(v, x0t, t1=QUAD_T1, n_steps=QUAD_STEPS, n_save=QUAD_POINTS).xs
        ts = np.linspace(0.0, QUAD_T1, QUAD_POINTS)
        divs = torch.stack([frame(grid[:, k], float(ts[k]), temps0, gen)
                            for k in range(QUAD_POINTS)], dim=1)
        by_hand = {simpson: simpson_dlogp(divs, 0.0, QUAD_T1, 2)[:, -1]}
        ts, node_idx, node_w, _ = gauss_dlogp_schedule(0.0, QUAD_T1, QUAD_STEPS, 8, 2)
        states = sample_ode_times(v, x0t, ts)
        divs = torch.stack([frame(states[:, k], float(ts[k]), temps0, gen)
                            for k in node_idx[0]], dim=1)
        by_hand["GL-8 unsegmented"] = -(divs * torch.as_tensor(node_w[0], device="cuda")).sum(1)
    ref_x, ref_d = quads["stage-coupled RK4"]
    for name, hand in by_hand.items():
        xs, d = quads[name]
        hand = hand.cpu().numpy()
        err = float(np.abs(d - hand).max())
        gap = d - ref_d
        log(f"[quadrature {name}] dlogp against its rule by hand through B3's frame: max abs err "
            f"{err:.3e} (max |dlogp| {np.abs(hand).max():.3f}); against stage-coupled RK4-"
            f"{QUAD_STEPS}: mean {gap.mean():.4f}, max |.| {np.abs(gap).max():.4f}, relative "
            f"{np.abs(gap).max() / np.abs(ref_d).max():.2e}; final samples max abs diff "
            f"{np.abs(xs[:, -1] - ref_x[:, -1]).max():.3e}")
        require(np.allclose(d, hand, rtol=1e-3, atol=1e-3 * np.abs(hand).max()),
                f"{name}: dlogp is its quadrature rule (rtol 1e-3, atol 1e-3 max|dlogp|)")
    require(np.allclose(quads[simpson][0], ref_x, rtol=1e-5, atol=1e-6),
            "Simpson's trajectory is stage-coupled RK4's (same steps, rtol 1e-5 / atol 1e-6)")
    log(f"[phase 13] {time.perf_counter() - t_phase:.1f} s")


# chains of phase 14's card-against-CPU transport comparison (cut from 256: the
# CPU's dopri5 on 256 chains took 45.8 s on a slow host; dopri5 steps each
# chain on its own clock, so the first chains' results do not depend on the batch)
ADW_CMP = 64


def adw_step_check(cfg, init, batch, dtype_name: str) -> dict:
    """One ADW update (loss, gradients, optimizer step) from the same
    weights, batch, t and z on the card and on the CPU; returns each
    device's (loss, gradients, the step's largest weight move, seconds)."""
    from ti_torch.models.mlp import param_dtype
    from ti_torch.train import build_adw_model, common, make_adw_loss

    c = copy.copy(cfg)
    c.dtype = dtype_name
    got = {}
    for dev in ("cuda", "cpu"):
        m = build_adw_model(c)
        m.load_state_dict({k: v.to(param_dtype(dtype_name)) for k, v in init.items()})
        m.to(dev)
        params = dict(m.named_parameters())
        x0, x1, b0, b1, t, z = (torch.as_tensor(a, dtype=param_dtype(dtype_name), device=dev)
                                for a in batch)
        loss = make_adw_loss(c, m, params)

        def loss_fn(gen, *args):
            return loss(gen, *args, t=t, z=z)

        opt = common.make_optimizer(list(params.values()), c.lr, weight_decay=c.wd)
        t0 = time.perf_counter()
        value = loss_fn(None, x0, x1, b0, b1)
        grads = torch.autograd.grad(value, list(params.values()))
        common.make_update_step(loss_fn, opt)(None, x0, x1, b0, b1)
        moved = max((p.detach().cpu() - init[k].to(p.dtype)).abs().max().item()
                    for k, p in params.items())
        got[dev] = (value.item(), {k: g.cpu() for k, g in zip(params, grads)}, moved,
                    time.perf_counter() - t0)
    return got


def adw_step_ms(cfg, dtype_name: str, x0s, x1s, b0s, b1s, steps: int = 50, warm: int = 5):
    """ms an update step of ``train_adw``'s loop on the card (CUDA events
    over ``steps`` steps after ``warm``): (ms, losses, largest move)."""
    from ti_torch.models.mlp import param_dtype
    from ti_torch.train import build_adw_model, common, make_adw_loss

    c = copy.copy(cfg)
    c.dtype = dtype_name
    dt = param_dtype(dtype_name)
    m = build_adw_model(c, generator=torch.Generator().manual_seed(0)).to("cuda")
    params = dict(m.named_parameters())
    opt = common.make_optimizer(list(params.values()), c.lr, weight_decay=c.wd, clip=1.0)
    step = common.make_update_step(make_adw_loss(c, m, params), opt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = [a.to(dt) for a in (x0s, x1s, b0s, b1s)]
    nb = len(batches[0])
    before = {k: p.detach().clone() for k, p in params.items()}
    losses = [step(gen, *(a[i % nb] for a in batches)) for i in range(warm)]
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    losses += [step(gen, *(a[i % nb] for a in batches)) for i in range(warm, warm + steps)]
    end.record()
    torch.cuda.synchronize()
    moved = max((p.detach() - before[k]).abs().max().item() for k, p in params.items())
    require(all(math.isfinite(v) for v in losses) and opt.nan_count == 0,
            f"ADW {dtype_name} steps: finite losses")
    require(moved > 0.0, f"ADW {dtype_name} steps: the parameters moved")
    return start.elapsed_time(end) / steps, losses, moved


def phase_adw(card: str) -> None:
    """14. The ADW family at the published width (``ADWConfig`` defaults:
    ``FCNetMultiBeta`` 5 x 256, batch 512, 300k samples, beta 1.0 -> 1.25),
    plain PyTorch (the JAX package's ADW path reaches no Pallas kernel):
    (a) ``make_synthetic_adw_csv`` at beta in {1.0, 1.25}, 300k samples each;
    (b) ms an update step from CUDA events in f32 and in f64; one update's
        loss and gradients on the card against the CPU from the same
        weights, batch, t and z (f32 at phase 12's bars: loss rtol 1e-5,
        gradients rtol 1e-4 with atol 1e-5 of each leaf's largest; f64 at
        1e-10), and its optimizer step moving the weights; two epochs of
        ``train_adw`` on the card in f32 (its checkpoints, finite losses);
    (c) ``sample_adw`` of the 30,000-chain test split with the trained field
        on the production route (RK4-64, GL-8 dlogp, the unsegmented Gauss
        sampler) and on the default dopri5 (the exact divergence in every
        stage, atol = rtol = 1e-4, 400 save points): samples/s and NFE, no
        kernel launched; the first 64 chains against the CPU on the same
        weights (samples rtol 1e-4 / atol 1e-5, dlogp rtol 1e-3 / atol 1e-5);
    (d) ``reweighted_gedmd_spectrum`` (50 bootstraps) of both routes'
        output: finite eigenvalues."""
    from ti_torch.analysis.reweight import reweighted_gedmd_spectrum
    from ti_torch.config import ADWConfig
    from ti_torch.data.adw import ADWDataset, make_synthetic_adw_csv
    from ti_torch.ops import _build
    from ti_torch.sampling.drivers import sample_adw
    from ti_torch.train import build_adw_model, train_adw

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the dataset
        t0 = time.perf_counter()
        cfg = ADWConfig(traj_path=tmp, model_save_path=os.path.join(tmp, "models"),
                        data_save_path=os.path.join(tmp, "out"), use_wandb=False)
        require((cfg.hidden_size, cfg.num_layers, cfg.batch_size, cfg.n_samples)
                == (256, 5, 512, 300_000), "ADWConfig's published defaults")
        csv = make_synthetic_adw_csv(os.path.join(tmp, cfg.traj_filename),
                                     betas=cfg.beta0s + cfg.beta1s, n_samples=cfg.n_samples)
        base = ADWDataset.from_csv(csv, cfg.beta0s, cfg.n_samples, seed=cfg.seed)
        target = ADWDataset.from_csv(csv, cfg.beta1s, cfg.n_samples, seed=cfg.seed)
        train0, _, test0 = base.splits()
        train1, _, _ = target.splits()
        log(f"[ADW data] {cfg.n_samples} samples at beta {cfg.beta0s + cfg.beta1s}: train "
            f"{len(train0)}, test {len(test0)}; {time.perf_counter() - t0:.1f} s")

        # (b) update steps: timed, and card against CPU in f32 and f64
        g = torch.Generator().manual_seed(0)
        x0s, b0s = train0.epoch_batches(g, cfg.batch_size, device="cuda")
        x1s, b1s = train1.epoch_batches(g, cfg.batch_size, device="cuda")
        step_ms = {}
        for name in ("f32", "f64"):
            ms, losses, moved = adw_step_ms(cfg, name, x0s, x1s, b0s, b1s)
            step_ms[name] = ms
            log(f"[ADW train steps {name} B={cfg.batch_size}] {ms:.3f} ms a step, "
                f"{cfg.batch_size / ms * 1e3:.0f} samples/s (50 steps after 5, CUDA events, one "
                f"host sync a step; {card}); losses {losses[5]:.4f} .. {losses[-1]:.4f}; largest "
                f"parameter move {moved:.3e}")
        rng = np.random.default_rng(14)
        b = cfg.batch_size
        i0, i1 = rng.choice(len(train0), b), rng.choice(len(train1), b)
        batch = [train0.x[i0], train1.x[i1], train0.beta[i0], train1.beta[i1],
                 rng.uniform(0.0, 1.0, (b, 1)), rng.standard_normal((b, 1))]
        init = build_adw_model(cfg, generator=torch.Generator().manual_seed(1)).state_dict()
        # bars: loss rtol, gradient rtol, gradient atol (of the leaf's largest)
        for name, bar in (("f32", (1e-5, 1e-4, 1e-5)), ("f64", (1e-10, 1e-10, 1e-10))):
            got = adw_step_check(cfg, init, batch, name)
            (lg, gg, moved_g, sg), (lc, gc, moved_c, sc) = got["cuda"], got["cpu"]
            loss_rel = abs(lg - lc) / abs(lc)
            worst = max(((gg[k] - gc[k]).abs() - bar[1] * gc[k].abs()).max().item()
                        / max(gc[k].abs().max().item(), 1e-30) for k in gc)
            log(f"[ADW train step card vs CPU {name} B={b}] loss {lg:.9f} vs {lc:.9f} (rel "
                f"{loss_rel:.2e}, bar {bar[0]:.0e}); gradients: worst (|diff| - {bar[1]:.0e} "
                f"|cpu|) / leaf max {worst:.2e} (bar {bar[2]:.0e}); the step's largest weight move "
                f"{moved_g:.3e} (CPU {moved_c:.3e}, lr {cfg.lr:g}); card {sg:.2f} s, CPU "
                f"{sc:.2f} s")
            require(loss_rel <= bar[0], f"ADW step {name}: loss on the card agrees with the CPU")
            require(worst <= bar[2], f"ADW step {name}: gradients on the card agree with the CPU")
            require(moved_g > 0.0 and moved_c > 0.0, f"ADW step {name}: the step moved the weights")
            require(all(t.dtype == (torch.float64 if name == "f64" else torch.float32)
                        for t in gg.values()), f"ADW step {name}: gradients in {name}")

        c = copy.copy(cfg)
        c.epochs = 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_adw(c, base, target)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        n_steps = c.epochs * (len(train0) // c.batch_size)
        require(all(p.is_cuda for p in res["params"].values()), "train_adw ran on the card")
        require(res["state"].count == n_steps and res["state"].nan_count == 0,
                f"train_adw took {n_steps} steps without a NaN")
        require(all(np.isfinite(v).all() for v in res["history"].values()),
                "train_adw: finite losses")
        require(sorted(os.listdir(os.path.join(c.model_save_path, c.model_save_name)))
                == ["epoch_0.npz", "epoch_1.npz", "settings.json"], "train_adw's checkpoints")
        log(f"[ADW train_adw f32] {c.epochs} epochs, {n_steps} steps of {c.batch_size} in "
            f"{t_train:.2f} s (host clock, with validation, data staging and checkpoints: "
            f"{t_train / n_steps * 1e3:.3f} ms a step; {card}); train loss "
            f"{res['history']['train_loss']}, val loss {res['history']['val_loss']}")

        # (c) transport of the test split, card against CPU
        x0 = test0.x
        beta0 = test0.beta.reshape(-1)
        cpu_params = {k: v.cpu() for k, v in res["params"].items()}
        outs = {}
        for route, kw in (("RK4-64 GL-8", dict(solver_type="rk4", n_step=64, dlogp_quad_points=8,
                                                dlogp_quad="gauss")),
                          ("dopri5", {})):
            rc = copy.copy(cfg)
            for k, v in kw.items():
                setattr(rc, k, v)
            sample_adw(rc, res["model"], res["params"], x0[:ADW_CMP], beta0[:ADW_CMP],
                       save=False, device="cuda")  # warm-up
            out, secs, routes = counted(lambda: sample_adw(rc, res["model"], res["params"], x0,
                                                           beta0, save=True, device="cuda"))
            require(not routes, f"ADW {route}: the path reaches no kernel: {routes}")
            n_save = rc.n_step if rc.solver_type == "dopri5" else 2
            require(out["samples"].shape == out["dlogps"].shape == (n_save, len(x0)),
                    f"ADW {route}: (n_save, n) outputs")
            require(np.isfinite(out["samples"]).all() and np.isfinite(out["dlogps"]).all(),
                    f"ADW {route}: finite samples and dlogp")
            t0 = time.perf_counter()
            ref = sample_adw(rc, build_adw_model(rc), cpu_params, x0[:ADW_CMP], beta0[:ADW_CMP],
                             save=False, device="cpu")
            t_cpu = time.perf_counter() - t0
            ds = np.abs(out["samples"][:, :ADW_CMP] - ref["samples"])
            dd = np.abs(out["dlogps"][:, :ADW_CMP] - ref["dlogps"])
            ok_s = np.all(ds <= 1e-5 + 1e-4 * np.abs(ref["samples"]))
            ok_d = np.all(dd <= 1e-5 + 1e-3 * np.abs(ref["dlogps"]))
            log(f"[ADW sample_adw {route}] {len(x0)} chains in {secs:.3f} s, "
                f"{len(x0) / secs:.1f} samples/s (host clock, {card}), NFE {out['nfe']} (CPU "
                f"{ref['nfe']} at {ADW_CMP}), {n_save} save points; first {ADW_CMP} chains "
                f"against the CPU ({t_cpu:.2f} s): samples max abs {ds.max():.3e} (rtol 1e-4 / "
                f"atol 1e-5: {ok_s}), dlogp max abs {dd.max():.3e} (rtol 1e-3 / atol 1e-5: "
                f"{ok_d}); final dlogp mean {out['dlogps'][-1].mean():.5f}")
            require(ok_s, f"ADW {route}: samples on the card agree with the CPU")
            require(ok_d, f"ADW {route}: dlogp on the card agrees with the CPU")
            outs[route] = out
        saved = os.path.join(cfg.data_save_path, cfg.model_save_name,
                             f"beta_{cfg.beta0s[0]}_to_{float(cfg.beta1s[0])}")
        require(sorted(os.listdir(saved)) == [f"{k}_epoch_-1.npy" for k in
                                              ("dlogps", "initial_samples", "samples")],
                f"sample_adw wrote its arrays: {os.listdir(saved)}")

        # (d) the reweighted gEDMD spectrum
        for route, out in outs.items():
            t0 = time.perf_counter()
            spec = reweighted_gedmd_spectrum(out["initial_samples"], out["samples"],
                                             out["dlogps"], float(cfg.beta1s[0]), n_bootstrap=50)
            ev = spec["eigenvalues_mean"]
            log(f"[ADW gEDMD {route}] negated eigenvalues {np.real(ev)} (95% "
                f"{np.real(spec['lower_bound'])} .. {np.real(spec['upper_bound'])}), "
                f"{spec['n_filtered']} weights filtered, {time.perf_counter() - t0:.2f} s")
            require(np.isfinite(ev).all() and np.isfinite(spec["lower_bound"]).all()
                    and np.isfinite(spec["upper_bound"]).all(),
                    f"ADW gEDMD {route}: finite eigenvalues")
    log(f"[phase 14] {time.perf_counter() - t_phase:.1f} s")


def phase_10506(rows_kernels, card: str) -> dict:
    """15. The large molecule's fast profile (10506: 29 atoms, F = 256 x 5
    layers, ``fast_profile(ambient_preset("10506"))``: RK4-16, GL-8,
    Hutchinson-32 Rademacher, bf16_agg, B1 in bf16_agg on the trajectory,
    the default divergence forward at the nodes). B1 at F = 256
    (pair_layer_mma_f256) against its plain version at 16 and 128 chains,
    timed, and B2 = B1 to the bit; ``sample_ambient`` at 16 chains for two
    batches (every B1 launch from pair_layer_mma_f256, samples/s), its first
    layer against the plain version on its own inputs, its drift and the
    first batch's samples against the plain routes' in bf16_agg and f32;
    ``sample_molecular_sde`` at 512 chains, 20 steps, bf16_agg. Returns the
    sampler's launch counts."""
    from ti_torch.config import ambient_preset, fast_profile
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops import _build
    from ti_torch.ops.pair_layer_kernel import (
        embed,
        pack_layer,
        pair_kernel_drift,
        pair_layer,
        pair_layer_plain,
        prepare,
        with_mma_weights,
    )
    from ti_torch.ops.divergence import value_and_divergence
    from ti_torch.sampling.drivers import (
        make_ode_sampler,
        molecular_v_fn_of,
        sample_ambient,
        sample_molecular_sde,
    )

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = fast_profile(ambient_preset("10506"))
    n, f, layers, b = 29, cfg.n_features, cfg.score_layers, 16
    require((f, layers, cfg.traj_forward_impl, cfg.div_forward_impl, cfg.compute_dtype,
             cfg.num_probes, cfg.probe_mode, cfg.n_steps)
            == (256, LAYERS, "pair_kernel_bf16", "default", "bf16_agg", 32, "rademacher", 16),
            "fast_profile at 10506")
    model = torch_default_weights_(CPaiNN(f, layers, n_atoms=n))
    params = {k: t.detach() for k, t in model.state_dict().items()}
    bf = torch.bfloat16
    w = with_mma_weights(pack_layer(params, 0, f, bf, "cuda"))
    g = torch.Generator(device="cuda").manual_seed(11)
    ms, plain_ms, errs = {}, {}, {}
    for chains in (b, 128):
        def rnd(*shape, scale=1.0):
            return (scale * torch.randn(*shape, generator=g, device="cuda")).to(bf)

        x = 0.3 * torch.randn(chains, n, 3, generator=g, device="cuda")
        base = (x, rnd(chains, n, f), rnd(chains, 3, n, f, scale=0.3), rnd(chains, n * n, f))
        out = pair_layer(*base, w, LENGTH_SCALE)
        torch.cuda.synchronize()
        require(_build.ROUTES["pair_layer"] == "pair_layer_mma_f256",
                "bf16_agg at F = 256 launches pair_layer_mma_f256")
        errs[chains] = compare(out, pair_layer_plain(*base, w, LENGTH_SCALE), bf,
                               f"B1 pair_layer bf16_agg F={f} N={n} B={chains}")
        for c in (1, 2, 4):
            again = pair_layer(*base, w, LENGTH_SCALE, c)
            torch.cuda.synchronize()
            require(all(torch.equal(a, q) for a, q in zip(again, out)),
                    f"F = {f}: B2 at chain_block {c} gives B1's outputs to the bit")
        ms[chains] = [cuda_ms(lambda: pair_layer(*base, w, LENGTH_SCALE), 50, warm=5)
                      for _ in range(2)]
        plain_ms[chains] = cuda_ms(lambda: pair_layer_plain(*base, w, LENGTH_SCALE), 5)
        rows = chains * n * n
        flops = 2.0 * 15 * f * f * rows
        bnd, by = bound_ms(flops, H100_BF16, nbytes(*base, w.mats, w.vecs, *out))
        log(f"[B1 bf16_agg F={f} N={n} B={chains}] mma.sync bf16 (pair_layer_mma_f256, one "
            f"64-row tile a CTA of 16 warps) {' and '.join(f'{t:.4f}' for t in ms[chains])} ms "
            f"per launch (50 launches a reading); plain {plain_ms[chains]:.4f} ms; bound "
            f"{bnd:.4f} ms ({by}, {flops:.4e} FLOP at 989 TFLOP/s bf16, "
            f"{nbytes(*base, w.mats, w.vecs, *out) / 1e6:.2f} MB), at "
            f"{min(ms[chains]) / bnd:.2f}x its bound ({card})")
        if chains == b:
            rows_kernels["pair_layer_bf16_agg_f256"] = dict(
                err=errs[chains], ms=min(ms[chains]), plain=plain_ms[chains], bound=bnd, by=by)
        del x, base, out, again
    del w
    torch.cuda.empty_cache()

    # the profile through its entry point: a warm-up batch, then two counted
    template = graph_template(make_synthetic_molecule(n, seed=0), t_cond=2)
    rng = np.random.default_rng(5)
    x0 = zero_com_x0(rng, 2 * b, n)
    sample_ambient(cfg, model, None, template, x0[:b], save=False, batch_size=b,
                   device="cuda")  # warm-up, not counted
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = sample_ambient(cfg, model, None, template, x0, save=False, batch_size=b, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    by_route = {k: v for k, v in _build.ROUTE_LAUNCHES.items() if v}
    gaps = 1 + cfg.dlogp_quad_points  # GL-8: 9 trajectory gaps of 2 RK4 steps each
    steps = -(-cfg.n_steps // gaps)
    want = {k: 0 for k in launches}
    want["pair_layer"] = 2 * gaps * steps * 4 * layers
    log(f"[10506 fast_profile] {len(x0)} chains in 2 batches of {b}: {wall:.3f} s, "
        f"{len(x0) / wall:.3f} samples/s (host clock, {card}); launches by library "
        f"{ {f'{k}:{lib}': v for (k, lib), v in by_route.items()} }")
    require(launches == want, f"10506 launch counts {launches} == {want}")
    require(by_route == {("pair_layer", "pair_layer_mma_f256"): want["pair_layer"]},
            f"every B1 launch of the 10506 profile comes from pair_layer_mma_f256: {by_route}")
    require(out["samples"].shape == (len(x0), 2, n, 3) and out["dlogps"].shape == (len(x0),),
            "10506: output shapes")
    require(np.isfinite(out["samples"]).all() and np.isfinite(out["dlogps"]).all(),
            "10506: finite samples and dlogp")
    # the path's first layer on its own inputs (the first batch's x0, the
    # embeddings at t = 0, v = 0), kernel against plain at the bar; then the
    # path's drift through 5 layers on the first batch's states at t = 0 and
    # at its samples at t = 1: each layer's rounding feeds the next, so the
    # kernel's drift is held to the plain f32 drift no farther than twice the
    # plain bf16_agg drift is
    temps = np.tile(np.array([cfg.sampling_T0, cfg.sampling_T1], np.float32), (b, 1))
    conds = torch.as_tensor(temps, device="cuda")
    pm = prepare(model, None, template, "bf16_agg", "cuda")
    xs = torch.as_tensor(x0[:b], device="cuda")
    s0, e0 = embed(pm, torch.zeros(b, device="cuda"), conds, n)
    args = (xs, s0.contiguous(), torch.zeros((b, 3, n, f), dtype=bf, device="cuda"), e0,
            pm.layers[0], model.length_scale)
    compare(pair_layer(*args), pair_layer_plain(*args), bf,
            "10506 B1 layer 0 on the path's inputs, kernel against plain")
    drifts = {k: pair_kernel_drift(model, None, template, compute_dtype=cd, device="cuda",
                                   kernel=k == "kernel")
              for k, cd in (("kernel", "bf16_agg"), ("plain", "bf16_agg"), ("f32", None))}
    with torch.no_grad():
        for t, xs in ((0.0, x0[:b]), (1.0, out["samples"][:b, -1])):
            xs = torch.as_tensor(xs, device="cuda")
            got = {k: d(xs, t, conds) for k, d in drifts.items()}
            scale = got["f32"].abs().max().item()
            rel = {k: (got[k] - got["f32"]).abs().max().item() / scale for k in ("kernel", "plain")}
            kp = (got["kernel"] - got["plain"]).abs().max().item() / got["plain"].abs().max().item()
            log(f"[10506 drift t={t:g}] max |. - f32 plain| / max |f32 plain|: kernel {rel['kernel']:.3e}, "
                f"plain bf16_agg {rel['plain']:.3e}; kernel against plain bf16_agg {kp:.3e}")
            require(all(bool(torch.isfinite(v).all()) for v in got.values())
                    and rel["kernel"] <= 2.0 * rel["plain"],
                    f"10506 drift at t={t:g}: the kernel no farther from f32 than twice the plain "
                    "bf16_agg drift")
        # where a batch's time goes: its 72 trajectory forwards (5 B1 launches
        # and the plain glue each) and its 8 divergence nodes (the plain dense
        # forward under 32 Rademacher JVP lanes)
        v = molecular_v_fn_of(model, None, template, compute_dtype="bf16_agg", device="cuda")(conds)
        gen = torch.Generator(device="cuda").manual_seed(0)
        fwd_ms = cuda_ms(lambda: drifts["kernel"](xs, 0.5, conds), 10, warm=2)
        node_ms = cuda_ms(lambda: value_and_divergence(
            lambda y: v(y, 0.5), xs, mode="hutchinson", generator=gen, num_probes=cfg.num_probes,
            probe_mode=cfg.probe_mode), 3, warm=1)
    n_fwd = gaps * steps * 4
    log(f"[10506 batch split B={b}] a trajectory forward {fwd_ms:.3f} ms ({layers} B1 launches x "
        f"{min(ms[b]):.4f} ms = {layers * min(ms[b]):.3f} ms of it), a divergence node "
        f"{node_ms:.3f} ms; {n_fwd} forwards + {cfg.dlogp_quad_points} nodes = "
        f"{(n_fwd * fwd_ms + cfg.dlogp_quad_points * node_ms) / 1e3:.3f} s of the batch's "
        f"{wall / 2:.3f} s ({card})")
    del pm, args, drifts, got, v
    # the first batch against the same sampler with B1's plain version on the
    # trajectory, in bf16_agg and in f32 (the same generator seed: the same
    # probes at the nodes). Along 18 RK4 steps of this field a rounding
    # grows past the bf16_agg bar, so the kernel route is held to the f32
    # route no farther than twice the plain bf16_agg route is
    def plain_route(dtype):
        return make_ode_sampler(
            molecular_v_fn_of(model, None, template, compute_dtype=dtype, device="cuda"),
            solver=cfg.solver_type, n_steps=cfg.n_steps, n_save=2, divergence=cfg.divergence,
            steps_per_dispatch=cfg.steps_per_dispatch, dlogp_quad_points=cfg.dlogp_quad_points,
            dlogp_quad="gauss", num_probes=cfg.num_probes, probe_mode=cfg.probe_mode,
            traj_drift=pair_kernel_drift(model, None, template, compute_dtype=dtype,
                                         device="cuda", kernel=False),
            device="cuda",
        )(x0[:b], temps, torch.Generator(device="cuda").manual_seed(int(cfg.seed)))

    ref, ref32 = plain_route("bf16_agg"), plain_route(None)
    ref_x, ref_d = ref.xs.cpu().numpy(), ref.dlogp[:, -1].cpu().numpy()
    x32 = ref32.xs.cpu().numpy()
    x_err = float(np.max(np.abs(out["samples"][:b] - ref_x)))
    x_rel = x_err / float(np.max(np.abs(ref_x)))
    d_err = float(np.max(np.abs(out["dlogps"][:b] - ref_d)))
    k32 = float(np.max(np.abs(out["samples"][:b] - x32)))
    p32 = float(np.max(np.abs(ref_x - x32)))
    log(f"[10506 fast_profile] first batch: samples of the kernel route minus the plain "
        f"bf16_agg route's max abs {x_err:.3e} (max err / max |plain| {x_rel:.3e}); from the "
        f"plain f32 route's: kernel {k32:.3e}, plain bf16_agg {p32:.3e}; dlogp minus the plain "
        f"bf16_agg route's max abs {d_err:.3e} (max |dlogp| {np.max(np.abs(ref_d)):.4f}); dlogp "
        f"mean {out['dlogps'].mean():.5f}")
    require(k32 <= 2.0 * p32, "10506: the kernel route's samples lie no farther from the f32 "
            "route's than twice the plain bf16_agg route's")
    del ref, ref32
    torch.cuda.empty_cache()

    # the SDE at the same width, bf16_agg, B1 (chain_block 1)
    sde_b = 512
    sample_molecular_sde(model, None, template, zero_com_x0(rng, sde_b, n), ambient_temps(sde_b),
                         torch.Generator(device="cuda").manual_seed(0), g_fn=0.1, n_steps=1,
                         n_save=2, forward_impl="pair_kernel", compute_dtype="bf16_agg",
                         device="cuda")  # warm-up, not counted
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    xs = sample_molecular_sde(model, None, template, zero_com_x0(rng, sde_b, n),
                              ambient_temps(sde_b), torch.Generator(device="cuda").manual_seed(1),
                              g_fn=0.1, n_steps=SDE_STEPS, n_save=2, forward_impl="pair_kernel",
                              compute_dtype="bf16_agg", device="cuda")
    torch.cuda.synchronize()
    wall_sde = time.perf_counter() - t0
    sde_routes = {k: v for k, v in _build.ROUTE_LAUNCHES.items() if v}
    log(f"[10506 SDE bf16_agg] {sde_b} chains, {SDE_STEPS} Euler-Maruyama steps, g=0.1: "
        f"{wall_sde:.3f} s, {sde_b / wall_sde:.3f} samples/s (host clock, {card}); launches by "
        f"library { {f'{k}:{lib}': v for (k, lib), v in sde_routes.items()} }")
    require(sde_routes == {("pair_layer", "pair_layer_mma_f256"): SDE_STEPS * layers},
            f"every B1 launch of the 10506 SDE comes from pair_layer_mma_f256: {sde_routes}")
    require(xs.shape == (sde_b, 2, n, 3) and bool(torch.isfinite(xs).all()),
            "10506 SDE: finite samples of the expected shape")
    log(f"[10506] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def wrapped(a):
    """Angle differences folded into (-pi, pi]."""
    return (a + np.pi) % (2 * np.pi) - np.pi


def harmonic_energy(x: np.ndarray, T: float, p_eq: np.ndarray, jitter: float = WELL_JITTER):
    """Reduced energy of the isotropic well ``make_synthetic_frames`` draws
    from (sigma_T = jitter sqrt(T/300) about the equilibrium geometry,
    centre of mass removed): tools/torch_ambient_oracle.py's stand-in for
    the OpenMM stage, which the card's machine does not have. In float64,
    as the OpenMM stage writes them: the report's weights exp(-phi) and
    their squares underflow in float32."""
    from ti_torch.analysis.oracles import well_energy, well_sigma

    return well_energy(np.asarray(x, dtype=np.float64), well_sigma(T, jitter), p_eq)


def nerf_check(n: int, conformations: int, device: str, card: str) -> None:
    """Phase 16(d): the z-matrices of ``conformations`` frames of a
    synthetic n-atom molecule on ``device``: construct -> deconstruct ->
    construct within 1e-4 (torsions modulo 2 pi), the NeRF loop's log|det J|
    against ``compute_jacobian_batch``'s closed form within 1e-3, every
    z-matrix valid; each call's time (CUDA events). The frames are
    ``make_synthetic_frames``' (bond angles 0.2-3.12 rad at 29 atoms):
    arccos near 0 or pi turns a rounding of the cosine into sqrt(2 ulp) ~
    3e-4 of angle, in the port as in ti_tpu."""
    from ti_torch.analysis.sort_atoms import (
        adjacency_from_bonds,
        compute_atom_order_and_references_groups,
    )
    from ti_torch.analysis.zmatrix import (
        compute_jacobian_batch,
        construct_z_matrix,
        deconstruct_z_matrix,
        valid_z_mask,
    )
    from ti_torch.data.mdqm9 import make_synthetic_frames, make_synthetic_molecule

    mol = make_synthetic_molecule(n, seed=0)
    order, _, refs = compute_atom_order_and_references_groups(
        adjacency_from_bonds(n, mol.bond_index))
    x = torch.as_tensor(make_synthetic_frames(mol, conformations, 300.0, seed=3)[:, order],
                        device=device)
    z = construct_z_matrix(x, refs)
    cart, logdet = deconstruct_z_matrix(z, refs)
    again = construct_z_matrix(cart, refs)
    err = (again - z).abs()
    err[..., 2] = wrapped(again[..., 2] - z[..., 2]).abs()
    closed = compute_jacobian_batch(z, refs)
    ld_err = float((logdet - closed).abs().max())
    ms = {name: cuda_ms(fn, 5) for name, fn in (
        ("construct", lambda: construct_z_matrix(x, refs)),
        ("deconstruct", lambda: deconstruct_z_matrix(z, refs)),
        ("closed form", lambda: compute_jacobian_batch(z, refs)))}
    log(f"[16d NeRF {n} atoms x {conformations} on {device}] round trip max err {float(err.max()):.3e} "
        f"(lengths {float(err[..., 0].max()):.3e}, angles {float(err[..., 1].max()):.3e}, "
        f"torsions {float(err[..., 2].max()):.3e}); log|det J| loop minus closed form max "
        f"{ld_err:.3e} (|log det| up to {float(logdet.abs().max()):.2f}); ms a call: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" ({card})")
    require(cart.shape == (conformations, n, 3) and bool(torch.isfinite(cart).all()),
            "NeRF: finite cartesians")
    require(bool(valid_z_mask(z).all()), "NeRF: every z-matrix valid")
    require(float(err.max()) <= 1e-4, "NeRF: construct -> deconstruct -> construct within 1e-4")
    require(ld_err <= 1e-3, "NeRF: the loop's log|det J| within 1e-3 of the closed form")


def analysis_report(samples, dlogps, T0: float, T1: float, device: str, card: str, tmp: str):
    """Phase 16(b) and (c): the harmonic stand-in energies and 1,024
    MD-reference frames at T0 and at T1, then ``generate_full_report``
    (k = 100, 1,000 bootstraps) with its z-matrices on ``device``, saved to
    ``tmp``, against the same report with them on the CPU: the saved names
    are ``ANALYSIS_ARTIFACTS``, every array finite, each ESS in [1, n] of
    the weights left after the IQR filter, the marginals at atol 1e-4 /
    rtol 1e-5 (torsions modulo 2 pi), ΔF, ESS and weights to 1e-12
    relative. Returns the seconds of (b) and (c)."""
    from ti_torch.analysis import results
    from ti_torch.analysis.sort_atoms import adjacency_from_bonds
    from ti_torch.data.mdqm9 import make_synthetic_frames, make_synthetic_molecule

    n = len(samples)
    t0 = time.perf_counter()
    mol = make_synthetic_molecule(N_ATOMS, seed=0)
    adj = adjacency_from_bonds(N_ATOMS, mol.bond_index)
    p_eq = (mol.positions - mol.positions.mean(axis=0)).astype(np.float32)
    x_0, x_1 = samples[:, 0], samples[:, -1]
    src = results.MDTISource(x0s=x_0, x1s=x_1, E0s=harmonic_energy(x_0, T0, p_eq),
                             E1s=harmonic_energy(x_1, T1, p_eq), neg_dlogps_ti=dlogps)
    md_T0 = make_synthetic_frames(mol, 1024, T0, seed=1, jitter=WELL_JITTER)
    md_T1 = make_synthetic_frames(mol, 1024, T1, seed=2, jitter=WELL_JITTER)
    secs_b = time.perf_counter() - t0
    require(np.isfinite(src.E0s).all() and np.isfinite(src.E1s).all(), "finite energies")
    log(f"[16b energies] harmonic stand-in at {T0:g} K and {T1:g} K, MD references 1024 + "
        f"1024 frames: {secs_b:.3f} s")

    kw = dict(md_ti=src, md_T0=md_T0, md_T1=md_T1, k=100.0, n_bootstrap=1000)
    saved = os.path.join(tmp, "report")
    t0 = time.perf_counter()
    rep = results.generate_full_report(adj, save_path=saved, device=device, **kw)
    secs_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep_cpu = results.generate_full_report(adj, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    names = sorted(f[:-4] for f in os.listdir(saved))
    require(names == sorted(ANALYSIS_ARTIFACTS), f"report artifacts {names}")
    require(all(np.isfinite(np.load(os.path.join(saved, f"{m}.npy"))).all() for m in names),
            "every saved array is finite")
    kept = len(rep["weights_md_ti"])
    ess = np.array([rep["ess_md_ti_percentage"], *rep["ess_md_ti_ci_percentage"]]) * n / 100
    require(bool(np.all((ess >= 1 - 1e-9) & (ess <= kept + 1e-9))),
            f"ESS {ess} in [1, {kept}] (the weights left after the IQR filter)")
    worst = {}
    for key in rep:
        if key.startswith(("torsions", "bond_angles", "bond_lengths")):
            a, b = rep[key], rep_cpu[key]
            d = np.abs(wrapped(a - b) if key.startswith("torsions") else a - b)
            worst[key] = float(d.max())
            require(a.shape == b.shape and bool(np.all(d <= 1e-4 + 1e-5 * np.abs(b))),
                    f"{key} on the card equals the CPU's (atol 1e-4, rtol 1e-5)")
        else:
            a, b = (np.asarray(rep[key], np.float64).ravel(),
                    np.asarray(rep_cpu[key], np.float64).ravel())
            require(np.allclose(a, b, rtol=1e-12, atol=0), f"{key} equals the CPU run's")
    log(f"[16c report] generate_full_report (k = 100, 1000 bootstraps, z-matrices on {device}) "
        f"{secs_c:.3f} s, the same with device='cpu' {cpu_s:.3f} s; {len(names)} artifacts; "
        f"dF {rep['df_md_ti']:.5f} CI {rep['dF_md_ti_ci']}, ESS {rep['ess_md_ti_percentage']:.4f}% "
        f"of {n} ({kept} kept); marginals {device} minus CPU max {max(worst.values()):.3e} "
        f"({max(worst, key=worst.get)}) ({card})")
    return secs_b, secs_c


def analysis_kinetics(samples, T1: float, device: str) -> float:
    """Phase 16(e): ``torsion_generator_spectrum`` on the transported
    samples' torsions (z-matrices on ``device``) at T1 (p = 300, sigma = 5,
    nev = 4; 100 bootstraps, cut from the reference's 1,000) and a 2 x 2
    ``model_selection_scan`` with 5 test splits: finite and real, each
    bootstrap interval holding its mean. Returns its seconds."""
    from ti_torch.analysis import kinetics, results
    from ti_torch.analysis.sort_atoms import adjacency_from_bonds
    from ti_torch.data.mdqm9 import make_synthetic_molecule

    t0 = time.perf_counter()
    mol = make_synthetic_molecule(N_ATOMS, seed=0)
    adj = adjacency_from_bonds(N_ATOMS, mol.bond_index)
    X = results.gen_torsions(results.gen_z_matrix(adj, samples[:, -1], device)).T
    X = X.astype(np.float64)
    spec = kinetics.torsion_generator_spectrum(X, T1, p=300, sigma=5.0, nev=4, n_bootstrap=100,
                                               seed=0)
    scan = kinetics.model_selection_scan(X, 1.0 / spec["beta"], sigma_list=(1.0, 5.0),
                                         p_list=(50, 300), ntest=5, nev=4, seed=0)
    secs = time.perf_counter() - t0
    ev = [np.asarray(spec[k]) for k in ("eigenvalues_mean", "lower_bound", "upper_bound")]
    log(f"[16e kinetics] {X.shape[0]} torsions x {X.shape[1]} samples at {T1:g} K (p = 300, "
        f"sigma = 5, 100 bootstraps, cut from 1000): eigenvalues {ev[0]}, 95% [{ev[1]}, {ev[2]}]; "
        f"model selection 2 x 2 x 5: best (sigma, p) {kinetics.best_hyperparameters(scan)}, "
        f"mean VAMP {scan['VAMP'].mean(axis=-1).ravel()}; {secs:.3f} s")
    require(all(np.isrealobj(e) and np.isfinite(e).all() for e in ev), "finite real eigenvalues")
    require(bool(np.all((ev[1] <= ev[0]) & (ev[0] <= ev[2]))), "each interval holds its mean")
    require(np.isfinite(scan["EV"]).all() and np.isfinite(scan["VAMP"]).all(),
            "model selection: finite")
    return secs


def phase_analysis(model, template, card: str) -> None:
    """16. The analysis layer over the main path's transported samples, on
    the card: (a) ``sample_ambient(fast_profile(ambient_preset("00031")),
    save=True)`` at 2 batches of 128 chains of synthetic frames at 1000 K
    (360 B1 launches from pair_layer_tf32x3, 80 B3 from pair_tangent_mma),
    its ``samples_*`` and ``dlogps_*`` read back from disk; (b), (c) the
    report (``analysis_report``); (d) the NeRF at 29 atoms x 65,536
    conformations (``nerf_check``); (e) the kinetics (``analysis_kinetics``)."""
    from ti_torch.config import ambient_preset, fast_profile
    from ti_torch.data.mdqm9 import make_synthetic_frames, make_synthetic_molecule
    from ti_torch.sampling.drivers import sample_ambient

    t_phase = time.perf_counter()
    secs = {}
    cfg = fast_profile(ambient_preset("00031"))
    require((cfg.traj_forward_impl, cfg.div_forward_impl, cfg.num_probes, cfg.probe_mode)
            == ("pair_kernel", "pair_tangent_bf16", 16, "orthogonal"), "fast_profile route")
    T0, T1 = cfg.sampling_T0, cfg.sampling_T1
    n = 2 * CHAINS
    x0 = make_synthetic_frames(make_synthetic_molecule(N_ATOMS, seed=0), n, T0, seed=999,
                               jitter=WELL_JITTER)
    with tempfile.TemporaryDirectory() as tmp:
        cfg.data_save_path = tmp
        out, secs["a"], routes = counted(lambda: sample_ambient(
            cfg, model, None, template, x0, save=True, batch_size=CHAINS, device="cuda"))
        samples = np.load(os.path.join(tmp, f"samples_{cfg.data_save_name}.npy"))
        dlogps = np.load(os.path.join(tmp, f"dlogps_{cfg.data_save_name}.npy"))
        want = {("pair_layer", "pair_layer_tf32x3"): 2 * 180,
                ("pair_tangent", "pair_tangent_mma"): 2 * 40}
        log(f"[16a artifacts] sample_ambient(fast_profile(00031)) {n} chains in 2 batches of "
            f"{CHAINS}: {secs['a']:.3f} s, {n / secs['a']:.3f} samples/s; launches by library "
            f"{by_lib(routes)}; read back samples {samples.shape}, dlogps {dlogps.shape} ({card})")
        require(routes == want, f"phase 16 launch counts {routes} == {want}")
        require(np.array_equal(samples, out["samples"]) and np.array_equal(dlogps, out["dlogps"]),
                "the artifacts read back equal what sample_ambient returned")
        require(samples.shape == (n, 2, N_ATOMS, 3) and np.isfinite(samples).all()
                and np.isfinite(dlogps).all(), "finite artifacts of the expected shape")
        secs["b"], secs["c"] = analysis_report(samples, dlogps, T0, T1, "cuda", card, tmp)
    t0 = time.perf_counter()
    nerf_check(29, 65536, "cuda", card)
    secs["d"] = time.perf_counter() - t0
    secs["e"] = analysis_kinetics(samples, T1, "cuda")
    log(f"[16 analysis] " + ", ".join(f"({k}) {v:.3f} s" for k, v in secs.items())
        + f"; phase {time.perf_counter() - t_phase:.3f} s ({card})")


def b7_macs(c: int, n: int, layers: int) -> float:
    """Multiply-adds the function of kernel B7 needs for c chains: per chain
    and layer the primal message MLPs once (phi 8F² + w 7F² per pair row),
    per each of the 3N real lanes the w tangent (7F² per pair row) and from
    layer 1 on the phi tangent (8F²), and per lane and node the update
    tangent (d_vv, d_uv and the update MLP: 12F²)."""
    lanes = 3 * n
    pair = 15 * layers + lanes * (7 * layers + 8 * (layers - 1))
    return float(c * F * F * (pair * n * n + 12 * lanes * n * layers))


def b7_kernel_macs(c: int, n: int, layers: int, lanes: int) -> float:
    """Multiply-adds B7's f32-FMA kernel (csrc/div_kernel.cu, ``variant="fma"``)
    computes, counted on the N² real pair rows (not the tiles' padding to
    32) and L·N node rows of each (chain, chunk): per layer the primal fronts
    of phi and w once per chunk (5F²), the primal 5F products once per
    sub-block of 2 lanes (10F²), and per lane, the padded ones of the last
    chunk included, the tangents of ``b7_macs``."""
    n_chunks = -(-3 * n // lanes)
    pair = (5 + 10 * -(-lanes // 2)) * layers + lanes * (7 * layers + 8 * (layers - 1))
    return float(c * n_chunks * F * F * (pair * n * n + 12 * lanes * n * layers))


def b7_tc_kernel_macs(c: int, n: int, layers: int, lanes: int, chunks: int) -> float:
    """Multiply-adds B7 on the tensor cores (csrc/div_kernel_tf32x3.cu)
    computes at ``chunks`` (G) chunks a CTA, on the N² real pair rows (not
    the tiles' padding to 64) and N node rows of each lane: per CTA and layer
    the primal message MLPs once (15F² a pair row), per real lane (the 3N
    below the padding, which it skips) the tangents of ``b7_macs``."""
    n_chunks = -(-3 * n // lanes)
    groups = -(-n_chunks // chunks)
    pair = 15 * layers * groups + 3 * n * (7 * layers + 8 * (layers - 1))
    return float(c * F * F * (pair * n * n + 12 * 3 * n * n * layers))


def div_inputs(n: int, c: int, lanes: int, seed: int):
    """Kernel B7's packed inputs and stacks for c chains of an n-atom
    synthetic molecule (random weights and coordinates from the seed)."""
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.models.cpainn_dense import dense_edge_type_matrix
    from ti_torch.ops import div_kernel as dk

    model = torch_default_weights_(CPaiNN(F, LAYERS, n_atoms=n), seed)
    p = {k: w.detach().to("cuda") for k, w in model.state_dict().items()}
    template = graph_template(make_synthetic_molecule(n, seed=seed), t_cond=2)
    etype = torch.as_tensor(dense_edge_type_matrix(template.edges), device="cuda").long()
    x = 0.1 * np.random.default_rng(seed).standard_normal((c, n, 3))
    xs = torch.as_tensor(x - x.mean(axis=1, keepdims=True), dtype=torch.float32, device="cuda")
    temps = torch.as_tensor(ambient_temps(c), device="cuda")
    with torch.no_grad():
        st = dk._primal_layer_states(model, p, xs, 0.5, temps,
                                     torch.as_tensor(template.atom_ids, device="cuda"), etype)
    return dk.pack_inputs(st, lanes), dk._pack_mlp_stacks(p, LAYERS)


def phase_div(model, template, card: str, rows_kernels, report) -> dict:
    """10. Kernel B7 and the exact-divergence node: B7 on the tensor cores
    against its plain version at 130 chains (L = 4 and 6) and at ragged
    shapes, two launches to the bit; ``divergence_kernel_batch`` at 128
    chains with its launch count and library, against the torch.func exact
    divergence and B3's full orthogonal frame; B7 timed in turns beside the
    f32-FMA kernel at two chunk counts a CTA, with both bounds; the other
    times. Returns the launch counts."""
    from ti_torch.models.cpainn import state_of
    from ti_torch.models.cpainn_dense import dense_edge_type_matrix, dense_velocity_fn
    from ti_torch.ops import _build
    from ti_torch.ops import div_kernel as dk
    from ti_torch.ops.dense_divergence import dense_divergence
    from ti_torch.ops.divergence import divergence_exact
    from ti_torch.ops.pair_tangent_kernel import pair_tangent_div_fn

    p = {k: w.detach().to("cuda") for k, w in state_of(model, None).items()}
    etype = torch.as_tensor(dense_edge_type_matrix(template.edges), device="cuda").long()
    atom_ids = torch.as_tensor(template.atom_ids, device="cuda")
    stacks = dk._pack_mlp_stacks(p, LAYERS)
    tf32 = dk.pack_tf32_stacks(stacks)
    rng = np.random.default_rng(4)

    def states(b):
        xs = torch.as_tensor(zero_com_x0(rng, b), device="cuda")
        temps = torch.as_tensor(ambient_temps(b), device="cuda")
        with torch.no_grad():
            return xs, temps, dk._primal_layer_states(model, p, xs, 0.5, temps, atom_ids, etype)

    b7_bar = 1e-4  # five layers of f32 tangent sums taken in another order
    errs = {}
    with torch.no_grad():
        _, _, st = states(130)  # 130: not a multiple of anything
        for lanes in (4, 6):
            inp = dk.pack_inputs(st, lanes)
            out = dk.div_kernel(inp, stacks, lanes, tf32=tf32)
            torch.cuda.synchronize()
            require(_build.ROUTES["div_kernel"] == "div_kernel_tf32x3",
                    "B7 launches div_kernel_tf32x3.cu by default")
            errs[lanes] = compare([out], [dk.div_kernel_plain(inp, stacks, lanes)], torch.float32,
                                  f"B7 div_kernel L={lanes} B=130 (3xTF32)", bar=b7_bar)
            if lanes == 4:
                again = dk.div_kernel(inp, stacks, lanes, tf32=tf32)
                torch.cuda.synchronize()
                require(torch.equal(again, out), "B7 3xTF32: two launches on the same inputs agree "
                                                 "to the bit")
                del again
        del st, inp, out
        torch.cuda.empty_cache()
        # ragged shapes: 5, 29 and 32 atoms (12, 2 and 2 lanes a tile); 1, 3 and 57
        # lanes a chunk (57 at N = 32: 96 real lanes in two chunks of 57); one chain
        for n, c, lanes in ((5, 3, 1), (29, 2, 3), (32, 2, 57), (N_ATOMS, 1, 4)):
            inp, stk = div_inputs(n, c, lanes, seed=10 + n)
            out = dk.div_kernel(inp, stk, lanes)
            torch.cuda.synchronize()
            compare([out], [dk.div_kernel_plain(inp, stk, lanes)], torch.float32,
                    f"B7 div_kernel N={n} B={c} L={lanes} (3xTF32)", bar=b7_bar)
        del inp, stk, out
        torch.cuda.empty_cache()

    # the entry point at 128 chains, counted
    lanes = 4
    xs, temps, st = states(CHAINS)
    dk.divergence_kernel_batch(model, None, xs, 0.5, temps, template, lanes, device="cuda")
    torch.cuda.synchronize()  # warm-up, not counted
    _build.reset_launches()
    divs = dk.divergence_kernel_batch(model, None, xs, 0.5, temps, template, lanes,
                                      device="cuda")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    routes = {k: n for k, n in _build.ROUTE_LAUNCHES.items() if n}
    want = {k: 0 for k in launches}
    want["div_kernel"] = 1
    require(launches == want, f"divergence_kernel_batch launch counts {launches} == {want}")
    require(routes == {("div_kernel", "div_kernel_tf32x3"): 1},
            f"divergence_kernel_batch launches B7 from div_kernel_tf32x3.cu: {routes}")
    require(divs.shape == (CHAINS,) and bool(torch.isfinite(divs).all()),
            "divergence_kernel_batch: finite (128,) divergences")
    drift = dense_velocity_fn(model, p, template)
    exact_fn = lambda: divergence_exact(lambda y: drift(y, 0.5, temps), xs, chunk=3 * N_ATOMS)[1]
    with torch.no_grad():
        exact = exact_fn()
    div_fn = pair_tangent_div_fn(model, None, template, num_probes=3 * N_ATOMS,
                                 probe_mode="orthogonal", device="cuda")
    frame_fn = lambda: div_fn(xs, 0.5, temps, torch.Generator(device="cuda").manual_seed(0))
    _build.reset_launches()
    frame = frame_fn()
    torch.cuda.synchronize()
    frame_routes = {k: n for k, n in _build.ROUTE_LAUNCHES.items() if n}
    require(frame_routes == {("pair_tangent", "pair_tangent_tf32x3"): LAYERS},
            f"the K=57 frame node launches B3 from pair_tangent_tf32x3.cu once a layer: "
            f"{frame_routes}")
    for name, ref in (("divergence_exact(chunk=19)", exact), ("B3 orthogonal K=57", frame)):
        err = ((divs - ref).abs() / ref.abs()).max().item()
        log(f"[B7 entry B={CHAINS} L={lanes}] against {name}: max rel err {err:.3e} (bar 3e-4); "
            f"max |div| {ref.abs().max().item():.4f}")
        require(bool(torch.allclose(divs, ref, rtol=3e-4, atol=0)),
                f"divergence_kernel_batch agrees with {name} (rtol 3e-4)")
    err = ((frame - exact).abs() / exact.abs()).max().item()
    log(f"[B3 frame node B={CHAINS} K=57 f32] against divergence_exact(chunk=19): max rel err "
        f"{err:.3e} (bar 3e-4)")
    require(bool(torch.allclose(frame, exact, rtol=3e-4, atol=0)),
            "B3's K=57 f32 frame agrees with divergence_exact(chunk=19) (rtol 3e-4)")

    # times, CUDA events after warm-up: B7 on the tensor cores at the plan's G
    # and at G = 3, in turns with the f32-FMA kernel
    n_chunks = -(-3 * N_ATOMS // lanes)
    g_plan = dk.div_tc_plan(CHAINS, N_ATOMS, lanes, n_chunks,
                            torch.cuda.get_device_properties(0).multi_processor_count).chunks
    g_alt = 3 if g_plan != 3 else 1
    with torch.no_grad():
        inp = dk.pack_inputs(st, lanes)
        out = dk.div_kernel(inp, stacks, lanes, tf32=tf32)
        runs = {"tc": lambda: dk.div_kernel(inp, stacks, lanes, tf32=tf32),
                "alt": lambda: dk.div_kernel(inp, stacks, lanes, tf32=tf32, chunks_per_cta=g_alt),
                "fma": lambda: dk.div_kernel(inp, stacks, lanes, variant="fma")}
        ms = {k: [] for k in runs}
        for k in ("tc", "alt", "fma", "fma", "alt", "tc"):
            ms[k].append(cuda_ms(runs[k], 2, warm=1))
        plain = cuda_ms(lambda: dk.div_kernel_plain(inp, stacks, lanes), 2, warm=1)
        whole = cuda_ms(lambda: dk.divergence_kernel_batch(model, None, xs, 0.5, temps, template,
                                                           lanes, device="cuda"), 3, warm=1)
        t_exact = cuda_ms(exact_fn, 2, warm=1)
        t_frame = cuda_ms(frame_fn, 2, warm=1)
        one = lambda i: dense_divergence(model, p, xs[i], 0.5, temps[i], template.atom_ids,
                                         template.edges)
        t_one = cuda_ms(lambda: one(0), 3, warm=1)
        t_all = cuda_ms(lambda: [one(i) for i in range(CHAINS)], 1, warm=0)
    tc_ms, alt_ms, fma_ms = (min(ms[k]) for k in runs)
    macs = b7_macs(CHAINS, N_ATOMS, LAYERS)
    moved = nbytes(*inp, *stacks, out)
    bnd_tc, by_tc = bound_ms(3 * 2.0 * macs, H100_TF32, moved)
    bnd_fma, by_fma = bound_ms(2.0 * macs, H100_FP32, moved)
    fmt = lambda ts: " and ".join(f"{t:.3f}" for t in ts)
    log(f"[B7 B={CHAINS} L={lanes}] ms per launch, 2 launches a reading, in turns: 3xTF32 (tensor "
        f"cores, div_kernel_tf32x3) G={g_plan} chunks a CTA {fmt(ms['tc'])}, G={g_alt} "
        f"{fmt(ms['alt'])}, variant=fma (f32 FMA, div_kernel.cu) {fmt(ms['fma'])}; 3xTF32 "
        f"{fma_ms / tc_ms:.2f}x faster; plain {plain:.3f} ms; bound {bnd_tc:.3f} ms ({by_tc}, 3 x 2 x "
        f"{macs:.4e} MACs at 495 TFLOP/s TF32), f32 FMA bound {bnd_fma:.3f} ms ({by_fma}, 67 TFLOP/s; "
        f"MACs = C·F²·(N²·(15·SL + 3N·(7·SL + 8·(SL-1))) + 12·3N·N·SL)); 3xTF32 at "
        f"{tc_ms / bnd_tc:.2f}x its bound, fma at {fma_ms / bnd_fma:.2f}x its bound ({card})")
    for fn, regs, spill in ptxas_kernels(report["div_kernel_tf32x3"]["ptxas"]):
        log(f"[B7 3xTF32 build] {fn}: {regs}; {spill}")
    for g, t in ((g_plan, tc_ms), (g_alt, alt_ms)):
        own = b7_tc_kernel_macs(CHAINS, N_ATOMS, LAYERS, lanes, g)
        log(f"[B7 B={CHAINS} L={lanes} G={g}] the 3xTF32 kernel computes {own:.4e} MACs "
            f"({own / macs:.3f}x the function's: the primal once per CTA, layer and dst atom, "
            f"{-(-n_chunks // g)} CTAs a chain; the padded lanes skipped), "
            f"{2e-9 * own / t:.3f} TFLOP/s of products (each three TF32 passes)")
    own = b7_kernel_macs(CHAINS, N_ATOMS, LAYERS, lanes)
    log(f"[B7 B={CHAINS} L={lanes}] the f32-FMA kernel computes {own:.4e} MACs "
        f"({own / macs:.3f}x the function's: primal recomputed per chunk and per 2-lane "
        f"sub-block, padded lanes) = C·ceil(3N/L)·F²·(N²·((5 + 10·ceil(L/2))·SL "
        f"+ L·(7·SL + 8·(SL-1))) + 12·L·N·SL), {2e-9 * own / fma_ms:.3f} TFLOP/s")
    log(f"[exact node B={CHAINS}] divergence_kernel_batch {whole:.3f} ms (primal states, packing, "
        f"B7, readout); divergence_exact(chunk=19) over dense_velocity_fn {t_exact:.3f} ms; "
        f"pair_tangent_div_fn K=57 f32 (5 B3 launches from pair_tangent_tf32x3 + glue) "
        f"{t_frame:.3f} ms; "
        f"dense_divergence {t_one:.3f} ms per chain, {t_all:.3f} ms for the {CHAINS} chains "
        f"one by one ({card})")
    require(tc_ms < fma_ms, "B7 on the tensor cores is faster than the f32-FMA kernel")
    rows_kernels["div_kernel"] = dict(err=errs[4], ms=tc_ms, plain=plain, bound=bnd_tc, by=by_tc)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ti_torch.config import ambient_preset, fast_profile
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.cpainn import CPaiNN
    from ti_torch.ops import _build
    from ti_torch.ops.pair_layer_kernel import pair_kernel_drift, pair_layer, pair_layer_plain
    from ti_torch.ops.pair_tangent_kernel import (
        pair_tangent,
        pair_tangent_div_fn,
        pair_tangent_plain,
    )
    from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of, sample_ambient

    t_start = time.perf_counter()
    marks = [("1", 0.0)]  # (phase, the smoke's seconds when it started)

    def mark(phase: str) -> None:
        marks.append((phase, time.perf_counter() - t_start))

    # ---- 1. card, precision flags, build ----
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[flags] torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    report = _build.build_all(force=True)
    for name, r in report.items():
        log(f"[build] {name}: {r['seconds']:.1f} s (nvcc, sm_90a, parallel)")
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build]   {line.strip()}")
    for name in ("pair_tangent_mma", "pair_tangent_tf32x3", "pair_tangent_mma_f256",
                 "pair_tangent_tf32x3_f256", "pair_tangent_mma_f64", "pair_tangent_tf32x3_f64",
                 "pair_layer_tf32x3", "pair_layer_tf32x3_f256", "pair_layer_tf32x3_f64",
                 "pair_layer_mma", "pair_layer_mma_f256", "pair_layer_mma_f64",
                 "fused_edge_mlp_tf32x3", "fused_edge_mlp_jvp_tf32x3", "fused_mlp_tf32x3",
                 "div_kernel_tf32x3"):
        spills = [ln.strip() for ln in report[name]["ptxas"].splitlines() if "spill" in ln]
        require(bool(spills) and all("0 bytes spill stores, 0 bytes spill loads" in ln
                                     for ln in spills), f"{name} builds without register spills: {spills}")

    model = torch_default_weights_(CPaiNN(F, LAYERS, n_atoms=N_ATOMS))
    params = {k: t.detach() for k, t in model.state_dict().items()}
    mac_row = 15 * F * F  # message-MLP multiply-adds per pair row (phi 8F², w 7F²)
    rows = CHAINS * N_ATOMS * N_ATOMS
    rows_kernels = {}

    # ---- 2. B1 against its plain version ----
    mark("2")
    # f32, the main path's trajectory profile: the 3xTF32 tensor-core kernel
    # and, timed beside it in turns, the f32-FMA kernel
    f32 = torch.float32
    w, base, _ = layer_inputs(params, f32, 0, seed=1)
    ref = pair_layer_plain(*base, w, LENGTH_SCALE)
    errs = {}
    for variant in ("tc", "fma"):
        out = pair_layer(*base, w, LENGTH_SCALE, variant=variant)
        torch.cuda.synchronize()
        errs[variant] = compare(out, ref, f32, f"B1 pair_layer f32 B={CHAINS} variant={variant}")
    require(_build.ROUTES["pair_layer"] == "pair_layer", "variant='fma' launches pair_layer.cu")
    tc_out = pair_layer(*base, w, LENGTH_SCALE)
    require(_build.ROUTES["pair_layer"] == "pair_layer_tf32x3",
            "f32 launches pair_layer_tf32x3.cu by default")
    compare(tc_out, out, f32, "B1 f32 variant=tc against variant=fma")
    again = pair_layer(*base, w, LENGTH_SCALE)
    torch.cuda.synchronize()
    require(all(torch.equal(a, q) for a, q in zip(again, tc_out)),
            "B1 variant=tc: two launches on the same inputs agree to the bit")
    ms = {v: [] for v in ("tc", "fma")}
    fmt = lambda ts: " and ".join(f"{t:.4f}" for t in ts)
    for variant in ("tc", "fma", "fma", "tc"):
        ms[variant].append(cuda_ms(lambda: pair_layer(*base, w, LENGTH_SCALE, variant=variant), 20))
    plain = cuda_ms(lambda: pair_layer_plain(*base, w, LENGTH_SCALE), 10)
    tc_ms, fma_ms = min(ms["tc"]), min(ms["fma"])
    moved = nbytes(*base, w.mats, w.vecs, *tc_out)
    flops = 2.0 * mac_row * rows
    bnd_fma, by_fma = bound_ms(flops, H100_FP32, moved)
    bnd_tc, by_tc = bound_ms(3 * flops, H100_TF32, moved)
    bnd, by = min((bnd_fma, by_fma), (bnd_tc, by_tc))
    log(f"[B1 f32 B={CHAINS}] ms per launch, 20 launches a reading, in turns: variant=tc "
        f"(3xTF32, tensor cores) {fmt(ms['tc'])}, variant=fma (f32 FMA) {fmt(ms['fma'])}; tc "
        f"{fma_ms / tc_ms:.2f}x faster; plain {plain:.4f} ms; bound {bnd:.4f} ms ({by}, "
        f"3 x {flops:.4e} FLOP at 495 TFLOP/s TF32), f32 FMA bound {bnd_fma:.4f} ms ({by_fma}, "
        f"67 TFLOP/s); tc at {tc_ms / bnd:.2f}x its bound, fma at {fma_ms / bnd_fma:.2f}x its "
        f"bound ({card})")
    require(tc_ms < fma_ms, "the tensor-core kernel is faster than the f32-FMA kernel")
    rows_kernels["pair_layer"] = dict(err=errs["tc"], ms=tc_ms, plain=plain, bound=bnd, by=by)
    del w, base, out, ref, tc_out, again
    # ragged shapes: 130 chains (the last tile not full) at 19 atoms (3 groups a
    # tile) and at 29 (2 groups a tile)
    for n in (N_ATOMS, 29):
        w, base, _ = layer_inputs(params, f32, 0, seed=7, b=130, n=n)
        out = pair_layer(*base, w, LENGTH_SCALE, variant="tc")
        torch.cuda.synchronize()
        compare(out, pair_layer_plain(*base, w, LENGTH_SCALE), f32,
                f"B1 pair_layer f32 B=130 N={n} variant=tc")
    del w, base, out
    # bf16_agg: mma.sync bf16 on the tensor cores (pair_layer_mma.cu) and, timed
    # beside it in turns, the f32-FMA kernel
    bf = torch.bfloat16
    w, base, _ = layer_inputs(params, bf, 0, seed=1)
    ref = pair_layer_plain(*base, w, LENGTH_SCALE)
    errs16, outs = {}, {}
    for variant, lib in (("tc", "pair_layer_mma"), ("fma", "pair_layer")):
        outs[variant] = pair_layer(*base, w, LENGTH_SCALE, variant=variant)
        torch.cuda.synchronize()
        require(_build.ROUTES["pair_layer"] == lib, f"bf16_agg variant={variant} launches {lib}")
        errs16[variant] = compare(outs[variant], ref, bf,
                                  f"B1 pair_layer bf16_agg B={CHAINS} variant={variant}")
    compare(outs["tc"], outs["fma"], bf, "B1 bf16_agg variant=tc against variant=fma")
    again = pair_layer(*base, w, LENGTH_SCALE)
    torch.cuda.synchronize()
    require(_build.ROUTES["pair_layer"] == "pair_layer_mma", "bf16_agg launches pair_layer_mma.cu")
    require(all(torch.equal(a, q) for a, q in zip(again, outs["tc"])),
            "B1 bf16_agg: two launches on the same inputs agree to the bit")
    ms = {v: [] for v in ("tc", "fma")}
    for variant in ("tc", "fma", "fma", "tc"):
        ms[variant].append(cuda_ms(lambda: pair_layer(*base, w, LENGTH_SCALE, variant=variant), 20))
    plain = cuda_ms(lambda: pair_layer_plain(*base, w, LENGTH_SCALE), 10)
    mma_ms, fma16 = min(ms["tc"]), min(ms["fma"])
    bnd16, by16 = bound_ms(2.0 * mac_row * rows, H100_BF16, nbytes(*base, w.mats, w.vecs, *again))
    log(f"[B1 bf16_agg B={CHAINS}] ms per launch, 20 launches a reading, in turns: variant=tc "
        f"(mma.sync bf16, tensor cores) {fmt(ms['tc'])}, variant=fma (f32 FMA) {fmt(ms['fma'])}; "
        f"tc {fma16 / mma_ms:.2f}x faster; plain {plain:.4f} ms; bound {bnd16:.4f} ms ({by16}, "
        f"{2.0 * mac_row * rows:.4e} FLOP at 989 TFLOP/s bf16); tc at {mma_ms / bnd16:.2f}x its "
        f"bound ({card})")
    for fn, regs, spill in ptxas_kernels(report["pair_layer_mma"]["ptxas"]):
        log(f"[B1 bf16_agg build] {fn}: {regs}; {spill}")
    require(mma_ms < fma16, "the bf16 tensor-core kernel is faster than the f32-FMA kernel")
    rows_kernels["pair_layer_bf16_agg"] = dict(err=errs16["tc"], ms=mma_ms, plain=plain,
                                               bound=bnd16, by=by16)
    del w, base, ref, outs, again
    for n in (N_ATOMS, 29):
        w, base, _ = layer_inputs(params, bf, 0, seed=7, b=130, n=n)
        out = pair_layer(*base, w, LENGTH_SCALE, variant="tc")
        torch.cuda.synchronize()
        compare(out, pair_layer_plain(*base, w, LENGTH_SCALE), bf,
                f"B1 pair_layer bf16_agg B=130 N={n} variant=tc")
    del w, base, out
    torch.cuda.empty_cache()

    # ---- 3. B3 against its plain version ----
    mark("3")
    # bf16_agg, the main path's divergence profile: the tensor-core kernel
    k, lane_block, reps = 16, 4, 5
    w, base, lanes = layer_inputs(params, torch.bfloat16, k, seed=2)
    ref = pair_tangent_plain(*base, *lanes, w, LENGTH_SCALE, lane_block)
    out = pair_tangent(*base, *lanes, w, LENGTH_SCALE, lane_block)
    torch.cuda.synchronize()
    require(_build.ROUTES["pair_tangent"] == "pair_tangent_mma",
            "bf16_agg launches pair_tangent_mma.cu")
    err16 = compare(out, ref, torch.bfloat16, f"B3 pair_tangent bf16 K={k} L={lane_block}")
    ms = [cuda_ms(lambda: pair_tangent(*base, *lanes, w, LENGTH_SCALE, lane_block), reps, warm=1)
          for _ in range(2)]
    plain = cuda_ms(lambda: pair_tangent_plain(*base, *lanes, w, LENGTH_SCALE, lane_block), reps,
                    warm=1)
    b3_ms = min(ms)
    fmt = lambda ts: " and ".join(f"{t:.3f}" for t in ts)
    bnd, by = bound_ms(2.0 * mac_row * rows * (1 + k), H100_BF16,
                       nbytes(*base, *lanes, w.mats, w.vecs, *out))
    log(f"[B3 bf16 K={k} L={lane_block} B={CHAINS}] mma.sync bf16 (tensor cores) {fmt(ms)} ms per "
        f"launch ({reps} launches a reading); plain {plain:.3f} ms; bound {bnd:.4f} ms ({by}), "
        f"at {b3_ms / bnd:.1f}x the bound ({card})")
    rows_kernels["pair_tangent"] = dict(err=err16, ms=b3_ms, plain=plain, bound=bnd, by=by)
    del w, base, lanes, out, ref
    torch.cuda.empty_cache()
    # a ragged shape: 130 chains (a multiple of nothing), K = 8 in lane blocks of 2
    w, base, lanes = layer_inputs(params, torch.bfloat16, 8, seed=6, b=130)
    out = pair_tangent(*base, *lanes, w, LENGTH_SCALE, 2)
    torch.cuda.synchronize()
    compare(out, pair_tangent_plain(*base, *lanes, w, LENGTH_SCALE, 2), torch.bfloat16,
            "B3 pair_tangent bf16 K=8 L=2 B=130")
    del w, base, lanes, out
    torch.cuda.empty_cache()
    # f32, the exact slice's frame (K = 3N): the 3xTF32 tensor-core kernel and,
    # timed beside it in turns, the f32-FMA kernel; the plain version takes one
    # lane a block to bound its memory
    k, reps = 3 * N_ATOMS, 2
    w, base, lanes = layer_inputs(params, f32, k, seed=2)
    ref = pair_tangent_plain(*base, *lanes, w, LENGTH_SCALE, 1)
    out = pair_tangent(*base, *lanes, w, LENGTH_SCALE)
    torch.cuda.synchronize()
    require(_build.ROUTES["pair_tangent"] == "pair_tangent_tf32x3",
            "f32 launches pair_tangent_tf32x3.cu by default")
    err32 = compare(out, ref, f32, f"B3 pair_tangent f32 K={k} B={CHAINS} (3xTF32)")
    old = pair_tangent(*base, *lanes, w, LENGTH_SCALE, 1, variant="fma")
    torch.cuda.synchronize()
    require(_build.ROUTES["pair_tangent"] == "pair_tangent", "variant='fma' launches pair_tangent.cu")
    compare(old, ref, f32, f"B3 pair_tangent f32 K={k} B={CHAINS} variant=fma")
    compare(out, old, f32, "B3 f32 3xTF32 against variant=fma")
    again = pair_tangent(*base, *lanes, w, LENGTH_SCALE)
    torch.cuda.synchronize()
    require(all(torch.equal(a, q) for a, q in zip(again, out)),
            "B3 f32: two launches on the same inputs agree to the bit")
    del old, again, ref
    ms = {v: [] for v in ("mma", "fma")}
    for variant in ("mma", "fma", "fma", "mma"):
        ms[variant].append(cuda_ms(lambda: pair_tangent(*base, *lanes, w, LENGTH_SCALE, 1,
                                                        variant=variant), reps, warm=1))
    plain = cuda_ms(lambda: pair_tangent_plain(*base, *lanes, w, LENGTH_SCALE, 1), reps, warm=1)
    t32_ms, fma32 = min(ms["mma"]), min(ms["fma"])
    moved = nbytes(*base, *lanes, w.mats, w.vecs, *out)
    flops = 2.0 * mac_row * rows * (1 + k)
    bnd_fma, by_fma = bound_ms(flops, H100_FP32, moved)
    bnd_tc, by_tc = bound_ms(3 * flops, H100_TF32, moved)
    log(f"[B3 f32 K={k} B={CHAINS}] ms per launch, {reps} launches a reading, in turns: 3xTF32 "
        f"(tensor cores, pair_tangent_tf32x3) {fmt(ms['mma'])}, variant=fma (f32 FMA) "
        f"{fmt(ms['fma'])}; 3xTF32 {fma32 / t32_ms:.2f}x faster; plain {plain:.3f} ms; bound "
        f"{bnd_tc:.4f} ms ({by_tc}, 3 x {flops:.4e} FLOP at 495 TFLOP/s TF32), f32 FMA bound "
        f"{bnd_fma:.4f} ms ({by_fma}, 67 TFLOP/s); 3xTF32 at {t32_ms / bnd_tc:.2f}x its bound, fma "
        f"at {fma32 / bnd_fma:.2f}x its bound; {moved / 1e9:.3f} GB moved ({card})")
    for fn, regs, spill in ptxas_kernels(report["pair_tangent_tf32x3"]["ptxas"]):
        log(f"[B3 f32 build] {fn}: {regs}; {spill}")
    require(t32_ms < fma32, "B3 f32 on the tensor cores is faster than the f32-FMA kernel")
    rows_kernels["pair_tangent_f32"] = dict(err=err32, ms=t32_ms, plain=plain, bound=bnd_tc,
                                            by=by_tc)
    del w, base, lanes, out
    torch.cuda.empty_cache()
    # ragged shapes: 130 chains; K = 16 and 5 leave the last tile of 3 lanes
    # part full; 29 and 32 atoms take 2 lanes a tile
    for n, k in ((N_ATOMS, 16), (N_ATOMS, 5), (29, 5), (32, 16)):
        w, base, lanes = layer_inputs(params, f32, k, seed=8, b=130, n=n)
        out = pair_tangent(*base, *lanes, w, LENGTH_SCALE)
        torch.cuda.synchronize()
        compare(out, pair_tangent_plain(*base, *lanes, w, LENGTH_SCALE, 1), f32,
                f"B3 pair_tangent f32 B=130 N={n} K={k} (3xTF32)")
    del w, base, lanes, out
    torch.cuda.empty_cache()

    # ---- 4. the exact slice against the plain-version sampler ----
    mark("4")
    mol = make_synthetic_molecule(N_ATOMS, seed=0)
    template = graph_template(mol, t_cond=2)
    rng = np.random.default_rng(1)
    x0 = (0.1 * rng.standard_normal((2 * CHAINS, N_ATOMS, 3))).astype(np.float32)
    x0 -= x0.mean(axis=1, keepdims=True)
    cfg_exact = fast_profile(ambient_preset("00031"), divergence="exact",
                             div_forward_impl="pair_tangent")
    require((cfg_exact.n_features, cfg_exact.traj_forward_impl) == (F, "pair_kernel"),
            "fast_profile at 00031")
    sample_ambient(cfg_exact, model, None, template, x0[:CHAINS], save=False, batch_size=CHAINS,
                   device="cuda")  # warm-up, not counted
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    exact = sample_ambient(cfg_exact, model, None, template, x0[:CHAINS], save=False,
                           batch_size=CHAINS, device="cuda")
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t0
    exact_launches = dict(_build.LAUNCHES)
    exact_routes = {k: n for k, n in _build.ROUTE_LAUNCHES.items() if n}
    # GL-8: 9 trajectory gaps of one RK4 step, 8 divergence nodes; one launch a layer
    n_b1 = (1 + cfg_exact.dlogp_quad_points) * {"rk4": 4}[cfg_exact.solver_type] * LAYERS
    n_b3 = cfg_exact.dlogp_quad_points * LAYERS
    log(f"[slice exact] {CHAINS} chains in {t_exact:.3f} s, {CHAINS / t_exact:.3f} samples/s "
        f"(host clock, {card}); launches by library "
        f"{ {f'{k}:{lib}': n for (k, lib), n in exact_routes.items()} }")
    require(exact_routes == {("pair_layer", "pair_layer_tf32x3"): n_b1,
                             ("pair_tangent", "pair_tangent_tf32x3"): n_b3},
            f"every B1 launch of the exact slice comes from pair_layer_tf32x3.cu and every B3 "
            f"launch from pair_tangent_tf32x3.cu: {exact_routes}")
    plain_sampler = make_ode_sampler(
        molecular_v_fn_of(model, None, template, device="cuda"),
        solver=cfg_exact.solver_type, n_steps=cfg_exact.n_steps, n_save=2,
        divergence="exact", steps_per_dispatch=cfg_exact.steps_per_dispatch,
        dlogp_quad_points=cfg_exact.dlogp_quad_points, dlogp_quad="gauss",
        traj_drift=pair_kernel_drift(model, None, template, device="cuda", kernel=False),
        div_drift=pair_tangent_div_fn(model, None, template, num_probes=3 * N_ATOMS,
                                      probe_mode="orthogonal", device="cuda", kernel=False),
        device="cuda",
    )
    temps = np.tile(np.array([cfg_exact.sampling_T0, cfg_exact.sampling_T1], np.float32),
                    (CHAINS, 1))
    t0 = time.perf_counter()
    ref = plain_sampler(x0[:CHAINS], temps, torch.Generator(device="cuda").manual_seed(0))
    t_plain = time.perf_counter() - t0
    ref_samples = ref.xs.cpu().numpy()
    ref_dlogp = ref.dlogp[:, -1].cpu().numpy()
    require(exact["samples"].shape == (CHAINS, 2, N_ATOMS, 3), "exact slice: samples shape")
    require(np.isfinite(exact["samples"]).all() and np.isfinite(exact["dlogps"]).all(),
            "exact slice: finite")
    s_err = float(np.max(np.abs(exact["samples"] - ref_samples)))
    d_err = float(np.max(np.abs(exact["dlogps"] - ref_dlogp)))
    d_atol = 1e-3 * float(np.max(np.abs(ref_dlogp)))
    log(f"[slice exact] kernels {t_exact:.2f} s, plain versions {t_plain:.2f} s; samples max abs "
        f"err {s_err:.3e}, dlogp max abs err {d_err:.3e} (max |dlogp| {np.max(np.abs(ref_dlogp)):.4f}); "
        f"dlogp mean {exact['dlogps'].mean():.5f}")
    require(np.allclose(exact["samples"], ref_samples, rtol=1e-4, atol=1e-5),
            "exact slice: samples agree with the plain versions (rtol 1e-4, atol 1e-5)")
    require(np.allclose(exact["dlogps"], ref_dlogp, rtol=1e-3, atol=d_atol),
            "exact slice: dlogp agrees with the plain versions (rtol 1e-3, atol 1e-3 max|dlogp|)")

    # ---- 5. the slice as users run it ----
    mark("5")
    cfg = fast_profile(ambient_preset("00031"))
    require((cfg.traj_forward_impl, cfg.div_forward_impl, cfg.num_probes, cfg.probe_mode)
            == ("pair_kernel", "pair_tangent_bf16", 16, "orthogonal"), "fast_profile route")
    with tempfile.TemporaryDirectory() as tmp:
        cfg.data_save_path = tmp
        sample_ambient(cfg, model, None, template, x0[:CHAINS], save=False,
                       batch_size=CHAINS, device="cuda")  # warm-up, not counted
        n_batches = len(x0) // CHAINS
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = sample_ambient(cfg, model, None, template, x0, save=True, batch_size=CHAINS,
                             device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        route_launches = dict(_build.ROUTE_LAUNCHES)
        saved = sorted(os.listdir(tmp))
    log(f"[slice fast_profile] {len(x0)} chains in {n_batches} batches of {CHAINS}: {wall:.3f} s, "
        f"{len(x0) / wall:.3f} samples/s (host clock, {card}); launches {launches}, by library "
        f"{ {f'{k}:{lib}': n for (k, lib), n in route_launches.items()} }; artifacts {saved}")
    gaps = 1 + cfg.dlogp_quad_points  # GL-8: 9 trajectory gaps, one RK4 step each
    stages = {"rk4": 4}[cfg.solver_type]
    want = {k: 0 for k in launches}
    want.update(pair_layer=n_batches * gaps * stages * LAYERS,
                pair_tangent=n_batches * cfg.dlogp_quad_points * LAYERS)
    require(launches == want, f"launch counts {launches} == {want}")
    by_route = {k: n for k, n in route_launches.items() if n}
    want_routes = {("pair_layer", "pair_layer_tf32x3"): want["pair_layer"],
                   ("pair_tangent", "pair_tangent_mma"): want["pair_tangent"]}
    require(by_route == want_routes, f"every B1 launch of the main path comes from "
            f"pair_layer_tf32x3.cu and every B3 launch from pair_tangent_mma.cu: {by_route}")
    require(out["samples"].shape == (len(x0), 2, N_ATOMS, 3) and out["dlogps"].shape == (len(x0),),
            "fast slice: output shapes")
    require(np.isfinite(out["samples"]).all() and np.isfinite(out["dlogps"]).all(),
            "fast slice: finite samples and dlogp")
    traj_diff = float(np.max(np.abs(out["samples"][:CHAINS] - exact["samples"])))
    log(f"[slice fast_profile] trajectory against the exact slice's: max abs diff {traj_diff:.3e}")
    require(np.array_equal(out["samples"][:CHAINS], exact["samples"]),
            "fast slice: the f32 pair-kernel trajectory repeats the exact run's to the bit")
    require(len(saved) == 4, "fast slice: samples/dlogps/latent artifacts written")
    diff = out["dlogps"][:CHAINS] - exact["dlogps"]
    log(f"[slice fast_profile] dlogp (orthogonal-16, bf16_agg) minus exact: mean {diff.mean():.5f}, "
        f"rms {math.sqrt(float((diff ** 2).mean())):.5f}")
    # the same divergence profile with the full orthogonal frame (K = 3N, the
    # exact trace, no probe noise): what is left of the offset is bf16_agg
    # rounding of the divergence
    cfg57 = fast_profile(ambient_preset("00031"), divergence="exact")
    require((cfg57.div_forward_impl, cfg57.compute_dtype) == ("pair_tangent_bf16", "bf16_agg"),
            "fast_profile with the exact divergence keeps B3 in bf16_agg")
    full = sample_ambient(cfg57, model, None, template, x0[:CHAINS], save=False,
                          batch_size=CHAINS, device="cuda")
    require(np.array_equal(full["samples"], exact["samples"]) and np.isfinite(full["dlogps"]).all(),
            "bf16_agg full frame: the same trajectory, finite dlogp")
    d57 = full["dlogps"] - exact["dlogps"]
    log(f"[slice bf16_agg K={3 * N_ATOMS}] dlogp (full orthogonal frame, bf16_agg) minus exact "
        f"(f32): mean {d57.mean():.5f}, rms {math.sqrt(float((d57 ** 2).mean())):.5f}, std error "
        f"{d57.std(ddof=1) / math.sqrt(CHAINS):.5f}; orthogonal-16 minus the full frame: mean "
        f"{(out['dlogps'][:CHAINS] - full['dlogps']).mean():.5f}")
    # one divergence node of that path beside its B3 launches: the rest is plain glue
    # (embeddings, update and readout JVPs, the probes' QR)
    div_fn = pair_tangent_div_fn(model, None, template, num_probes=cfg.num_probes,
                                 probe_mode=cfg.probe_mode, compute_dtype="bf16_agg", device="cuda")
    xs_node = torch.as_tensor(x0[:CHAINS], device="cuda")
    temps_node = torch.as_tensor(temps, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    _build.reset_launches()
    node_ms = cuda_ms(lambda: div_fn(xs_node, 0.5, temps_node, gen), 5, warm=2)
    require(_build.LAUNCHES["pair_tangent"] == 7 * LAYERS, "a divergence node launches B3 once a layer")
    log(f"[divergence node B={CHAINS} K={cfg.num_probes} bf16_agg] {node_ms:.3f} ms a node, of which "
        f"{LAYERS} B3 launches x {b3_ms:.3f} ms = {LAYERS * b3_ms:.3f} ms; plain glue "
        f"{node_ms - LAYERS * b3_ms:.3f} ms ({card})")
    # one trajectory forward of that path (5 B1 launches and the plain glue),
    # in f32 and in bf16_agg in turns: the host's time to enqueue it beside its
    # time synchronised, and the glue's aten ops. Where the two times are
    # close, the host sets the trajectory's pace, not the card
    drifts = {"f32": pair_kernel_drift(model, None, template, device="cuda"),
              "bf16_agg": pair_kernel_drift(model, None, template, compute_dtype="bf16_agg",
                                            device="cuda")}
    costs = {k: [] for k in drifts}
    for k in ("f32", "bf16_agg", "bf16_agg", "f32"):
        costs[k].append(forward_costs(drifts[k], xs_node, temps_node))
    for k, b1_ms in (("f32", tc_ms), ("bf16_agg", mma_ms)):
        log(f"[trajectory forward B={CHAINS} {k}] "
            f"{' and '.join(f'{fw:.3f}' for _, fw, _ in costs[k])} ms synchronised, "
            f"{' and '.join(f'{eq:.3f}' for eq, _, _ in costs[k])} ms for the host to enqueue "
            f"(two readings, in turns f32, bf16_agg, bf16_agg, f32); {costs[k][0][2]} aten ops "
            f"besides its {LAYERS} B1 launches x {b1_ms:.4f} ms = {LAYERS * b1_ms:.3f} ms on the "
            f"card (host clock, {card})")
    # the same slice with the bf16_agg trajectory (B1 in pair_layer_mma.cu): its
    # samples/s beside the headline's, its dlogp against the exact slice's
    cfg16 = fast_profile(ambient_preset("00031"), traj_forward_impl="pair_kernel_bf16")
    sample_ambient(cfg16, model, None, template, x0[:CHAINS], save=False, batch_size=CHAINS,
                   device="cuda")  # warm-up, not counted
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out16 = sample_ambient(cfg16, model, None, template, x0, save=False, batch_size=CHAINS,
                           device="cuda")
    torch.cuda.synchronize()
    wall16 = time.perf_counter() - t0
    launches16 = dict(_build.LAUNCHES)
    by_route16 = {k: n for k, n in _build.ROUTE_LAUNCHES.items() if n}
    require(launches16 == want, f"bf16_agg trajectory launch counts {launches16} == {want}")
    require(by_route16 == {("pair_layer", "pair_layer_mma"): want["pair_layer"],
                           ("pair_tangent", "pair_tangent_mma"): want["pair_tangent"]},
            f"every B1 launch of the bf16_agg trajectory comes from pair_layer_mma.cu: {by_route16}")
    require(np.isfinite(out16["samples"]).all() and np.isfinite(out16["dlogps"]).all(),
            "bf16_agg trajectory: finite samples and dlogp")
    traj16 = float(np.max(np.abs(out16["samples"][:CHAINS] - exact["samples"])))
    d16 = out16["dlogps"][:CHAINS] - exact["dlogps"]
    log(f"[slice bf16_agg trajectory] {len(x0)} chains: {wall16:.3f} s, {len(x0) / wall16:.3f} "
        f"samples/s against the headline's {len(x0) / wall:.3f} (host clock, {card}); launches by "
        f"library { {f'{k}:{lib}': n for (k, lib), n in by_route16.items()} }; samples minus the "
        f"exact slice's: max abs {traj16:.3e}; dlogp minus exact: mean {d16.mean():.5f}, rms "
        f"{math.sqrt(float((d16 ** 2).mean())):.5f}")

    # ---- 6-9. the SDE and fused-MLP slices ----
    mark("6-9")
    phase_b2(params, rows_kernels, card)
    sde_launches = phase_sde(model, template, card)
    phase_fused_kernels(params, rows_kernels, report, card)
    fwd_launches, smp_launches = phase_fused_paths(model, template, card)

    # ---- 10. kernel B7 and the exact-divergence node ----
    mark("10")
    div_launches = phase_div(model, template, card, rows_kernels, report)

    # ---- 11. the reference's sampler, bench.py's reference shape, stage-coupled B4/B5 ----
    mark("11")
    phase_reference(model, template, card)

    # ---- 12. ambient training on the card, a trained field through B1 and B3 ----
    mark("12")
    phase_training(card)

    # ---- 13. the latent family through B1 and B3, the BG→TI composition, quadrature ----
    mark("13")
    phase_latent(model, card)

    # ---- 14. the ADW family: training, transport, reweighted gEDMD ----
    mark("14")
    phase_adw(card)

    # ---- 15. the large molecule's fast profile: B1 at F = 256 ----
    mark("15")
    launches10506 = phase_10506(rows_kernels, card)

    # ---- 16. the analysis layer over the main path's samples ----
    mark("16")
    phase_analysis(model, template, card)

    # ---- 17. the parallel layer: chain- and lane-sharded sampling, data-parallel
    # training on NCCL at world size 1, the fan-out CLI on the one card ----
    mark("17")
    from chip_smoke_parallel import phase_parallel

    launches17 = phase_parallel(model, template, card)
    require((launches17["pair_layer"], launches17["pair_tangent"])
            == (launches["pair_layer"] // n_batches, launches["pair_tangent"] // n_batches),
            f"the chain-sharded main path launches a batch's B1 and B3: {launches17}")

    # ---- 18. the user CLIs, the checkpoint import, the trace and the timer ----
    mark("18")
    from chip_smoke_cli import phase_cli

    phase_cli(model, template, card)

    # ---- 19. the study CLIs: B1, B2, B4, B5 and B6 through the scans and profiles ----
    mark("19")
    from chip_smoke_studies import phase_studies

    phase_studies(model, template, card)

    # ---- 20. B1 and B2 in f32 at F = 256, the physics-validation CLIs ----
    mark("20")
    from chip_smoke_validate import phase_validate

    launches20 = phase_validate(model, rows_kernels, card)

    # ---- 21. B3 at F = 256 in both types, the 10506 nodes through it ----
    mark("21")
    from chip_smoke_b3_f256 import phase_b3_f256

    launches21 = phase_b3_f256(rows_kernels, report, card)

    # ---- 22. B1/B2 and B3 at F = 64, validate_mdqm9_physics at its own width ----
    mark("22")
    from chip_smoke_f64 import phase_f64

    launches22 = phase_f64(rows_kernels, report, card)

    # ---- 23. result lines ----
    mark("23")
    path_launches = {**launches20, **launches21, **launches22, "pair_layer": launches["pair_layer"],
                     "pair_layer_bf16_agg": launches16["pair_layer"],
                     "pair_layer_bf16_agg_f256": launches10506["pair_layer"],
                     "pair_tangent": launches["pair_tangent"],
                     "pair_tangent_f32": exact_launches["pair_tangent"],
                     "pair_layer_cb": sde_launches["pair_layer_cb"],
                     "fused_edge_mlp": smp_launches["fused_edge_mlp"],
                     "fused_edge_mlp_jvp": smp_launches["fused_edge_mlp_jvp"],
                     "fused_mlp": fwd_launches["fused_mlp"],
                     "div_kernel": div_launches["div_kernel"]}
    require(all(n > 0 for n in path_launches.values()), f"every kernel ran on its path: "
            f"{path_launches}")
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = rows_kernels[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": path_launches[name], "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain"], "bound_ms": r["bound"], "bound_by": r["by"],
                        "library_ms": None})
    mark("end")
    log("[phase seconds] " + ", ".join(f"{p} {t1 - t0:.1f}"
                                       for (p, t0), (_, t1) in zip(marks, marks[1:])))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
