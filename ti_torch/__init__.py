"""ti_torch — thermodynamic interpolation in PyTorch for one NVIDIA H100.

The PyTorch port of ``ti_tpu`` (the JAX package, which stays the
reference). This package imports ``torch`` and never ``jax`` or ``ti_tpu``.

Subpackages
-----------
- ``ti_torch.config``: the typed settings and presets (copy of ti_tpu's)
- ``ti_torch.data``: SDF reader, molecule templates, synthetic molecules,
  the reference-layout trajectory ingest, ``MDQM9AmbientDataset`` and
  ``MDQM9LatentDataset``; the ADW samples CSV and ``ADWDataset``; the
  energy stage's hdf5 reader ``MDQM9EvalDataset``
- ``ti_torch.models``: cPaiNN as an ``nn.Module``, its edge (gather/scatter)
  form ``apply_edge``, the dense pair forward (``fused=True``: its message
  MLPs in kernels B4/B5), the fused edge-row forward (``cpainn_fused``), the
  ADW MLP ``FCNetMultiBeta``, the flax weight bridge
- ``ti_torch.ops``: graph tables, MLP-block math, divergence estimators
  (``divergence``, the hand-propagated ``dense_divergence``), Kabsch
  alignment (``kabsch``) and the
  hand-written CUDA kernels (``csrc/``): B1 the pair layer and B2 its
  chain-blocked form (``pair_layer_kernel``), B3 the pair tangent
  (``pair_tangent_kernel``), B4 the fused edge MLP, B5 its tangent and B6
  the row-tiled MLP (``pallas_kernels``), B7 the whole-network exact
  divergence (``div_kernel``)
- ``ti_torch.sampling``: fixed-step RK and adaptive dopri5 integrators with
  stage-coupled dlogp, Simpson and Gauss-Legendre quadrature dlogp,
  Euler–Maruyama, the ambient, latent and ADW sampling drivers (the
  reference's dopri5 route and the quadrature routes) and the molecular SDE
- ``ti_torch.analysis``: importance weights, TFEP free energies, the ADW
  potential and its quadrature oracles, reweighted gEDMD spectra; the atom
  order, z-matrices and the NeRF reconstruction with log|det J| (torch),
  the paper's multi-source results report, the torsion-space kinetics, the
  OpenMM-gated energy stage and the figures
- ``ti_torch.gedmd``: gEDMD with random Fourier features (numpy) and the
  sympy dictionary ``SymbolicBasis`` (derivatives by ``torch.func``)
- ``ti_torch.interpolants``, ``ti_torch.losses``: the stochastic
  interpolants and the antithetic velocity losses
- ``ti_torch.train``: the optimizer (clip, L2 decay, Adam in optax's
  arithmetic), the NaN guard, plateau LR, checkpoints, the ambient
  trainer ``train_ambient``, the latent trainer ``train_latent`` and the
  ADW trainer ``train_adw`` (plain PyTorch under autograd: no kernel has a
  backward)
- ``ti_torch.parallel``: data-parallel training, chain- and lane-sharded
  sampling over ``torch.distributed`` (NCCL on the cards, gloo on the CPU),
  the sampling fan-out and a launcher of CPU gloo worlds
- ``ti_torch.cli``: the user CLIs, ports of ``scripts/``: the MDQM9 ambient
  and latent train and sample CLIs (``--shard``/``--num_shards``), the SDE
  sampler, the results report, the figures, the kinetics and model
  selection, the ADW train, sample and reweighted-gEDMD CLIs, the energy
  stage, the trace summary, the shard merge and the local fan-out driver;
  the studies (step count, f32 against f64, probe modes, the SDE and 10506
  scans, the divergence profile, the ADW figure)
- ``ti_torch.utils``: metric logging, ``profile_trace`` (``torch.profiler``),
  CUDA-event timing, the trace summariser and the import of the reference's
  torch checkpoints

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise. Raises when no card is present and none was named — the
    port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        device = "cuda"
    return torch.device(device)
