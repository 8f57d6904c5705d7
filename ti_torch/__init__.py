"""ti_torch — thermodynamic interpolation in PyTorch for one NVIDIA H100.

The PyTorch port of ``ti_tpu`` (the JAX package, which stays the
reference). This package imports ``torch`` and never ``jax`` or ``ti_tpu``.

Subpackages
-----------
- ``ti_torch.config``: the typed settings and presets (copy of ti_tpu's)
- ``ti_torch.data``: SDF reader, molecule templates, synthetic molecules
- ``ti_torch.models``: cPaiNN as an ``nn.Module``, the dense pair forward,
  the flax weight bridge
- ``ti_torch.ops``: graph tables, MLP-block math, divergence estimators and
  the two hand-written CUDA kernels (pair layer, pair tangent)
- ``ti_torch.sampling``: RK integrators and the ambient sampling driver
- ``ti_torch.analysis``: importance weights and TFEP free energies

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
