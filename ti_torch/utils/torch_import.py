"""Import the reference's torch checkpoints into the port (a numpy copy of
ti_tpu/utils/torch_import.py, composed with ``models/convert.py``).

The reference publishes trained state dicts saved by
``torch.save(model.state_dict(), ...)`` (mdqm9/train_ambient.py:175-176) or
whole pickled modules (adw/train.py:97). ``cpainn_params_from_torch`` and
``fcnet_params_from_torch`` map their names onto flax-layout trees (numpy
leaves), the trees ``ti_tpu`` reads; ``cpainn_state_from_torch`` and
``fcnet_state_from_torch`` carry those trees through ``params_from_flax``
into the state dicts of the port's ``CPaiNN`` and ``FCNetMultiBeta``.

Name map (reference module tree -> flax):
- FCNetMultiBeta (adw/thermo/models/simple.py:20-36):
  net.{2i}.weight/bias -> dense_i/kernel(T)/bias; last -> dense_out;
  beta_embed.{0,2,4} -> beta_embed_{0,1,2}.
- cPaiNN (mdqm9/thermo/*/models/cpainn.py): torch Sequential ``net`` with
  per-conditioning indices; MLP Sequential indices {0,1,3,4,6} ->
  Dense_0/LayerNorm_0/Dense_1/LayerNorm_1/Dense_2; EquivariantLinear
  ``linear.weight`` (out,in) -> ``kernel`` (in,out). DeviceTracker dummy
  parameters and TemperatureEncoder buffers carry no information and are
  ignored.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from ti_torch import resolve_device
from ti_torch.models.convert import params_from_flax

StateDict = Mapping[str, np.ndarray]


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint (state dict or pickled module) as numpy, mapped
    to the CPU. ``weights_only=False`` unpickles whatever the file holds, as
    a pickled module needs: load only checkpoints from a trusted source."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in obj.items()}


def _mlp_from_torch(sd, prefix: str) -> Dict:
    """Reference embedding.MLP Sequential -> flax MLP params."""
    out = {}
    for flax_name, idx in (("Dense_0", 0), ("Dense_1", 3), ("Dense_2", 6)):
        out[flax_name] = {
            "kernel": sd[f"{prefix}.mlp.{idx}.weight"].T,
            "bias": sd[f"{prefix}.mlp.{idx}.bias"],
        }
    for flax_name, idx in (("LayerNorm_0", 1), ("LayerNorm_1", 4)):
        out[flax_name] = {
            "scale": sd[f"{prefix}.mlp.{idx}.weight"],
            "bias": sd[f"{prefix}.mlp.{idx}.bias"],
        }
    return out


def fcnet_params_from_torch(sd: Dict[str, np.ndarray], num_layers: int) -> Dict:
    """FCNetMultiBeta state_dict -> flax params pytree."""
    p = {}
    for i, tname in enumerate(("beta_embed.0", "beta_embed.2", "beta_embed.4")):
        p[f"beta_embed_{i}"] = {
            "kernel": sd[f"{tname}.weight"].T,
            "bias": sd[f"{tname}.bias"],
        }
    # net Sequential: Linear at even indices (SiLU between), last Linear = out
    for i in range(num_layers):
        p[f"dense_{i}"] = {
            "kernel": sd[f"net.{2 * i}.weight"].T,
            "bias": sd[f"net.{2 * i}.bias"],
        }
    p["dense_out"] = {
        "kernel": sd[f"net.{2 * num_layers}.weight"].T,
        "bias": sd[f"net.{2 * num_layers}.bias"],
    }
    return {"params": p}


_NET_INDEX = {
    # conditioning -> (edge_embed, atom_embed, combine, painn) Sequential slots
    "ambient": (2, 3, 7, 8),
    "latent": (2, 3, 6, 7),
    "none": (2, 3, 5, 6),
}


def cpainn_params_from_torch(
    sd: Dict[str, np.ndarray], score_layers: int, conditioning: str = "ambient"
) -> Dict:
    """cPaiNN state_dict -> flax params pytree for CPaiNN."""
    i_edge, i_atom, i_combine, i_painn = _NET_INDEX[conditioning]
    p = {
        "edge_embed": {"embedding": sd[f"net.{i_edge}.embedding.weight"]},
        "atom_embed": {"embedding": sd[f"net.{i_atom}.embedding.weight"]},
        "combine": {"mlp": _mlp_from_torch(sd, f"net.{i_combine}.mlp")}["mlp"],
    }
    base = f"net.{i_painn}.layers"
    for layer in range(score_layers):
        msg = f"{base}.{2 * layer}"
        upd = f"{base}.{2 * layer + 1}"
        p[f"message_{layer}"] = {
            "phi": _mlp_from_torch(sd, f"{msg}.phi"),
            "w": _mlp_from_torch(sd, f"{msg}.w"),
        }
        p[f"update_{layer}"] = {
            "u": {"kernel": sd[f"{upd}.u.linear.weight"].T},
            "v": {"kernel": sd[f"{upd}.v.linear.weight"].T},
            "mlp": _mlp_from_torch(sd, f"{upd}.mlp"),
        }
    ro = f"{base}.{2 * score_layers}"
    p["readout"] = {
        "mlp": _mlp_from_torch(sd, f"{ro}.mlp"),
        "V": {"kernel": sd[f"{ro}.V.linear.weight"].T},
    }
    return {"params": p}


def _state(tree, device) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in params_from_flax(tree).items()}


def _as_numpy(sd: Union[str, StateDict]) -> StateDict:
    return load_torch_state_dict(sd) if isinstance(sd, str) else sd


def cpainn_state_from_torch(sd: Union[str, StateDict], score_layers: int,
                            conditioning: str = "ambient", device=None) -> Dict[str, torch.Tensor]:
    """A reference cPaiNN checkpoint (its path, or its state dict as numpy)
    -> the state dict of the port's ``CPaiNN(F, score_layers,
    conditioning=conditioning)``, on ``cuda`` unless ``device`` says
    otherwise."""
    return _state(cpainn_params_from_torch(_as_numpy(sd), score_layers, conditioning), device)


def fcnet_state_from_torch(sd: Union[str, StateDict], num_layers: int,
                           device=None) -> Dict[str, torch.Tensor]:
    """A reference FCNetMultiBeta checkpoint (its path, or its state dict as
    numpy) -> the state dict of the port's ``FCNetMultiBeta``, on ``cuda``
    unless ``device`` says otherwise."""
    return _state(fcnet_params_from_torch(_as_numpy(sd), num_layers), device)
