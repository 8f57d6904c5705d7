"""The weight bridge between flax parameter trees and the port's CPaiNN.

A flax tree read as numpy (``{"params": {...}}``) maps onto the CPaiNN
state dict name by name; only the leaves differ:

- Dense ``kernel`` (in, out)            <-> ``weight`` (out, in), transposed
- EquivariantLinear ``kernel`` (u, v, V) <-> ``weight`` (out, in), transposed
- LayerNorm ``scale``                    <-> ``weight``
- Embed ``embedding``                    <-> ``weight``
- ``bias``                               <-> ``bias``

``save_npz``/``load_npz`` keep a flat archive with flax-layout keys such
as ``message_0/phi/Dense_0/kernel``, so weights trained with the JAX
package reach the port without JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):  # dict or flax FrozenDict
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf_to_torch(path, arr):
    *mods, leaf = path
    name = ".".join(mods)
    arr = np.asarray(arr, dtype=np.float32)
    if leaf == "kernel":
        return f"{name}.weight", np.ascontiguousarray(arr.T)
    if leaf in ("scale", "embedding"):
        return f"{name}.weight", arr
    if leaf == "bias":
        return f"{name}.bias", arr
    raise KeyError(f"unexpected flax leaf {'/'.join(path)!r}")


def _torch_to_leaf(name: str):
    *mods, leaf = name.split(".")
    last = mods[-1]
    if leaf == "bias":
        return tuple(mods) + ("bias",), False
    if last.startswith("LayerNorm_"):
        return tuple(mods) + ("scale",), False
    if last in ("atom_embed", "edge_embed"):
        return tuple(mods) + ("embedding",), False
    return tuple(mods) + ("kernel",), True  # Dense_k, u, v, V


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """flax ``{"params": {...}}`` (numpy leaves) -> CPaiNN state dict."""
    tree = tree["params"] if "params" in tree else tree
    out = {}
    for path, arr in _flatten(tree):
        name, val = _leaf_to_torch(path, arr)
        out[name] = torch.from_numpy(np.array(val))
    return out


def params_to_flax(state) -> dict:
    """CPaiNN state dict -> flax ``{"params": {...}}`` with numpy leaves."""
    root: dict = {}
    for name, t in state.items():
        path, transpose = _torch_to_leaf(name)
        arr = t.detach().cpu().float().numpy()
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(arr.T) if transpose else arr
    return {"params": root}


def save_npz(path: str, state) -> None:
    """Write a state dict as a flat flax-layout archive."""
    flat = {"/".join(p): v for p, v in _flatten(params_to_flax(state)["params"])}
    np.savez(path, **flat)


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read a flat flax-layout archive into a CPaiNN state dict."""
    with np.load(path) as z:
        tree: dict = {}
        for key in z.files:
            *mods, leaf = key.split("/")
            node = tree
            for k in mods:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    return params_from_flax({"params": tree})
