"""The weight bridge between flax parameter trees and the port's modules
(``CPaiNN``, ``FCNetMultiBeta``).

A flax tree read as numpy (``{"params": {...}}``) maps onto the module's
state dict name by name; only the leaves differ:

- Dense ``kernel`` (in, out)            <-> ``weight`` (out, in), transposed
- EquivariantLinear ``kernel`` (u, v, V) <-> ``weight`` (out, in), transposed
- LayerNorm ``scale``                    <-> ``weight``
- Embed ``embedding``                    <-> ``weight``
- ``bias``                               <-> ``bias``

Float64 leaves stay float64 both ways (the ADW family trains in f64);
every other leaf comes over as float32. ``save_npz``/``load_npz`` keep a
flat archive with flax-layout keys such as ``message_0/phi/Dense_0/kernel``,
so weights trained with the JAX package reach the port without JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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
    arr = np.asarray(arr)
    arr = arr.astype(np.float64 if arr.dtype == np.float64 else np.float32, copy=False)
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
    """flax ``{"params": {...}}`` (numpy leaves) -> state dict."""
    tree = tree["params"] if "params" in tree else tree
    out = {}
    for path, arr in _flatten(tree):
        name, val = _leaf_to_torch(path, arr)
        out[name] = torch.from_numpy(np.array(val))
    return out


def params_to_flax(state) -> dict:
    """State dict -> flax ``{"params": {...}}`` with numpy leaves."""
    root: dict = {}
    for name, t in state.items():
        path, transpose = _torch_to_leaf(name)
        t = t.detach().cpu()
        arr = (t if t.dtype == torch.float64 else t.float()).numpy()
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(arr.T) if transpose else arr
    return {"params": root}


def save_npz(path: str, state, arch: Optional[dict] = None) -> None:
    """Write a state dict as a flat flax-layout archive; ``arch`` (numbers
    that shape the model, e.g. atoms, features, layers) is kept beside it
    under ``arch/<name>``."""
    flat = {"/".join(p): v for p, v in _flatten(params_to_flax(state)["params"])}
    flat.update({f"arch/{k}": np.asarray(v) for k, v in (arch or {}).items()})
    np.savez(path, **flat)


def load_npz_arch(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    """Read a flat flax-layout archive: (state dict, its ``arch`` dict or
    None when the archive holds none)."""
    with np.load(path) as z:
        tree: dict = {}
        arch = {k[len("arch/"):]: z[k][()] for k in z.files if k.startswith("arch/")}
        for key in z.files:
            if key.startswith("arch/"):
                continue
            *mods, leaf = key.split("/")
            node = tree
            for k in mods:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    return params_from_flax({"params": tree}), arch or None


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read a flat flax-layout archive into a state dict."""
    return load_npz_arch(path)[0]
