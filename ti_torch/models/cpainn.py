"""cPaiNN — the chirality-aware SE(3)-equivariant velocity field as an
``nn.Module`` (port of ti_tpu/models/cpainn.py).

Submodules carry the flax names (``atom_embed``, ``edge_embed``,
``combine``, ``message_{i}.phi/w``, ``update_{i}.u/v/mlp``,
``readout.mlp/V``), so a flax parameter tree maps onto the state dict
name by name (models/convert.py). ``CPaiNN.forward`` is the dense pair
form of models/cpainn_dense.py; ``apply_edge`` is the edge (gather/scatter)
form, the port of the flax module's ``__call__``, which reads the same
state dict.

Reference quirks kept (see ti_tpu/models/cpainn.py): edge_dir = r/(1+|r|),
not normalised; the cross term uses the DESTINATION node's equivariant
features; the readout overwrites the node features.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ti_torch.models.embeddings import MLP, lecun_normal_

_N_COND = {"ambient": 2, "latent": 1, "none": 0}


class EquivariantLinear(nn.Module):
    """Channel-mixing linear map without bias over the (N, F, 3) feature
    axis; ``weight`` is (out, in) like ``nn.Linear``, drawn lecun-normal
    over f_in as ti_tpu's kernel is."""

    def __init__(self, f_in: int, f_out: int, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(f_out, f_in))
        with torch.no_grad():
            lecun_normal_(self.weight, f_in, generator)

    def forward(self, v: torch.Tensor) -> torch.Tensor:  # (..., F, 3)
        return torch.einsum("...fc,gf->...gc", v, self.weight)


class SE3Message(nn.Module):
    def __init__(self, f: int, generator=None):
        super().__init__()
        self.phi = MLP(2 * f, f, 5 * f, generator)
        self.w = MLP(f, f, 5 * f, generator)


class Update(nn.Module):
    def __init__(self, f: int, generator=None):
        super().__init__()
        self.u = EquivariantLinear(f, f, generator)
        self.v = EquivariantLinear(f, f, generator)
        self.mlp = MLP(2 * f, f, 3 * f, generator)


class LayerReadout(nn.Module):
    def __init__(self, f: int, f_out: int = 1, generator=None):
        super().__init__()
        self.mlp = MLP(f, f, 2 * f_out, generator)
        self.V = EquivariantLinear(f, f_out, generator)


class CPaiNN(nn.Module):
    """Ambient/latent cPaiNN velocity field.

    ``n_types`` sizes the atom-id table; None takes max(25, n_atoms), the
    size ti_tpu infers from the graph. ``cutoff`` None is the complete
    graph (every production config); a finite cutoff masks non-bonded
    pairs farther apart than it, per evaluation.

    A fresh model draws its parameters as flax's ``model.init`` does:
    Dense and EquivariantLinear kernels lecun-normal, biases 0, LayerNorm
    scale 1, the embeddings N(0, 1/F). ``generator`` makes the draws (None:
    PyTorch's global generator).
    """

    def __init__(
        self,
        n_features: int = 128,
        score_layers: int = 5,
        *,
        n_atoms: Optional[int] = None,
        n_types: Optional[int] = None,
        n_edge_types: int = 4,
        temp_length: float = 100.0,
        time_length: float = 10.0,
        length_scale: float = 10.0,
        temperatures: Tuple[float, ...] = (300.0, 400.0, 500.0, 600.0, 700.0, 800.0, 900.0, 1000.0),
        conditioning: str = "ambient",
        cutoff: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if conditioning not in _N_COND:
            raise ValueError(f"unknown conditioning {conditioning!r}")
        f = n_features
        self.n_features = f
        self.score_layers = score_layers
        self.temp_length = temp_length
        self.time_length = time_length
        self.length_scale = length_scale
        self.temperatures = tuple(temperatures)
        self.conditioning = conditioning
        self.cutoff = cutoff
        self.edge_embed = nn.Embedding(n_edge_types, f)
        self.atom_embed = nn.Embedding(
            n_types if n_types is not None else max(25, n_atoms or 0), f
        )
        for embed in (self.edge_embed, self.atom_embed):  # flax's default_embed_init
            nn.init.normal_(embed.weight, std=f ** -0.5, generator=generator)
        self.combine = MLP((2 + _N_COND[conditioning]) * f, f, f, generator)
        for i in range(score_layers):
            self.add_module(f"message_{i}", SE3Message(f, generator))
            self.add_module(f"update_{i}", Update(f, generator))
        self.readout = LayerReadout(f, 1, generator)

    def forward(self, x, t, temps, atom_ids, edges, compute_dtype=None):
        """(B, N, 3) positions -> (B, N, 3) velocity (dense pair form)."""
        from ti_torch.models.cpainn_dense import apply_dense

        return apply_dense(self, None, x, t, temps, atom_ids, edges,
                           compute_dtype=compute_dtype)


def apply_edge(model, params, x: torch.Tensor, t: torch.Tensor, temps: torch.Tensor,
               atom_ids, edges, compute_dtype=None) -> torch.Tensor:
    """Batched velocity field, edge layout: (B, N, 3) -> (B, N, 3) for
    times ``t`` (B,) and conditioning ``temps`` (B, K).

    The port of ti_tpu's ``CPaiNN.__call__``: every chain gathers its node
    features along the E edges of ``edges`` (an ``EdgeTable``), and
    ``edge_aggregate`` sums the messages into their dst node. With a finite
    ``model.cutoff`` a non-bonded edge counts only while its current length
    is within the cutoff; bond edges always count. f32 only: ti_tpu's edge
    form computes in the model's dtype, f32 on every path that calls it."""
    from ti_torch.models.cpainn_dense import _cross, node_features
    from ti_torch.models.embeddings import positional_encoding
    from ti_torch.ops.graph import edge_aggregate
    from ti_torch.ops.mlp_block import _mlp_block, mlp_weights

    if compute_dtype is not None:
        raise ValueError("the edge form computes in f32: compute_dtype must be None")
    p = state_of(model, params)
    f = model.n_features
    b, n, _ = x.shape
    src = torch.as_tensor(edges.src, device=x.device).long()
    dst = torch.as_tensor(edges.dst, device=x.device).long()
    etype = torch.as_tensor(edges.edge_type, device=x.device).long()

    def mlp(rows, prefix):
        return _mlp_block(rows, mlp_weights(p, prefix))

    def eq_linear(v, name):  # (..., F, 3) channel mix, weight (out, in)
        return torch.einsum("...fc,gf->...gc", v, p[f"{name}.weight"])

    r = x[:, src] - x[:, dst]  # (B, E, 3)
    dist = torch.linalg.norm(r, dim=-1)
    direc = r / (1.0 + dist[..., None])  # reference quirk: not normalised
    mask = None
    if model.cutoff is not None:
        mask = ((etype > 0)[None] | (dist <= model.cutoff)).to(x.dtype)[..., None]

    e = p["edge_embed.weight"][etype].expand(b, len(src), f)
    s = mlp(node_features(model, p, t, temps, atom_ids, n), "combine")
    v = torch.zeros(b, n, f, 3, dtype=x.dtype, device=x.device)
    pe = positional_encoding(dist, f, model.length_scale)
    dir_e = direc[:, :, None, :]  # (B, E, 1, 3)

    for layer in range(model.score_layers):
        pre = f"message_{layer}"
        h = mlp(torch.cat([s[:, src], e], dim=-1), f"{pre}.phi") * mlp(pe, f"{pre}.w")
        if mask is not None:
            h = h * mask
        gates, scale_dir, ds, de, cg = torch.split(h, f, dim=-1)
        v_dst = v[:, dst]
        # reference quirk: the cross term takes the DST node's features
        msg = (scale_dir[..., None] * dir_e + gates[..., None] * v[:, src]
               + cg[..., None] * _cross(dir_e.expand_as(v_dst), v_dst))
        s = s + edge_aggregate(ds, edges, dim=1)
        v = v + edge_aggregate(msg, edges, dim=1)
        e = e + de

        up = f"update_{layer}"
        uv = eq_linear(v, f"{up}.u")
        vv_norm = torch.linalg.norm(eq_linear(v, f"{up}.v"), dim=-1)
        g_u, scale_sq, add_inv = torch.split(mlp(torch.cat([vv_norm, s], dim=-1), f"{up}.mlp"),
                                             f, dim=-1)
        v = v + g_u[..., None] * uv
        s = s + vv_norm ** 2 * scale_sq + add_inv

    gate = mlp(s, "readout.mlp")[..., 1:2]  # the readout overwrites: only its gate is read
    return gate * eq_linear(v, "readout.V")[:, :, 0, :]


def state_of(model: nn.Module, params=None):
    """The parameter dict the functional forwards read: ``params`` if
    given (a CPaiNN state dict), else the module's own parameters."""
    if params is not None:
        return params
    return dict(model.named_parameters())
