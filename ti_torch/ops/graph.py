"""Static graph tables for the complete molecular graph.

Port of ti_tpu/ops/graph.py. Production configs use ``cutoff=1000``, i.e.
the complete graph, so each molecule gets one static edge table built on
the host. Edges are ordered destination-major: for each dst node, its N-1
incoming edges are contiguous. The dense pair forward
(models/cpainn_dense.py) only needs the (dst, src) -> edge type matrix;
the edge form (models/cpainn.py::apply_edge) gathers along the edge axis
and sums messages into their dst node with ``edge_aggregate``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EdgeTable:
    """Static per-molecule graph, numpy arrays on the host.

    src, dst: (E,) int32 node indices. edge_type: (E,) int32 — 0 for plain
    radius edges, the bond type (1..3; aromatic truncated to 1) for bonded
    pairs. dst_major_complete: the edges enumerate the complete graph
    grouped by dst.
    """

    src: np.ndarray
    dst: np.ndarray
    edge_type: np.ndarray
    n_nodes: int
    dst_major_complete: bool


def complete_graph_edges(n_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) arrays for the complete digraph, destination-major.

    Edge k = dst*(N-1) + j has dst = k // (N-1) and src = the j-th node
    != dst in ascending order.
    """
    dst = np.repeat(np.arange(n_nodes), n_nodes - 1)
    src = np.concatenate(
        [np.concatenate([np.arange(d), np.arange(d + 1, n_nodes)]) for d in range(n_nodes)]
    )
    return src.astype(np.int32), dst.astype(np.int32)


def make_edge_table(
    n_nodes: int,
    bond_index: Optional[np.ndarray] = None,
    bond_types: Optional[np.ndarray] = None,
) -> EdgeTable:
    """Build the static complete-graph edge table with bond-typed edges.

    bond_index: (2, n_bonds) directed (already bidirectional) node pairs.
    bond_types: (n_bonds,) integer bond types (>= 1).
    """
    src, dst = complete_graph_edges(n_nodes)
    etype = np.zeros(len(src), dtype=np.int32)
    if bond_index is not None and bond_index.size:
        bt = np.asarray(bond_types, dtype=np.int32)
        type_mat = np.zeros((n_nodes, n_nodes), dtype=np.int32)
        # coalesce(reduce="max"): bond type wins over radius type 0
        np.maximum.at(type_mat, (bond_index[0], bond_index[1]), bt)
        etype = type_mat[src, dst]
    return EdgeTable(
        src=src, dst=dst, edge_type=etype.astype(np.int32),
        n_nodes=int(n_nodes), dst_major_complete=True,
    )


def edge_aggregate(messages: torch.Tensor, edges: EdgeTable, dim: int = 0) -> torch.Tensor:
    """Sum per-edge messages into their destination nodes: the edge axis
    ``dim`` (E) of ``messages`` becomes the node axis (N).

    On the dst-major complete graph this is a reshape of that axis to
    (N, N-1) and a sum over the second; otherwise an ``index_add`` on
    ``edges.dst`` (the reference's scatter-sum; ``torch_scatter`` is not
    needed)."""
    n = edges.n_nodes
    dim = dim % messages.dim()
    if edges.dst_major_complete:
        shape = messages.shape[:dim] + (n, n - 1) + messages.shape[dim + 1:]
        return messages.reshape(shape).sum(dim + 1)
    dst = torch.as_tensor(edges.dst, device=messages.device).long()
    out = messages.new_zeros(messages.shape[:dim] + (n,) + messages.shape[dim + 1:])
    return torch.index_add(out, dim, dst, messages)
