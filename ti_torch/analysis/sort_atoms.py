"""Chemistry-aware atom placing order + z-matrix reference triplets (a copy
of ti_tpu/analysis/sort_atoms.py, which is numpy only).

Behavioral rebuild of the reference atom-ordering logic
(mdqm9/analysis/utils/sort_atoms.py, adapted there from the public
olsson-group/sma-md): BFS over the non-terminal subgraph picks a placement
order in which every atom is placed relative to already-placed reference
atoms; terminal atoms are grouped with their centers.

Unlike the reference this operates on a plain adjacency matrix (numpy) —
no RDKit dependency; callers get adjacency from ti_torch.data.sdf (in-repo
SDF parser) or any bond list. Host-side, runs once per molecule.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def adjacency_from_bonds(n_atoms: int, bond_index: np.ndarray) -> np.ndarray:
    """Symmetric 0/1 adjacency from a (2, E) (possibly directed) bond list."""
    a = np.zeros((n_atoms, n_atoms), dtype=np.int64)
    if bond_index.size:
        a[bond_index[0], bond_index[1]] = 1
        a[bond_index[1], bond_index[0]] = 1
    return a


def _neighbors(a: np.ndarray) -> List[List[int]]:
    return [[int(j) for j in np.nonzero(a[i])[0]] for i in range(a.shape[0])]


def _bfs_with_parents(neigh: List[List[int]], start: int) -> Tuple[List[int], List[int]]:
    """BFS order (including start) and each visited node's parent (None for
    start). Mirrors the reference bfs_parents convention
    (sort_atoms.py:41-59) where the start node seeds `visited`."""
    visited = [start]
    parents: List[int] = [None]  # type: ignore[list-item]
    queue = [start]
    while queue:
        center = queue.pop(0)
        for nb in neigh[center]:
            if nb not in visited:
                visited.append(nb)
                parents.append(center)
                queue.append(nb)
    return visited, parents


def compute_atom_order_and_references_groups(adjacency: np.ndarray):
    """(atom_order, groups, ref_atoms) for z-matrix construction.

    atom_order: placement order in ORIGINAL indices (use
    ``x[atom_order]`` before construct_z_matrix). groups: terminal groups
    in the NEW ordering. ref_atoms: (N, 3) reference triplets in the NEW
    ordering, None-padded for the first rows. Matches the reference
    compute_atom_order_and_references_groups (sort_atoms.py:215-329).
    """
    a = np.asarray(adjacency)
    n = a.shape[0]
    neigh = _neighbors(a)
    deg = a.sum(axis=1)

    if n == 2:
        return [0, 1], [], [[None, None, None], [0, None, None]]

    non_terminals = [i for i in range(n) if deg[i] > 1]

    # start at a semi-terminal non-terminal: all (or all-but-one) of its
    # neighbors are terminal — makes assembly proceed outside-in
    start_nt_idx = 0
    for nt in non_terminals:
        term_flags = [deg[nb] == 1 for nb in neigh[nt]]
        if sum(term_flags) >= len(term_flags) - 1:
            start_nt_idx = non_terminals.index(nt)
            break

    if len(non_terminals) > 1:
        nt_index = {v: i for i, v in enumerate(non_terminals)}
        nt_neigh = [
            [nt_index[nb] for nb in neigh[v] if nb in nt_index] for v in non_terminals
        ]
        visited, parents_idx = _bfs_with_parents(nt_neigh, start_nt_idx)
        nt_order = [non_terminals[i] for i in visited]
        parents = [None] + [non_terminals[i] for i in parents_idx[1:]]
    else:
        nt_order = [non_terminals[0]]
        parents = [None]

    def by_degree_desc(atoms: Sequence[int]) -> List[int]:
        return [i for _, i in sorted(((-int(deg[i]), int(i)) for i in atoms))]

    # first group: the starting center plus all its neighbors
    center = nt_order[0]
    sn = by_degree_desc(neigh[center])
    atom_order: List[int] = [center] + sn
    groups: List[List[int]] = [[center] + sn]
    ref_atoms: List[List[int]] = [[None, None, None], [center, None, None], [center, sn[0], None]]
    for _ in sn[2:]:
        ref_atoms.append([center, sn[0], sn[1]])

    # remaining non-terminals: attach their unvisited neighbors.
    #
    # Ring safety: whenever a non-terminal is processed as a center, ALL of
    # its neighbors end up placed (first group explicitly; later groups via
    # `rest` + the already-placed parent). `parent` precedes `nt` in the
    # BFS order, so by the time nt's children are placed every neighbor of
    # parent — including the `third` torsion reference below — is already
    # in atom_order; ring-closing neighbors are skipped by the
    # `atom not in atom_order` guard (same invariant as the reference,
    # sort_atoms.py:294-311). Verified on cyclic/fused/bridged topologies
    # in tests/test_zmatrix.py (ring round-trip + randomized polycyclic
    # property test).
    for nt, parent in zip(nt_order[1:], parents[1:]):
        rest = [nb for nb in neigh[nt] if nb != parent]
        rest = by_degree_desc(rest)
        groups.append([nt, parent] + rest)
        for i_nb, atom in enumerate(rest):
            if atom not in atom_order:
                atom_order.append(int(atom))
                if i_nb == 0:
                    third = [nb for nb in neigh[parent] if nb != nt][0]
                    ref_atoms.append([nt, parent, third])
                else:
                    ref_atoms.append([nt, parent, rest[0]])

    # re-index everything to the new ordering
    inverse = {orig: new for new, orig in enumerate(atom_order)}
    old = ref_atoms
    ref_atoms = [[None, None, None], [0, None, None], [inverse[old[2][0]], inverse[old[2][1]], None]]
    for i in range(3, n):
        ref_atoms.append([inverse[old[i][0]], inverse[old[i][1]], inverse[old[i][2]]])
    groups = [[inverse[x] for x in g] for g in groups]

    return atom_order, groups, ref_atoms
