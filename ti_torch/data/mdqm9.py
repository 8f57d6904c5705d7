"""Molecule templates and synthetic MDQM9 stand-ins.

Port of the sampling-path part of ti_tpu/data/mdqm9.py. A ``MolTemplate``
takes the place of ti_tpu's ``MolGraph``: the static per-molecule inputs
of the velocity field (atom ids, edge table, number of conditioning
temperatures), kept on the host as numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ti_torch.data.sdf import Molecule
from ti_torch.ops.graph import EdgeTable, make_edge_table


@dataclasses.dataclass(frozen=True)
class MolTemplate:
    """Static model inputs of one molecule: atom_ids (N,) int64, the
    complete-graph edge table and the conditioning-temperature count
    (2 ambient, 1 latent, 0 single-temperature)."""

    atom_ids: np.ndarray
    edges: EdgeTable
    t_cond: int

    @property
    def n_atoms(self) -> int:
        return int(self.atom_ids.shape[0])


def graph_template(
    mol: Molecule, t_cond: int, atom_id_mode: str = "positional"
) -> MolTemplate:
    """Static template for one molecule.

    atom_id_mode: "positional" = arange(N) (the 'distinguish' mode both
    reference pipelines use) or "element" = atomic numbers.
    """
    n = mol.n_atoms
    edges = make_edge_table(n, mol.bond_index, mol.bond_types)
    ids = np.arange(n) if atom_id_mode == "positional" else mol.atomic_numbers
    return MolTemplate(atom_ids=np.asarray(ids, dtype=np.int64), edges=edges,
                       t_cond=int(t_cond))


def make_synthetic_molecule(n_atoms: int = 19, seed: int = 0) -> Molecule:
    """A chain molecule with a few branches — plausible bond graph + geometry
    (the same draws as ti_tpu's, so both packages build the same molecule)."""
    rng = np.random.default_rng(seed)
    src, dst, types = [], [], []
    pos = np.zeros((n_atoms, 3))
    for i in range(1, n_atoms):
        parent = i - 1 if i % 3 else max(0, i - 2)
        src += [parent, i]
        dst += [i, parent]
        bt = 1 + (i % 2 == 0 and i % 5 == 0)  # sprinkle some double bonds
        types += [bt, bt]
        direction = rng.normal(size=3)
        pos[i] = pos[parent] + 1.5 * direction / np.linalg.norm(direction)
    atoms = rng.choice([1, 6, 7, 8], size=n_atoms, p=[0.5, 0.35, 0.1, 0.05])
    return Molecule(
        atomic_numbers=atoms.astype(np.int64),
        positions=pos,
        bond_index=np.asarray([src, dst], dtype=np.int64),
        bond_types=np.asarray(types, dtype=np.int64),
        name=f"synthetic_{n_atoms}",
    )


def make_synthetic_frames(
    mol: Molecule, n_frames: int, temperature: float, seed: int = 0,
    jitter: float = 0.05,
) -> np.ndarray:
    """Pseudo-MD frames: equilibrium geometry + T-scaled Gaussian jitter
    (sigma = jitter * sqrt(T/300)), COM-centered — exact Boltzmann samples
    of an isotropic harmonic well."""
    rng = np.random.default_rng(seed)
    sigma = jitter * np.sqrt(temperature / 300.0)
    frames = mol.positions[None] + sigma * rng.standard_normal((n_frames, mol.n_atoms, 3))
    frames = frames - frames.mean(axis=1, keepdims=True)
    return frames.astype(np.float32)
