"""Minimal in-repo SDF (MDL molfile V2000) reader, and a writer for
synthetic workspaces.

The reference uses RDKit (C++) solely to read bonds/atomic numbers from
mdqm9.sdf (mdqm9/data/mdqm9_ambient.py:222-250). RDKit isn't in this image
and full cheminformatics is unnecessary: the V2000 counts/atom/bond blocks
are fixed-width text. This parser extracts exactly what the pipelines
need — atomic numbers, bond index (bidirectional), bond types — host-side,
once per molecule.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

_PERIODIC = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Br": 35, "I": 53,
}


@dataclasses.dataclass(frozen=True)
class Molecule:
    """Host-side molecule record: everything the graph layer needs."""

    atomic_numbers: np.ndarray  # (N,) int
    positions: np.ndarray  # (N, 3) float (from the SDF block; MD data overrides)
    bond_index: np.ndarray  # (2, 2*n_bonds) int, bidirectional
    bond_types: np.ndarray  # (2*n_bonds,) int; aromatic (4 in SDF) -> 1 like the
    # reference's long() cast of GetBondTypeAsDouble()=1.5
    name: str = ""

    @property
    def n_atoms(self) -> int:
        return len(self.atomic_numbers)

    def adjacency(self) -> np.ndarray:
        a = np.zeros((self.n_atoms, self.n_atoms), dtype=np.int64)
        if self.bond_index.size:
            a[self.bond_index[0], self.bond_index[1]] = 1
        return a


def _parse_one(lines: List[str], name: str) -> Molecule:
    counts = lines[3]
    n_atoms = int(counts[0:3])
    n_bonds = int(counts[3:6])
    atoms, pos = [], []
    for i in range(n_atoms):
        ln = lines[4 + i]
        pos.append([float(ln[0:10]), float(ln[10:20]), float(ln[20:30])])
        sym = ln[31:34].strip()
        atoms.append(_PERIODIC.get(sym, 0))
    src, dst, types = [], [], []
    for i in range(n_bonds):
        ln = lines[4 + n_atoms + i]
        a1, a2 = int(ln[0:3]) - 1, int(ln[3:6]) - 1
        bt = int(ln[6:9])
        bt = 1 if bt == 4 else bt  # aromatic -> 1 (reference long-cast of 1.5)
        src += [a1, a2]
        dst += [a2, a1]
        types += [bt, bt]
    return Molecule(
        atomic_numbers=np.asarray(atoms, dtype=np.int64),
        positions=np.asarray(pos, dtype=np.float64),
        bond_index=np.asarray([src, dst], dtype=np.int64).reshape(2, -1),
        bond_types=np.asarray(types, dtype=np.int64),
        name=name,
    )


def parse_sdf_v2000(path: str, index: Optional[int] = None):
    """Parse an SDF file; return the ``index``-th molecule or all of them.

    Mirrors the reference's ``Chem.SDMolSupplier(...)[file_id]`` access
    pattern (mdqm9/data/mdqm9_ambient.py:222-227)."""
    with open(path) as f:
        text = f.read()
    records = [r.lstrip("\n") for r in text.split("$$$$") if r.strip()]
    if index is not None:
        rec = records[index]
        return _parse_one(rec.splitlines(), name=rec.splitlines()[0].strip())
    return [_parse_one(r.splitlines(), name=r.splitlines()[0].strip()) for r in records]


_SYMBOL = {z: sym for sym, z in _PERIODIC.items()}


def write_sdf_v2000(path: str, mol: Molecule, index: int = 0) -> None:
    """Write an SDF of ``index + 1`` records, each ``mol``, so that
    ``parse_sdf_v2000(path, index)`` reads ``mol`` back (the reference
    layout keeps a molecule at its file id's record)."""
    record = [f"{mol.name or 'mol'}", "  synthetic", "",
              f"{mol.n_atoms:3d}{mol.bond_index.shape[1] // 2:3d}  0  0  0  0  0  0  0  0999 V2000"]
    for (x, y, z), num in zip(mol.positions, mol.atomic_numbers):
        record.append(f"{x:10.4f}{y:10.4f}{z:10.4f} {_SYMBOL[int(num)]:<3}0  0  0  0  0  0  0  0"
                      "  0  0  0  0")
    seen = set()
    for s, d, t in zip(*mol.bond_index, mol.bond_types):
        if (d, s) not in seen:
            seen.add((s, d))
            record.append(f"{s + 1:3d}{d + 1:3d}{t:3d}  0")
    record += ["M  END", "$$$$"]
    with open(path, "w") as f:
        f.write("\n".join(record * (index + 1)) + "\n")
