"""MDQM9 evaluation dataset: hdf5 + SDF reader for the energy/analysis stage
(a copy of ti_tpu/data/eval_dataset.py over the port's own SDF reader).

Counterpart of the reference MDQM9EvalDataset
(mdqm9/analysis/utils/eval_dataset.py:18-53): per-molecule records read
from the curated mdqm9-nc.hdf5 layout — ``<key>/data/{atoms, heavy_atoms,
partial_charges, ref_atoms, groups}`` and ``<key>/trajectories/{md_0,
mdrt_0, re_0}`` — plus the molecule structure from the SDF (in-repo
parser instead of RDKit). h5py ships in the main image here, but the
import stays gated so the module degrades with instructions in stripped
environments (the reference runs this stage in its separate
ti_energy_env.yml environment).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ti_torch.data.sdf import Molecule, parse_sdf_v2000


@dataclasses.dataclass
class EvalRecord:
    """One molecule's record; field names follow the reference's returned
    dict keys (eval_dataset.py:52-54)."""

    mol: Molecule
    idx: int
    atoms: Optional[np.ndarray]
    heavy_atoms: Optional[np.ndarray]
    partial_charges: Optional[np.ndarray]
    ref_atoms: Optional[np.ndarray]
    groups: Optional[np.ndarray]
    conformations: Optional[np.ndarray]  # trajectories/md_0
    mdrt_conformations: Optional[np.ndarray]  # trajectories/mdrt_0 (optional)
    re_conformations: Optional[np.ndarray]  # trajectories/re_0 (optional)


class MDQM9EvalDataset:
    """Indexable reader over (hdf5, sdf) like the reference class."""

    def __init__(self, hdf5_path: str, sdf_path: str):
        try:
            import h5py  # noqa: PLC0415
        except ImportError as e:  # pragma: no cover - stripped env
            raise ImportError(
                "h5py is not available in this environment; the eval "
                "dataset belongs to the energy-evaluation stage (reference "
                "ti_energy_env.yml). Run this stage where h5py is present."
            ) from e
        self._h5 = h5py.File(hdf5_path, "r")
        self._sdf_path = sdf_path

    def __len__(self) -> int:
        return len(self._h5.keys())

    @staticmethod
    def _get(group, key):
        return np.asarray(group[key]) if group is not None and key in group else None

    def __getitem__(self, idx: int) -> EvalRecord:
        # the reference formats keys as zero-padded ids ("{:0>5d}",
        # eval_dataset.py:33); fall back to positional for ad-hoc files
        key = f"{idx:05d}"
        if key not in self._h5:
            key = list(self._h5.keys())[idx]
        g = self._h5[key]
        data = g["data"] if "data" in g else g
        trajs = g["trajectories"] if "trajectories" in g else None
        return EvalRecord(
            mol=parse_sdf_v2000(self._sdf_path, idx),
            idx=idx,
            atoms=self._get(data, "atoms"),
            heavy_atoms=self._get(data, "heavy_atoms"),
            partial_charges=self._get(data, "partial_charges"),
            ref_atoms=self._get(data, "ref_atoms"),
            groups=self._get(data, "groups"),
            conformations=self._get(trajs, "md_0"),
            mdrt_conformations=self._get(trajs, "mdrt_0"),
            re_conformations=self._get(trajs, "re_0"),
        )

    def close(self):
        self._h5.close()
