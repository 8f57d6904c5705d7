"""MDQM9 trajectory ingest, molecule templates and synthetic stand-ins.

Port of ti_tpu/data/mdqm9.py: the ambient dataset (frames at a list of
temperatures) and the latent one (noise paired with frames). A ``MolTemplate`` takes the place of ti_tpu's ``MolGraph``: the
static per-molecule inputs of the velocity field (atom ids, edge table,
number of conditioning temperatures), kept on the host as numpy.
Trajectory files are (8, n_frames, n_atoms, 3) per split, indexed by
temperature (300..1000 K -> 0..7). Frames stay numpy on the host; an
epoch's batches go to the device in one copy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ti_torch.data.sdf import Molecule, parse_sdf_v2000
from ti_torch.ops.graph import EdgeTable, make_edge_table
from ti_torch.ops.kabsch import kabsch_align

# Published per-molecule coordinate scalings
SCALING_FACTOR = 0.20754094
SCALING_FACTOR_31 = 0.09729941375
SCALING_FACTOR_10506 = 0.13163184188306332

TEMPERATURES = tuple(range(300, 1001, 100))
_TEMP_INDEX = {t: i for i, t in enumerate(TEMPERATURES)}


def scaling_factor_for(traj_filename: str) -> float:
    if "00031" in traj_filename:
        return SCALING_FACTOR_31
    if "10506" in traj_filename:
        return SCALING_FACTOR_10506
    return SCALING_FACTOR


def load_trajs(
    traj_path: str, split: str, traj_filename: str, temperature: int, scale: bool
) -> np.ndarray:
    """(n_frames, n_atoms, 3) frames at one temperature, COM-centred,
    optionally scaled."""
    trajs = np.load(os.path.join(traj_path, split, traj_filename))[_TEMP_INDEX[temperature]]
    trajs = trajs - trajs.mean(axis=1, keepdims=True)
    if scale:
        trajs = trajs * scaling_factor_for(traj_filename)
    return np.asarray(trajs, dtype=np.float32)


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


@dataclasses.dataclass
class MDQM9AmbientDataset:
    """Frames at a list of temperatures for T0→T1 transport training.

    Two instances (the T0s list and the T1s list) are zipped with
    independent shuffles each epoch, so temperature pairs recombine.
    """

    frames: np.ndarray  # (n, N, 3) float32, centred (+scaled)
    temps: np.ndarray  # (n,) float32
    mol: Molecule
    template: MolTemplate

    @classmethod
    def load(
        cls,
        traj_path: str,
        sdf_path: str,
        traj_filename: str,
        sdf_filename: str = "mdqm9.sdf",
        split: str = "train",
        Ts: Sequence[int] = (300,),
        scale: bool = True,
        mol_index: Optional[int] = None,
    ) -> "MDQM9AmbientDataset":
        if mol_index is None:
            mol_index = int(traj_filename.split(".")[0])
        mol = parse_sdf_v2000(os.path.join(sdf_path, sdf_filename), mol_index)
        data = [load_trajs(traj_path, split, traj_filename, T, scale) for T in Ts]
        temps = np.concatenate([np.full(len(d), T, dtype=np.float32) for d, T in zip(data, Ts)])
        return cls(
            frames=np.concatenate(data, axis=0),
            temps=temps,
            mol=mol,
            template=graph_template(mol, t_cond=2),
        )

    @classmethod
    def from_arrays(cls, frames, temps, mol: Molecule, t_cond: int = 2) -> "MDQM9AmbientDataset":
        return cls(
            frames=np.asarray(frames, np.float32),
            temps=np.asarray(temps, np.float32),
            mol=mol,
            template=graph_template(mol, t_cond=t_cond),
        )

    def __len__(self) -> int:
        return len(self.frames)

    def epoch_batches(self, generator: Optional[torch.Generator], batch_size: int,
                      perm=None, device=None):
        """(n_batches, B, N, 3) frames and (n_batches, B) temps, shuffled by
        ``torch.randperm`` from ``generator`` (a CPU generator), or in the
        order ``perm`` gives; the tail that fills no batch is dropped. Both
        land on ``device`` (default the CPU) in one copy each."""
        n = len(self)
        nb = n // batch_size
        if perm is None:
            perm = torch.randperm(n, generator=generator).numpy()
        perm = np.asarray(perm)[: nb * batch_size]
        x = torch.from_numpy(self.frames[perm]).reshape(nb, batch_size, *self.frames.shape[1:])
        t = torch.from_numpy(self.temps[perm]).reshape(nb, batch_size)
        return x.to(device), t.to(device)


@dataclasses.dataclass
class MDQM9LatentDataset:
    """Noise→data pairs for the latent (Boltzmann-generator) pipeline:
    x0 ~ N(0, I) with its centre of mass removed and, with ``align``,
    Kabsch-rotated onto its data frame x1 (the reference's
    mdqm9/data/mdqm9_latent.py:100-105).

    ``align=True`` is the parity default: the reference configs say "0",
    but its loader keeps the string and ``if self.align:`` takes "0" as
    true (``config.latent_preset``).
    """

    frames: np.ndarray  # (n, N, 3) float32 data (x1), centred (+scaled)
    temps: np.ndarray  # (n,) float32
    mol: Molecule
    template: MolTemplate
    align: bool = True

    @classmethod
    def load(
        cls,
        traj_path: str,
        sdf_path: str,
        traj_filename: str,
        sdf_filename: str = "mdqm9.sdf",
        split: str = "train",
        Ts: Sequence[int] = (300,),
        scale: bool = True,
        align: bool = True,
        mol_index: Optional[int] = None,
    ) -> "MDQM9LatentDataset":
        """Frames at each of ``Ts`` from the reference layout; the model is
        conditioned on the temperature (t_cond 1) only when there are
        several."""
        if mol_index is None:
            mol_index = int(traj_filename.split(".")[0])
        mol = parse_sdf_v2000(os.path.join(sdf_path, sdf_filename), mol_index)
        data = [load_trajs(traj_path, split, traj_filename, T, scale) for T in Ts]
        temps = np.concatenate([np.full(len(d), T, dtype=np.float32) for d, T in zip(data, Ts)])
        return cls(
            frames=np.concatenate(data, axis=0),
            temps=temps,
            mol=mol,
            template=graph_template(mol, t_cond=1 if len(Ts) > 1 else 0),
            align=align,
        )

    @classmethod
    def from_arrays(cls, frames, temps, mol: Molecule, t_cond: int = 1,
                    align: bool = True) -> "MDQM9LatentDataset":
        return cls(
            frames=np.asarray(frames, np.float32),
            temps=np.asarray(temps, np.float32),
            mol=mol,
            template=graph_template(mol, t_cond=t_cond),
            align=align,
        )

    def __len__(self) -> int:
        return len(self.frames)

    def epoch_batches(self, generator: Optional[torch.Generator], batch_size: int,
                      perm=None, z=None, device=None):
        """(nb, B, N, 3) noise x0, (nb, B, N, 3) centred data x1 and (nb, B)
        temps, on ``device`` (default the CPU).

        The frames are shuffled by ``torch.randperm`` from ``generator`` (a
        CPU generator), or put in the order ``perm`` gives, and the tail
        that fills no batch is dropped; then the noise is drawn, nb·B
        standard normal frames from the same generator, unless ``z``
        (nb·B, N, 3) gives it. The noise loses its centre of mass and,
        with ``align``, is rotated onto its data frame."""
        n = len(self)
        nb = n // batch_size
        if perm is None:
            perm = torch.randperm(n, generator=generator).numpy()
        perm = np.asarray(perm)[: nb * batch_size]
        x1 = torch.from_numpy(self.frames[perm]).to(device)
        if z is None:
            z = torch.randn(x1.shape, generator=generator, dtype=x1.dtype)
        elif not torch.is_tensor(z):
            z = torch.from_numpy(np.array(z, dtype=np.float32))
        z = z.to(device=device, dtype=x1.dtype).reshape(x1.shape)
        z = z - z.mean(dim=1, keepdim=True)
        x1c = x1 - x1.mean(dim=1, keepdim=True)
        if self.align:
            z = kabsch_align(z, x1c)
        shape = (nb, batch_size, *self.frames.shape[1:])
        t = torch.from_numpy(self.temps[perm]).reshape(nb, batch_size).to(device)
        return z.reshape(shape), x1c.reshape(shape), t

    def sample_noise(self, generator: Optional[torch.Generator], n: int) -> torch.Tensor:
        """n frames of COM-free N(0, I) noise for generation, drawn from
        ``generator`` on its device."""
        dev = None if generator is None else generator.device
        z = torch.randn((n, *self.frames.shape[1:]), generator=generator, device=dev)
        return z - z.mean(dim=1, keepdim=True)


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


def write_synthetic_workspace(root: str, n_atoms: int, n_frames: int, mol_index: int = 31,
                              seed: int = 0, jitter: float = 0.3) -> Molecule:
    """An MDQM9 workspace in the reference's on-disk layout under ``root``:
    ``trajs/{train,test}/{mol_index:05d}.npy`` of shape (8, n_frames,
    n_atoms, 3), one block of harmonic frames (``make_synthetic_frames``)
    per temperature of the grid, and ``mdqm9.sdf`` with the molecule at
    record ``mol_index``. Returns the molecule."""
    from ti_torch.data.sdf import write_sdf_v2000

    mol = make_synthetic_molecule(n_atoms, seed=seed)
    for split in ("train", "test"):
        os.makedirs(os.path.join(root, "trajs", split), exist_ok=True)
        frames = np.stack([make_synthetic_frames(mol, n_frames, t, seed=t, jitter=jitter)
                           for t in TEMPERATURES])
        np.save(os.path.join(root, "trajs", split, f"{mol_index:05d}.npy"), frames)
    write_sdf_v2000(os.path.join(root, "mdqm9.sdf"), mol, mol_index)
    return mol
