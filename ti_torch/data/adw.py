"""ADW dataset: per-beta sample columns with train/val/test splits (port of
ti_tpu/data/adw.py).

Counterpart of the reference ADWMultiTempDataset (adw/data/dataset.py:8-66)
+ get_loaders (adw/thermo/utils.py:25-51): loads per-beta columns from a
samples CSV (header = beta values formatted '%.2f'), optional standardize,
shuffle-subsample to n_samples, 80/10/10 split. The ingest and the splits
are ti_tpu's numpy, so both packages hold the same arrays;
``epoch_batches`` shuffles by ``torch.randperm`` from a generator, or in
the order a pinned ``perm`` gives, and stages each epoch onto the device in
one copy. ``make_synthetic_adw_csv`` generates the dataset by exact
inverse-CDF sampling of the quadrature Boltzmann density when the original
MD data (by author request only) is unavailable.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ti_torch.analysis.potentials import AsymmetricDoubleWell, BoltzmannDensity1D


def make_synthetic_adw_csv(
    path: str,
    betas: Sequence[float] = (0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0),
    n_samples: int = 100_000,
    a: float = 4.0,
    b: float = 0.5,
    seed: int = 0,
) -> str:
    """Write a samples.csv with one exact-Boltzmann column per beta."""
    pot = AsymmetricDoubleWell(a=a, b=b)
    cols = {}
    for i, beta in enumerate(betas):
        cols[f"{beta:.2f}"] = BoltzmannDensity1D(beta, pot).sample(seed + i, n_samples)
    header = ",".join(cols.keys())
    data = np.stack(list(cols.values()), axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savetxt(path, data, delimiter=",", header=header, comments="")
    return path


def _read_csv_column(path: str, colname: str) -> np.ndarray:
    with open(path) as f:
        header = f.readline().strip().split(",")
    idx = header.index(colname)
    return np.loadtxt(path, delimiter=",", skiprows=1, usecols=idx)


@dataclasses.dataclass
class ADWDataset:
    """(x, beta) pairs across a list of betas with 80/10/10 splits.

    x: (n, 1), beta: (n, 1) float32 arrays; ``epoch_batches`` yields
    shuffled batches on the device.
    """

    x: np.ndarray
    beta: np.ndarray
    seed: int = 0

    @classmethod
    def from_csv(
        cls,
        path: str,
        betas: Sequence[float],
        n_samples: int | None = None,
        scale: bool = False,
        seed: int = 0,
    ) -> "ADWDataset":
        xs, bs = [], []
        for beta in betas:
            col = _read_csv_column(path, f"{beta:.2f}")
            if scale:
                col = (col - col.mean()) / col.std()
            xs.append(col)
            bs.append(np.full(len(col), beta))
        x = np.concatenate(xs)
        b = np.concatenate(bs)
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(x))
        if n_samples is not None:
            idx = idx[:n_samples]
        return cls(x=x[idx, None].astype(np.float32), beta=b[idx, None].astype(np.float32), seed=seed)

    def __len__(self) -> int:
        return len(self.x)

    def splits(self) -> Tuple["ADWDataset", "ADWDataset", "ADWDataset"]:
        """80/10/10 random split (reference adw/thermo/utils.py:25-31)."""
        n = len(self)
        n_train, n_val = int(0.8 * n), int(0.1 * n)
        rng = np.random.default_rng(self.seed)
        idx = rng.permutation(n)
        parts = (idx[:n_train], idx[n_train : n_train + n_val], idx[n_train + n_val :])
        return tuple(
            ADWDataset(x=self.x[p], beta=self.beta[p], seed=self.seed) for p in parts
        )

    def epoch_batches(self, generator: Optional[torch.Generator], batch_size: int, perm=None,
                      device=None, dtype: torch.dtype = torch.float32):
        """(n_batches, B, 1) samples and betas for one epoch, shuffled by
        ``torch.randperm`` from ``generator`` (a CPU generator), or in the
        order ``perm`` gives; the tail that fills no batch is dropped. Both
        land on ``device`` (default the CPU) in ``dtype``, one copy each."""
        n = len(self)
        nb = n // batch_size
        if perm is None:
            perm = torch.randperm(n, generator=generator).numpy()
        perm = np.asarray(perm)[: nb * batch_size]
        xs = torch.from_numpy(self.x[perm]).reshape(nb, batch_size, 1)
        bs = torch.from_numpy(self.beta[perm]).reshape(nb, batch_size, 1)
        return xs.to(device=device, dtype=dtype), bs.to(device=device, dtype=dtype)
