"""Analytic 1-D potentials and Boltzmann densities for the ADW experiments
(a copy of ti_tpu/analysis/potentials.py, whose only JAX was a type alias).

The asymmetric double well V(x) = a(x^2-1)^2 + b x appears in the reference
analysis layer (adw/analysis/reweight_gedmd.py:10-19) and, in commented-out
form, as a quadrature Boltzmann-density oracle (adw/thermo/utils.py:86-133).
Here both are first-class: the density/partition function/free-energy
quadratures are the exact oracles the test suite validates transport and
dlogp against (SURVEY.md §4).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class AsymmetricDoubleWell:
    """V(x) = a (x^2 - 1)^2 + b x (reference defaults a=4, b=0.5), of numpy
    arrays or torch tensors alike."""

    a: float = 4.0
    b: float = 0.5

    def __call__(self, x):
        return self.a * (x**2 - 1.0) ** 2 + self.b * x

    def grad(self, x):
        return 4.0 * self.a * (x**3 - x) + self.b


@dataclasses.dataclass(frozen=True)
class BoltzmannDensity1D:
    """Quadrature Boltzmann density p(x) ∝ exp(-beta V(x)) on a 1-D grid."""

    beta: float
    potential: AsymmetricDoubleWell = AsymmetricDoubleWell()
    x_lo: float = -50.0
    x_hi: float = 50.0
    n_grid: int = 100_000

    def _grid(self):
        return np.linspace(self.x_lo, self.x_hi, self.n_grid)

    def partition_function(self) -> float:
        x = self._grid()
        return float(np.trapezoid(np.exp(-self.beta * np.asarray(self.potential(x))), x))

    def log_partition_function(self) -> float:
        # log-sum-exp quadrature, stable for large beta
        x = self._grid()
        logu = -self.beta * np.asarray(self.potential(x))
        mx = logu.max()
        return float(mx + np.log(np.trapezoid(np.exp(logu - mx), x)))

    def pdf(self, x):
        return np.exp(self.logpdf(x))

    def logpdf(self, x):
        return -self.beta * np.asarray(self.potential(x)) - self.log_partition_function()

    def free_energy(self) -> float:
        """F = -log Z / beta (in the reduced units of the experiments)."""
        return -self.log_partition_function() / self.beta

    def sample(self, seed, n: int) -> np.ndarray:
        """Exact i.i.d. samples by inverse-CDF on the quadrature grid —
        the synthetic stand-in for the reference's MD dataset
        (adw dataset 'samples.csv', adw/data/dataset.py:61-66)."""
        rng = np.random.default_rng(seed)
        x = self._grid()
        logu = -self.beta * np.asarray(self.potential(x))
        pdf = np.exp(logu - logu.max())
        cdf = np.cumsum(pdf)
        cdf = cdf / cdf[-1]
        u = rng.uniform(size=n)
        return np.interp(u, cdf, x)


def delta_f_quadrature(beta0: float, beta1: float, potential=None) -> float:
    """Exact dF = F(beta1) - F(beta0) with F = -log Z (reduced units,
    matching the TFEP estimator convention of the analysis layer)."""
    pot = potential or AsymmetricDoubleWell()
    z0 = BoltzmannDensity1D(beta0, pot).log_partition_function()
    z1 = BoltzmannDensity1D(beta1, pot).log_partition_function()
    return -(z1 - z0)
