"""Symbolic dictionary evaluation for gEDMD (reference gedmd/util.py:128-224).

The port of ti_tpu/gedmd/symbolic.py. The reference's ``Sym2numeric``
lambdifies every basis function AND every symbolic 1st/2nd derivative
separately (n + n*d + n*d*d lambdified callables, evaluated in python
loops). Here sympy stays only the *input format*: each expression is
lambdified once with sympy's torch printer, and derivatives come from
forward-mode autodiff (``torch.func.jacfwd``), vmapped over the sample
axis, so the whole basis, its gradient and its Hessian are each one
batched program — no symbolic differentiation.

API parity: ``SymbolicBasis(psi_list, var_list)(x)``, ``.diff(x)``,
``.ddiff(x)`` with the reference's shapes ((n, m), (n, d, m),
(n, d, d, m) for x of shape (d, m)), returned as numpy arrays. ``ndiff``
is accepted for drop-in compatibility but unnecessary. sympy is imported
in ``__init__``, so the module imports where sympy is absent.

Note: the reference never calls Sym2numeric from any pipeline (dead code,
PARITY.md); it is provided for users of the original API.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ti_torch import resolve_device


class SymbolicBasis:
    """Evaluate a sympy-defined basis set and its derivatives in float32 (as
    ti_tpu evaluates with x64 off), on ``cuda`` unless ``device`` says
    otherwise."""

    def __init__(self, psi_list: Sequence, var_list: Sequence, ndiff: int = 2, device=None):
        import sympy

        self.psi = list(psi_list)
        self.var = list(var_list)
        self.n = len(self.psi)
        self.d = len(self.var)
        self.ndiff = ndiff
        self.device = resolve_device(device)

        fns = [sympy.lambdify(self.var, p, modules="torch") for p in self.psi]

        def eval_point(xp):  # (d,) -> (n,)
            # constant expressions lambdify to python numbers independent of
            # x: broadcast them to the point's shape so stack and jacfwd see
            # uniform shapes
            vals = [f(*xp.unbind(0)) for f in fns]
            return torch.stack([v if torch.is_tensor(v) else torch.full_like(xp[0], float(v))
                                for v in vals])

        # x arrives as (d, m); vmap over the trailing sample axis
        self._eval = vmap(eval_point, in_dims=1, out_dims=1)
        self._grad = vmap(jacfwd(eval_point), in_dims=1, out_dims=2)
        self._hess = vmap(jacfwd(jacfwd(eval_point)), in_dims=1, out_dims=3)

    def _x(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def __call__(self, x) -> np.ndarray:
        """(d, m) -> (n, m) basis values."""
        return self._eval(self._x(x)).cpu().numpy()

    def diff(self, x) -> np.ndarray:
        """(d, m) -> (n, d, m) gradients."""
        return self._grad(self._x(x)).cpu().numpy()

    def ddiff(self, x) -> np.ndarray:
        """(d, m) -> (n, d, d, m) Hessians."""
        return self._hess(self._x(x)).cpu().numpy()


# reference-compatible alias (gedmd/util.py:128)
Sym2numeric = SymbolicBasis
