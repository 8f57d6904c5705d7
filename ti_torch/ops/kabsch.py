"""Closed-form Kabsch alignment (port of ti_tpu/ops/kabsch.py).

The latent data pipeline rotates each noise draw onto its data frame
before pairing them (the reference's ``Rotation.align_vectors`` call,
mdqm9/data/mdqm9_latent.py:103-105). Here it is one batched SVD of the
3 x 3 covariances, on whatever device the inputs lie.
"""

from __future__ import annotations

import torch


def kabsch_align(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., N, 3) onto ``target`` (..., N, 3): returns the rows
    of R x for the proper rotation R (det +1) that minimises |R x - target|²,
    per leading index.

    Equals scipy's ``Rotation.align_vectors(a=target, b=x)[0].apply(x)``.
    The inputs are taken as centred (the callers remove the centre of mass
    first). R is unique for a covariance of full rank; the singular vectors'
    signs, which differ between SVD implementations, cancel in it.
    """
    h = x.transpose(-1, -2) @ target  # (..., 3, 3) covariance
    u, _, vt = torch.linalg.svd(h)
    d = torch.sign(torch.linalg.det(vt.transpose(-1, -2) @ u.transpose(-1, -2)))
    s = torch.ones(h.shape[:-1], dtype=h.dtype, device=h.device)
    s[..., 2] = d  # the reflection fix: flip the least singular direction
    r = vt.transpose(-1, -2) @ (s[..., :, None] * u.transpose(-1, -2))
    return x @ r.transpose(-1, -2)
