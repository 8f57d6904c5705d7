"""Kabsch alignment of the port (ti_torch/ops/kabsch.py) against ti_tpu's
and scipy's.

The rotation is unique for a covariance of full rank, but the two SVDs may
return singular vectors of other signs, so the tests hold the rotated
points and the rotation itself, never U and V. Bars: against ti_tpu and
scipy rtol 1e-5 / atol 1e-5 in f32 (the SVD's rounding), 1e-10 in f64
against scipy; R orthonormal with det +1 to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from ti_tpu.ops.kabsch import kabsch_align as jax_kabsch_align
from ti_torch.ops.kabsch import kabsch_align


def _centred(rng, b, n, scale=1.0, dtype=np.float32):
    x = scale * rng.standard_normal((b, n, 3))
    return (x - x.mean(axis=1, keepdims=True)).astype(dtype)


def _rotation_of(x, y):
    """R with y = x R^T, by least squares (x of full rank)."""
    return np.linalg.lstsq(x, y, rcond=None)[0].T


@pytest.mark.parametrize("n", [5, 19])
def test_matches_ti_tpu_and_scipy(n):
    rng = np.random.default_rng(n)
    x, target = _centred(rng, 8, n), _centred(rng, 8, n, scale=0.3)
    out = kabsch_align(torch.from_numpy(x), torch.from_numpy(target)).numpy()
    ref = np.asarray(jax.vmap(jax_kabsch_align)(jnp.asarray(x), jnp.asarray(target)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    for b in range(8):
        sp = Rotation.align_vectors(target[b].astype(np.float64), x[b].astype(np.float64))[0]
        np.testing.assert_allclose(out[b], sp.apply(x[b]), rtol=1e-5, atol=1e-5)
        r = _rotation_of(x[b].astype(np.float64), out[b].astype(np.float64))
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
        assert abs(np.linalg.det(r) - 1.0) < 1e-5
    # the norms are kept and the aligned noise sits no farther from the target
    np.testing.assert_allclose(np.linalg.norm(out, axis=(1, 2)), np.linalg.norm(x, axis=(1, 2)),
                               rtol=1e-5)
    assert np.all(np.sum((out - target) ** 2, axis=(1, 2))
                  <= np.sum((x - target) ** 2, axis=(1, 2)) + 1e-5)


def test_recovers_a_known_rotation_in_f64():
    rng = np.random.default_rng(0)
    x = _centred(rng, 4, 7, dtype=np.float64)
    rots = Rotation.random(4, random_state=1).as_matrix()
    target = np.einsum("bij,bnj->bni", rots, x)
    out = kabsch_align(torch.from_numpy(x), torch.from_numpy(target)).numpy()
    np.testing.assert_allclose(out, target, atol=1e-10)


def test_reflection_case_gives_a_proper_rotation():
    """A target that is the mirror image of x: the best orthogonal map is a
    reflection (det -1); the sign fix returns the best proper rotation
    instead, as ti_tpu and scipy do."""
    rng = np.random.default_rng(3)
    x = _centred(rng, 3, 6, dtype=np.float64)
    target = x * np.array([1.0, 1.0, -1.0])  # mirrored through the xy plane
    h = np.einsum("bni,bnj->bij", x, target)
    u, _, vt = np.linalg.svd(h)
    assert np.all(np.linalg.det(np.einsum("bji,bkj->bik", vt, u)) < 0)  # unfixed: det -1
    out = kabsch_align(torch.from_numpy(x), torch.from_numpy(target)).numpy()
    ref = np.asarray(jax.vmap(jax_kabsch_align)(jnp.asarray(x.astype(np.float32)),
                                                jnp.asarray(target.astype(np.float32))))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    for b in range(3):
        r = _rotation_of(x[b], out[b])
        assert abs(np.linalg.det(r) - 1.0) < 1e-8
        sp = Rotation.align_vectors(target[b], x[b])[0]
        np.testing.assert_allclose(out[b], sp.apply(x[b]), atol=1e-10)
        assert np.sum((out[b] - target[b]) ** 2) > 1e-3  # a rotation cannot mirror


def test_unbatched_and_on_the_inputs_device():
    rng = np.random.default_rng(5)
    x, target = _centred(rng, 1, 5)[0], _centred(rng, 1, 5)[0]
    one = kabsch_align(torch.from_numpy(x), torch.from_numpy(target))
    batch = kabsch_align(torch.from_numpy(x)[None], torch.from_numpy(target)[None])[0]
    assert one.shape == (5, 3) and one.device.type == "cpu" and one.dtype == torch.float32
    torch.testing.assert_close(one, batch)
