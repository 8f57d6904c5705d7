"""The port's atom order and z-matrices against ``ti_tpu``'s.

``ti_torch.analysis.sort_atoms`` is a copy of ``ti_tpu``'s numpy module: the
same order, groups and reference triplets on every topology, exactly.
``ti_torch.analysis.zmatrix`` is a torch rewrite of the JAX module (its
``lax.scan`` NeRF a loop over the placement order): every public function
on the same float32 inputs at rtol 1e-5 / atol 1e-6, torsions compared
modulo 2π (atan2 puts a torsion near ±π on either side), ``valid_z_mask``
exactly; round trips on a chain and on ring molecules; and the log|det J|
of the reconstruction against the Jacobian of the map itself in float64.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu.analysis import sort_atoms as jax_sort
from ti_tpu.analysis import zmatrix as jz
from ti_torch.analysis import sort_atoms
from ti_torch.analysis import zmatrix as tz
from ti_torch.data.mdqm9 import make_synthetic_molecule

RTOL, ATOL = 1e-5, 1e-6


def _wrap(a):
    """Differences of angles folded into (-pi, pi]."""
    return (a + np.pi) % (2 * np.pi) - np.pi


def _close_z(got, ref):
    """Z-matrices at the f32 bar, torsions (column 2) modulo 2π."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got[..., :2], ref[..., :2], rtol=RTOL, atol=ATOL)
    t_err = np.abs(_wrap(got[..., 2] - ref[..., 2]))
    assert np.all(t_err <= ATOL + RTOL * np.abs(ref[..., 2])), t_err.max()


def _z_err(got, ref):
    """Largest difference of two z-matrices, torsions modulo 2π."""
    return max(np.abs(got[..., :2] - ref[..., :2]).max(),
               np.abs(_wrap(got[..., 2] - ref[..., 2])).max())


def _chain_refs(n):
    refs = [[None, None, None], [0, None, None], [1, 0, None]]
    for i in range(3, n):
        refs.append([i - 1, i - 2, i - 3])
    return refs


def _bidirectional(bonds):
    bi = np.array(bonds).T
    return np.concatenate([bi, bi[::-1]], axis=1)


def _ring_with_hydrogens(n_ring, h_per_atom=1):
    bonds = [(i, (i + 1) % n_ring) for i in range(n_ring)]
    nat = n_ring
    for i in range(n_ring):
        for _ in range(h_per_atom):
            bonds.append((i, nat))
            nat += 1
    return nat, _bidirectional(bonds)


def _fused_bicyclic():
    bonds = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0),
             (4, 6), (6, 7), (7, 8), (8, 9), (9, 5)]
    nat = 10
    for i in [0, 1, 2, 3, 6, 7, 8, 9]:
        bonds.append((i, nat))
        nat += 1
    return nat, _bidirectional(bonds)


def _ring_with_branch():
    bonds = [(i, (i + 1) % 6) for i in range(6)] + [(0, 6), (6, 7), (6, 8), (6, 9)]
    nat = 10
    for i in range(1, 6):
        bonds.append((i, nat))
        nat += 1
    return nat, _bidirectional(bonds)


def _random_polycyclic(seed):
    """tests/test_zmatrix.py's random connected graphs with 1-3 extra
    ring-closing edges."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 16))
    bonds = [(int(rng.integers(0, i)), i) for i in range(1, n)]
    for _ in range(int(rng.integers(1, 4))):
        a, b = rng.choice(n, 2, replace=False)
        if (a, b) not in bonds and (b, a) not in bonds:
            bonds.append((int(a), int(b)))
    return n, _bidirectional(bonds)


def _synthetic(n):
    mol = make_synthetic_molecule(n, seed=0)
    return n, mol.bond_index


TOPOLOGIES = {
    "two_atoms": lambda: (2, np.array([[0], [1]])),
    "triangle": lambda: _ring_with_hydrogens(3),
    "benzene": lambda: _ring_with_hydrogens(6),
    "pure_ring": lambda: _ring_with_hydrogens(8, h_per_atom=0),
    "fused_bicyclic": _fused_bicyclic,
    "ring_with_branch": _ring_with_branch,
    "synthetic_19": lambda: _synthetic(19),
    "synthetic_29": lambda: _synthetic(29),
    **{f"polycyclic_{s}": (lambda s=s: _random_polycyclic(s)) for s in range(20)},
}


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_sort_atoms_matches_jax_exactly(name):
    n, bi = TOPOLOGIES[name]()
    adj = sort_atoms.adjacency_from_bonds(n, bi)
    np.testing.assert_array_equal(adj, jax_sort.adjacency_from_bonds(n, bi))
    if n > 2 and adj.sum(axis=1).max() == 1:
        pytest.fail("degenerate draw")  # none of the seeds above draws one
    assert sort_atoms.compute_atom_order_and_references_groups(adj) == \
        jax_sort.compute_atom_order_and_references_groups(adj)


def _points(shape, seed, scale=2.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_geometry_primitives_match_jax():
    p = _points((4, 64, 3), seed=0)
    t = [torch.from_numpy(a) for a in p]
    j = [jnp.asarray(a) for a in p]
    np.testing.assert_allclose(tz.compute_distance(*t[:2]).numpy(),
                               np.asarray(jz.compute_distance(*j[:2])), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tz.compute_angle(*t[:3]).numpy(),
                               np.asarray(jz.compute_angle(*j[:3])), rtol=RTOL, atol=ATOL)
    got, ref = tz.compute_torsion(*t).numpy(), np.asarray(jz.compute_torsion(*j))
    assert np.all(np.abs(_wrap(got - ref)) <= ATOL + RTOL * np.abs(ref))
    # the unit cases of tests/test_zmatrix.py
    x = torch.tensor([[0.0, 0, 0], [1, 0, 0], [1, 1, 0], [1, 1, 1]])
    assert float(tz.compute_distance(x[0], x[1])) == pytest.approx(1.0)
    assert float(tz.compute_angle(x[0], x[1], x[2])) == pytest.approx(np.pi / 2, rel=1e-6)
    assert float(tz.compute_torsion(*x)) == pytest.approx(np.pi / 2, rel=1e-6)


def test_ic_to_xyz_matches_jax():
    p1, p2, p3 = _points((3, 64, 3), seed=1)
    rng = np.random.default_rng(2)
    d = rng.uniform(0.8, 2.0, 64).astype(np.float32)
    a = rng.uniform(0.3, 2.8, 64).astype(np.float32)
    tor = rng.uniform(-3.1, 3.1, 64).astype(np.float32)
    pos, det = tz.ic_to_xyz(*(torch.from_numpy(v) for v in (p1, p2, p3, d, a, tor)))
    rpos, rdet = jax.vmap(jz.ic_to_xyz)(*(jnp.asarray(v) for v in (p1, p2, p3, d, a, tor)))
    np.testing.assert_allclose(pos.numpy(), np.asarray(rpos), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(det.numpy(), np.asarray(rdet), rtol=RTOL, atol=ATOL)


def _molecule_case(name, b=16, seed=0):
    """(sorted cartesians (b, N, 3) float32, ref_atoms) of a topology."""
    n, bi = TOPOLOGIES[name]()
    order, _, refs = sort_atoms.compute_atom_order_and_references_groups(
        sort_atoms.adjacency_from_bonds(n, bi))
    x = _points((b, n, 3), seed)
    return x[:, np.asarray(order)], refs


def _z_case(n, b, seed):
    rng = np.random.default_rng(seed)
    z = np.zeros((b, n - 1, 3), dtype=np.float32)
    z[..., 0] = rng.uniform(1.0, 1.8, (b, n - 1))
    z[:, 1:, 1] = rng.uniform(0.5, 2.5, (b, n - 2))
    z[:, 2:, 2] = rng.uniform(-3.0, 3.0, (b, n - 3))
    return z


def _jax_construct(x, refs, placing_order=None):
    """ti_tpu's construct_z_matrix op by op, as its gen_z_matrix runs it
    (under jit XLA rounds the cosines otherwise, and an angle near 0 or π
    moves by up to sqrt(2 ulp) ~ 3e-4 with them)."""
    return np.asarray(jz.construct_z_matrix(jnp.asarray(x), refs, placing_order))


@pytest.mark.parametrize("name", ["benzene", "synthetic_19"])
def test_construct_z_matrix_matches_jax(name):
    x, refs = _molecule_case(name)
    got = tz.construct_z_matrix(torch.from_numpy(x), refs)
    _close_z(got.numpy(), _jax_construct(x, refs))
    assert tz.construct_z_matrix_batch is tz.construct_z_matrix
    # a placing order over unsorted cartesians
    perm = np.random.default_rng(4).permutation(x.shape[1])
    _close_z(tz.construct_z_matrix(torch.from_numpy(x), refs, placing_order=perm).numpy(),
             _jax_construct(x, refs, perm))
    if name == "synthetic_19":  # one conformation, no leading axis
        _close_z(tz.construct_z_matrix(torch.from_numpy(x[3]), refs).numpy(),
                 _jax_construct(x[3], refs))


@pytest.mark.parametrize("name", ["chain", "synthetic_19"])
def test_deconstruct_and_jacobian_match_jax(name):
    if name == "chain":
        refs, n = _chain_refs(7), 7
    else:
        _, refs = _molecule_case(name, b=1)
        n = len(refs)
    z = _z_case(n, 12, seed=5)
    cart, logdet = tz.deconstruct_z_matrix_batch(torch.from_numpy(z), refs)
    rcart, rlogdet = jax.jit(lambda a: jz.deconstruct_z_matrix_batch(a, refs))(jnp.asarray(z))
    assert cart.shape == (12, n, 3) and cart.dtype == torch.float32
    np.testing.assert_allclose(cart.numpy(), np.asarray(rcart), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logdet.numpy(), np.asarray(rlogdet), rtol=RTOL, atol=ATOL)
    ref_jac = jax.jit(lambda a: jz.compute_jacobian_batch(a, refs))(jnp.asarray(z))
    np.testing.assert_allclose(tz.compute_jacobian_batch(torch.from_numpy(z), refs).numpy(),
                               np.asarray(ref_jac), rtol=RTOL, atol=ATOL)
    # one z-matrix, with and without the Jacobian
    one, one_ld = tz.deconstruct_z_matrix(torch.from_numpy(z[0]), refs)
    ref_one, ref_ld = jax.jit(lambda a: jz.deconstruct_z_matrix(a, refs))(jnp.asarray(z[0]))
    np.testing.assert_allclose(one.numpy(), np.asarray(ref_one), rtol=RTOL, atol=ATOL)
    assert float(one_ld) == pytest.approx(float(ref_ld), rel=RTOL, abs=ATOL)
    bare = tz.deconstruct_z_matrix(torch.from_numpy(z[0]), refs, jacobian=False)
    assert torch.equal(bare, one)
    assert torch.equal(tz.deconstruct_z_matrix_batch(torch.from_numpy(z), refs, jacobian=False),
                       cart)


def test_log_det_of_zero_distance_is_minus_inf_in_both():
    """``+ 1e-300`` rounds to 0 in float32: a zero distance gives -inf."""
    refs = _chain_refs(6)
    z = _z_case(6, 1, seed=6)[0]
    z[3, 0] = 0.0
    _, ld = tz.deconstruct_z_matrix(torch.from_numpy(z), refs)
    _, rld = jax.jit(lambda a: jz.deconstruct_z_matrix(a, refs))(jnp.asarray(z))
    assert float(ld) == float(rld) == -math.inf
    assert float(tz.compute_jacobian_batch(torch.from_numpy(z), refs)) == -math.inf


def test_valid_z_mask_matches_jax_exactly():
    z = _z_case(8, 64, seed=7)
    pi32 = np.float32(np.pi)
    # edges: zero and negative distances, angles at 0, at pi (float32) and
    # past it, torsions at -pi and pi (float32) and past them
    z[1, 2, 0], z[2, 4, 0] = 0.0, -0.1
    z[3, 1, 1], z[4, 3, 1], z[5, 5, 1], z[6, 2, 1] = 0.0, pi32, np.nextafter(pi32, 4), -1e-7
    z[7, 2, 2], z[8, 3, 2], z[9, 4, 2], z[10, 5, 2] = -pi32, pi32, np.nextafter(pi32, 4), -3.2
    got = tz.valid_z_mask(torch.from_numpy(z)).numpy()
    ref = np.asarray(jz.valid_z_mask(jnp.asarray(z)))
    np.testing.assert_array_equal(got, ref)
    assert got[0] and not got[1:3].any() and got[3] and got[4] and not got[5:7].any()
    assert not got[7] and got[8] and not got[9:11].any()


@pytest.mark.parametrize("name", ["chain", "triangle", "benzene", "fused_bicyclic",
                                  "synthetic_19"])
def test_round_trip(name):
    """construct -> deconstruct -> construct returns the z-matrix (the
    internal coordinates do not see the rigid placement frame), and
    deconstruct -> construct returns a z-matrix drawn in range."""
    if name == "chain":
        refs = _chain_refs(8)
        x = _points((16, 8, 3), seed=8)
    else:
        x, refs = _molecule_case(name, seed=8)
    z = tz.construct_z_matrix(torch.from_numpy(x), refs)
    back, ld = tz.deconstruct_z_matrix(z, refs)
    assert _z_err(tz.construct_z_matrix(back, refs).numpy(), z.numpy()) <= 1e-4
    assert torch.isfinite(ld).all()
    zd = _z_case(len(refs), 16, seed=9)
    back = tz.deconstruct_z_matrix(torch.from_numpy(zd), refs, jacobian=False)
    assert _z_err(tz.construct_z_matrix(back, refs).numpy(), zd) <= 1e-4


@pytest.mark.parametrize("name", ["chain", "triangle"])
def test_log_det_matches_numerical_jacobian_f64(name):
    """log|det J| of z -> cartesian, on the 3N - 6 free coordinates (atom
    1's x, atom 2's x and y, every later atom's three), against slogdet of
    that map's Jacobian (autograd) in float64 (tests/test_zmatrix.py:68,
    276)."""
    if name == "chain":
        refs = _chain_refs(5)
        z = _z_case(5, 1, seed=2)[0].astype(np.float64)
    else:
        x, refs = _molecule_case(name, b=1, seed=5)
        z = tz.construct_z_matrix(torch.from_numpy(x[0]).double(), refs).numpy()
    n = len(refs)
    zt = torch.from_numpy(z)
    _, logdet = tz.deconstruct_z_matrix(zt, refs)
    assert logdet.dtype == torch.float64

    def free_coords(zflat):
        zz = torch.zeros(n - 1, 3, dtype=torch.float64)
        zz = zz.index_put((torch.arange(n - 1), torch.zeros(n - 1, dtype=torch.long)),
                          zflat[: n - 1])
        zz = zz.index_put((torch.arange(1, n - 1), torch.ones(n - 2, dtype=torch.long)),
                          zflat[n - 1: 2 * n - 3])
        zz = zz.index_put((torch.arange(2, n - 1), torch.full((n - 3,), 2, dtype=torch.long)),
                          zflat[2 * n - 3:])
        cart = tz.deconstruct_z_matrix(zz, refs, jacobian=False)
        return torch.cat([cart[1, :1], cart[2, :2], cart[3:].reshape(-1)])

    zflat = torch.cat([zt[:, 0], zt[1:, 1], zt[2:, 2]])
    jac = torch.autograd.functional.jacobian(free_coords, zflat)
    _, num_logdet = np.linalg.slogdet(jac.numpy())
    assert float(logdet) == pytest.approx(num_logdet, rel=1e-10, abs=1e-10)
