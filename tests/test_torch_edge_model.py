"""The edge (gather/scatter) form of the port's cPaiNN, ``apply_edge``,
against the JAX package's flax module and against the port's dense form.

Same weights (a flax ``CPaiNN.init`` carried across with
``params_from_flax``) and the same numpy inputs go through both. Bars:
against ti_tpu's ``model.apply`` (the same edge layout) rtol 1e-4 / atol
1e-5, the f32 bar of tests/test_torch_model.py; against the dense pair form
(another summation order) rtol 2e-3 / atol 2e-4, the bar of
tests/test_pallas_kernels.py::test_dense_forward_matches_model_apply. The
symmetry checks take the bars of tests/test_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.models.cpainn import MolGraph
from ti_tpu.ops.graph import EdgeTable as JaxEdgeTable
from ti_tpu.sampling.drivers import molecular_v_fn_of as jax_v_fn_of
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.convert import params_from_flax
from ti_torch.models.cpainn import CPaiNN, apply_edge
from ti_torch.models.cpainn_dense import apply_dense
from ti_torch.ops.graph import EdgeTable, edge_aggregate
from ti_torch.sampling.drivers import molecular_v_fn_of

N_ATOMS, F, LAYERS, B = 6, 16, 2, 3
SAME_LAYOUT = dict(rtol=1e-4, atol=1e-5)
DENSE_BAR = dict(rtol=2e-3, atol=2e-4)
N_COND = {"ambient": 2, "latent": 1, "none": 0}


def _inputs(seed=1, scale=0.6):
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    t = np.array([0.2, 0.5, 0.9], np.float32)
    temps = np.tile(np.array([700.0, 300.0], np.float32), (B, 1))
    return x, t, temps


def _models(conditioning="ambient", cutoff=None):
    jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=N_COND[conditioning])
    jm = JaxCPaiNN(n_features=F, score_layers=LAYERS, conditioning=conditioning, cutoff=cutoff)
    jp = jm.init(jax.random.PRNGKey(0), jt)
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    model = CPaiNN(F, LAYERS, n_atoms=N_ATOMS, conditioning=conditioning, cutoff=cutoff)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0),
                              t_cond=N_COND[conditioning])
    return jm, jp, jt, params, model, template


def _jax_apply(jm, jp, atom_ids, edges, x, t, temps):
    return np.asarray(jax.vmap(lambda xx, tt, tp: jm.apply(
        jp, MolGraph(xx, atom_ids, tt, tp, edges)))(jnp.asarray(x), jnp.asarray(t),
                                                     jnp.asarray(temps)))


def _edge(model, params, template, x, t, temps, edges=None):
    return apply_edge(model, params, torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(temps), template.atom_ids,
                      template.edges if edges is None else edges).numpy()


@pytest.mark.parametrize("conditioning", ["ambient", "latent", "none"])
def test_edge_form_matches_jax_model_apply(conditioning):
    jm, jp, jt, params, model, template = _models(conditioning)
    x, t, temps = _inputs()
    temps = temps[:, :N_COND[conditioning]]
    ref = _jax_apply(jm, jp, jt.atom_ids, jt.edges, x, t, temps)
    out = _edge(model, params, template, x, t, temps)
    assert out.shape == (B, N_ATOMS, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **SAME_LAYOUT)


@pytest.mark.parametrize("cutoff", [None, 1.1])
def test_edge_form_matches_dense_form(cutoff):
    """The edge and dense layouts of one field, on the complete graph and
    with a finite cutoff that drops non-bonded pairs (bond pairs stay)."""
    _jm, _jp, _jt, params, model, template = _models(cutoff=cutoff)
    mol = make_synthetic_molecule(N_ATOMS, seed=0)
    rng = np.random.default_rng(2)
    base = (mol.positions - mol.positions.mean(0)).astype(np.float32)
    x = (base[None] + 0.1 * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    _x, t, temps = _inputs()
    if cutoff is not None:
        d = np.linalg.norm(x[:, None] - x[:, :, None], axis=-1)
        assert (d > cutoff).any() and ((d <= cutoff) & (d > 0)).any()
    out = _edge(model, params, template, x, t, temps)
    dense = apply_dense(model, params, torch.from_numpy(x), torch.from_numpy(t),
                        torch.from_numpy(temps), template.atom_ids, template.edges).numpy()
    np.testing.assert_allclose(out, dense, **DENSE_BAR)


def test_cutoff_mask_equals_radius_graph_and_matches_jax():
    """A finite cutoff on the complete graph equals the explicit radius
    graph (bond edges kept past the cutoff), which is not complete and so
    takes ``edge_aggregate``'s index_add branch; both match ti_tpu's
    module on the same edge tables."""
    mol = make_synthetic_molecule(N_ATOMS, seed=0)
    x = (mol.positions - mol.positions.mean(0)).astype(np.float32)[None].repeat(B, 0)
    x = x + (0.05 * np.random.default_rng(3).standard_normal(x.shape)).astype(np.float32)
    _x, t, temps = _inputs()
    d = np.linalg.norm(x[0][None] - x[0][:, None], axis=-1)
    cutoff = float(np.median(d[d > 0]))
    jm_cut, jp, jt, params, model_cut, template = _models(cutoff=cutoff)
    jm_full, _, _, _, model_full, _ = _models()

    full = template.edges
    keep = (full.edge_type > 0) | (d[full.src, full.dst] <= cutoff)
    assert 0 < keep.sum() < len(keep)
    radius = EdgeTable(src=full.src[keep], dst=full.dst[keep], edge_type=full.edge_type[keep],
                       n_nodes=N_ATOMS, dst_major_complete=False)
    x = x[:1].repeat(B, 0)  # one geometry: the radius graph is built from it
    masked = _edge(model_cut, params, template, x, t, temps)
    explicit = _edge(model_full, params, template, x, t, temps, edges=radius)
    np.testing.assert_allclose(masked, explicit, rtol=1e-5, atol=1e-6)
    complete = _edge(model_full, params, template, x, t, temps)
    assert np.abs(masked - complete).max() > 1e-5

    jradius = JaxEdgeTable(src=jnp.asarray(radius.src), dst=jnp.asarray(radius.dst),
                           edge_type=jnp.asarray(radius.edge_type), n_nodes=N_ATOMS,
                           dst_major_complete=False)
    np.testing.assert_allclose(explicit, _jax_apply(jm_full, jp, jt.atom_ids, jradius, x, t,
                                                    temps), **SAME_LAYOUT)
    np.testing.assert_allclose(masked, _jax_apply(jm_cut, jp, jt.atom_ids, jt.edges, x, t,
                                                  temps), **SAME_LAYOUT)


def test_edge_aggregate_branches_agree():
    edges = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2).edges
    msgs = torch.randn(2, len(edges.src), 4, 3, generator=torch.Generator().manual_seed(0))
    scattered = EdgeTable(edges.src, edges.dst, edges.edge_type, N_ATOMS, False)
    dense = edge_aggregate(msgs, edges, dim=1)
    assert dense.shape == (2, N_ATOMS, 4, 3)
    torch.testing.assert_close(edge_aggregate(msgs, scattered, dim=1), dense,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(edge_aggregate(msgs[0], edges), dense[0], rtol=0, atol=0)


def _rotation(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


def test_edge_form_symmetries():
    """Rotation equivariance (rtol 2e-3 / atol 2e-5), translation
    invariance (rtol 1e-4 / atol 1e-5), and chirality: a reflection is not
    equivariant (the cross term breaks mirror symmetry)."""
    _jm, _jp, _jt, params, model, template = _models()
    x, t, temps = _inputs()
    x = x - x.mean(1, keepdims=True)
    rng = np.random.default_rng(4)
    out = _edge(model, params, template, x, t, temps)
    r = _rotation(rng)
    np.testing.assert_allclose(_edge(model, params, template, x @ r.T, t, temps), out @ r.T,
                               rtol=2e-3, atol=2e-5)
    shift = np.array([1.0, -2.0, 0.5], np.float32)
    np.testing.assert_allclose(_edge(model, params, template, x + shift, t, temps), out,
                               rtol=1e-4, atol=1e-5)
    p = np.diag([1.0, 1.0, -1.0]).astype(np.float32)
    assert np.abs(_edge(model, params, template, x @ p.T, t, temps) - out @ p.T).max() > 1e-4


def test_v_fn_of_edge_matches_jax_and_dense():
    """``molecular_v_fn_of(impl="edge")`` against ti_tpu's, chain by chain,
    and against the port's dense velocity; f32 only."""
    jm, jp, jt, params, model, template = _models()
    x, _t, temps = _inputs()
    v = molecular_v_fn_of(model, params, template, impl="edge", device="cpu")(
        torch.from_numpy(temps))
    out = v(torch.from_numpy(x), 0.4).numpy()
    jv_of = jax_v_fn_of(jm, jp, jt, impl="edge")
    for i in range(B):
        ref = np.asarray(jv_of(jnp.asarray(temps[i]))(jnp.asarray(x[i]), 0.4))
        np.testing.assert_allclose(out[i], ref, **SAME_LAYOUT)
    dense = molecular_v_fn_of(model, params, template, device="cpu")(torch.from_numpy(temps))
    np.testing.assert_allclose(out, dense(torch.from_numpy(x), 0.4).numpy(), **DENSE_BAR)
    with pytest.raises(ValueError, match="f32"):
        molecular_v_fn_of(model, params, template, impl="edge", compute_dtype="bf16_agg",
                          device="cpu")
