"""The PyTorch port's model layer against the JAX package: the weight
bridge, embeddings, MLP-block math and the dense cPaiNN forward.

Same weights (a flax ``CPaiNN.init`` carried across with
``params_from_flax``) and the same numpy inputs go through both. The f32
bar is rtol 1e-4 / atol 1e-5: looser than the JAX package's own
JAX-against-JAX bars because two BLAS libraries sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu.analysis import free_energy as jfe
from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.models.cpainn_dense import apply_dense as jax_apply_dense
from ti_tpu.models.embeddings import positional_encoding as jax_pe
from ti_tpu.models.embeddings import temperature_encoding as jax_te
from ti_tpu.ops import pallas_kernels as jpk
from ti_torch.analysis import free_energy as tfe
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.convert import load_npz, params_from_flax, params_to_flax, save_npz
from ti_torch.models.cpainn import CPaiNN
from ti_torch.models.cpainn_dense import apply_dense
from ti_torch.models.embeddings import positional_encoding, temperature_encoding
from ti_torch.ops import mlp_block as tmb

N_ATOMS, F, LAYERS, B = 6, 16, 2, 3


def _setup(cutoff=None):
    jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=2)
    jm = JaxCPaiNN(n_features=F, score_layers=LAYERS, conditioning="ambient", cutoff=cutoff)
    jp = JaxCPaiNN(n_features=F, score_layers=LAYERS).init(jax.random.PRNGKey(0), jt)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    model = CPaiNN(F, LAYERS, n_atoms=N_ATOMS, cutoff=cutoff)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2)
    rng = np.random.default_rng(1)
    x = (0.3 * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    t = np.array([0.2, 0.5, 0.9], np.float32)
    temps = np.tile(np.array([700.0, 300.0], np.float32), (B, 1))
    return jm, jp, jt, tree, model, template, x, t, temps


@pytest.fixture(scope="module")
def setup():
    return _setup()


def test_weight_bridge_round_trips_exactly(setup, tmp_path):
    *_, tree, model, _template, _x, _t, _temps = setup
    state = params_from_flax(tree)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)  # every shape fits the module
    back = params_to_flax(state)
    flat_a = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k])
    # Dense kernels are (in, out); nn.Linear weights are (out, in)
    np.testing.assert_array_equal(
        state["message_0.phi.Dense_0.weight"].numpy(),
        tree["params"]["message_0"]["phi"]["Dense_0"]["kernel"].T)
    path = tmp_path / "weights.npz"
    save_npz(str(path), state)
    assert "message_0/phi/Dense_0/kernel" in np.load(path).files
    again = load_npz(str(path))
    for k in state:
        assert torch.equal(again[k], state[k])


def test_embeddings_match_jax():
    x = np.linspace(-1.3, 2.7, 11).astype(np.float32)
    np.testing.assert_allclose(positional_encoding(torch.from_numpy(x), 16, 10.0).numpy(),
                               np.asarray(jax_pe(jnp.asarray(x), 16, 10.0)), rtol=1e-5, atol=1e-6)
    T = np.array([300.0, 650.0, 1000.0], np.float32)
    temps = (300.0, 400.0, 500.0, 600.0, 700.0, 800.0, 900.0, 1000.0)
    np.testing.assert_allclose(temperature_encoding(torch.from_numpy(T), 16, 100.0, temps).numpy(),
                               np.asarray(jax_te(jnp.asarray(T), 16, 100.0, temps)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("profile", ["f32", "bf16_agg"])
def test_mlp_block_matches_jax(setup, profile):
    *_, tree, _model, _template, _x, _t, _temps = setup
    sub = tree["params"]["message_0"]["phi"]
    jw = jpk.mlp_weights_from_flax(jax.tree_util.tree_map(jnp.asarray, sub))
    tw = tmb.mlp_weights(params_from_flax(tree), "message_0.phi")
    x = np.random.default_rng(2).standard_normal((7, 2 * F)).astype(np.float32)
    kw_j = dict(compute_dtype=jnp.bfloat16, bf16_out=True) if profile == "bf16_agg" else {}
    kw_t = dict(compute_dtype=torch.bfloat16, bf16_out=True) if profile == "bf16_agg" else {}
    ref = np.asarray(jpk._mlp_block(jnp.asarray(x), jw, **kw_j).astype(jnp.float32))
    out = tmb._mlp_block(torch.from_numpy(x), tw, **kw_t).float().numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    dx = np.random.default_rng(3).standard_normal((7, 2 * F)).astype(np.float32)
    o_j, d_j = jpk._mlp_block_jvp(jnp.asarray(x), jnp.asarray(dx), jw)
    o_t, d_t = tmb._mlp_block_jvp(torch.from_numpy(x), torch.from_numpy(dx), tw)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-4, atol=1e-5)


def test_submodule_forwards_match_the_functional_math(setup):
    """The nn.Module forwards of the MLP and the equivariant linear map
    compute what the functional forwards compute from the state dict."""
    *_, tree, model, _template, _x, _t, _temps = setup
    model.load_state_dict(params_from_flax(tree))
    state = dict(model.named_parameters())
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((7, 2 * F)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(model.message_0.phi(x),
                                   tmb._mlp_block(x, tmb.mlp_weights(state, "message_0.phi")))
        v = x[:, :F, None].expand(7, F, 3)
        torch.testing.assert_close(model.update_1.u(v),
                                   torch.einsum("nfc,gf->ngc", v, state["update_1.u.weight"]))


@pytest.mark.parametrize("profile", ["f32", "bf16_agg"])
def test_dense_forward_matches_jax(setup, profile):
    jm, jp, jt, tree, model, template, x, t, temps = setup
    cd = "bf16_agg" if profile == "bf16_agg" else None
    ref = np.asarray(jax_apply_dense(jm, jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps),
                                     jt.atom_ids, jt.edges, compute_dtype=cd))
    out = apply_dense(model, params_from_flax(tree), torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(temps), template.atom_ids, template.edges,
                      compute_dtype=cd).numpy()
    if cd is None:
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    else:  # the scaled bar of tests/test_pair_layer_kernel.py's bf16 profile
        scale = max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(out / scale, ref / scale, atol=4e-2)


def test_module_forward_and_cutoff_match_jax():
    jm, jp, jt, tree, model, template, x, t, temps = _setup(cutoff=0.35)
    model.load_state_dict(params_from_flax(tree))
    ref = np.asarray(jax_apply_dense(jm, jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps),
                                     jt.atom_ids, jt.edges))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(temps),
                    template.atom_ids, template.edges).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_free_energy_copy_matches_jax():
    rng = np.random.default_rng(4)
    e0, e1, dl, var = (rng.standard_normal(50) for _ in range(4))
    phis_t, keep_t = tfe.calc_phis_tfep(e0, e1, dl, k=10)
    phis_j, keep_j = jfe.calc_phis_tfep(e0, e1, dl, k=10)
    np.testing.assert_array_equal(keep_t, keep_j)
    assert tfe.calc_tfep_dF(tfe.debias_phis(phis_t, var[keep_t] ** 2)) == \
        jfe.calc_tfep_dF(jfe.debias_phis(phis_j, var[keep_j] ** 2))
