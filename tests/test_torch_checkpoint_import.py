"""Reference checkpoints into the port (ti_torch.utils.torch_import) against
ti_tpu's import (ti_tpu/utils/torch_import.py).

The reference's torch state dicts are built here from a seed, in its
layout (``tests/test_torch_import.py``'s builders: the FCNetMultiBeta
module and the cPaiNN names and shapes of all three conditionings), and
saved with ``torch.save``. Both packages load the same file:

- the flax-layout trees are equal leaf for leaf (the same numpy map);
- the port's state, loaded into ``FCNetMultiBeta`` and ``CPaiNN``, gives
  the outputs of ti_tpu's flax ``apply`` on its tree at rtol 1e-5 / atol
  1e-6, ``tests/test_torch_import.py``'s bar. FCNetMultiBeta is compared
  in f32; cPaiNN in f64 on both sides, as ``test_torch_import.py``'s cPaiNN
  golden test does (its random LayerNorm weights amplify f32 rounding to
  about 1e-2 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_import import _synthetic_cpainn_state_dict, _torch_fcnet
from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.models.cpainn import MolGraph
from ti_tpu.models.mlp import FCNetMultiBeta as JaxFCNet
from ti_tpu.utils import torch_import as jax_import
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.convert import params_from_flax
from ti_torch.models.cpainn import CPaiNN, apply_edge
from ti_torch.models.mlp import FCNetMultiBeta
from ti_torch.utils import torch_import

HID, FC_LAYERS = 32, 3  # tests/test_torch_import.py's FCNetMultiBeta
F, LAYERS, N_ATOMS, B = 16, 2, 6, 3
N_COND = {"ambient": 2, "latent": 1, "none": 0}
BAR = dict(rtol=1e-5, atol=1e-6)


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_trees_equal(ours, ref):
    a, b = dict(_leaves(ours)), dict(_leaves(jax.tree_util.tree_map(np.asarray, ref)))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def fcnet_file(tmp_path_factory):
    torch.manual_seed(0)
    path = tmp_path_factory.mktemp("ckpt") / "fcnet.pt"
    torch.save(_torch_fcnet().state_dict(), path)
    return str(path)


def test_load_torch_state_dict_matches_jax(fcnet_file):
    ours, ref = torch_import.load_torch_state_dict(fcnet_file), \
        jax_import.load_torch_state_dict(fcnet_file)
    assert ours.keys() == ref.keys()
    assert all(isinstance(v, np.ndarray) and np.array_equal(v, ref[k]) for k, v in ours.items())


def test_fcnet_import_matches_jax(fcnet_file):
    sd = torch_import.load_torch_state_dict(fcnet_file)
    tree = torch_import.fcnet_params_from_torch(sd, num_layers=FC_LAYERS)
    ref = jax_import.fcnet_params_from_torch(sd, num_layers=FC_LAYERS)
    _assert_trees_equal(tree, ref)

    state = torch_import.fcnet_state_from_torch(fcnet_file, FC_LAYERS, device="cpu")
    model = FCNetMultiBeta(hidden_size=HID, num_layers=FC_LAYERS)
    model.load_state_dict(state)  # strict: every name of the port's module
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 1)).astype(np.float32)
    t = rng.uniform(0, 1, (16, 1)).astype(np.float32)
    b0, b1 = np.full((16, 1), 1.0, np.float32), np.full((16, 1), 1.25, np.float32)
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in (x, t, b0, b1))).numpy()
    want = np.asarray(JaxFCNet(hidden_size=HID, num_layers=FC_LAYERS).apply(
        jax.tree_util.tree_map(jnp.asarray, ref), *(jnp.asarray(a) for a in (x, t, b0, b1))))
    assert out.shape == (16, 1)
    np.testing.assert_allclose(out, want, **BAR)


@pytest.mark.parametrize("conditioning", ["ambient", "latent", "none"])
def test_cpainn_import_matches_jax(conditioning, tmp_path):
    """Three conditionings (``_NET_INDEX``): the tree, the state the port's
    ``CPaiNN`` loads strictly, and its edge forward (``apply_edge``, the
    port of the flax module's ``__call__``) against ti_tpu's ``apply`` on
    the same complete graph, in f64."""
    sd_t = _synthetic_cpainn_state_dict(F, LAYERS, conditioning)
    g = torch.Generator().manual_seed(3)  # non-identity LayerNorm affines
    for k in list(sd_t):
        if ".mlp.1." in k or ".mlp.4." in k:
            sd_t[k] = sd_t[k] + 0.2 * torch.randn(sd_t[k].shape, generator=g)
    path = tmp_path / "cpainn.pt"
    torch.save(sd_t, path)
    sd = torch_import.load_torch_state_dict(str(path))
    tree = torch_import.cpainn_params_from_torch(sd, LAYERS, conditioning)
    ref = jax_import.cpainn_params_from_torch(sd, score_layers=LAYERS,
                                              conditioning=conditioning)
    _assert_trees_equal(tree, ref)

    state = torch_import.cpainn_state_from_torch(str(path), LAYERS, conditioning, device="cpu")
    want_state = params_from_flax(ref)
    assert state.keys() == want_state.keys()
    assert all(torch.equal(state[k], want_state[k]) for k in state)
    # temp_length 10: the reference cPaiNN's default (tests/test_torch_import.py)
    model = CPaiNN(F, LAYERS, n_atoms=N_ATOMS, conditioning=conditioning, temp_length=10.0)
    model.load_state_dict(state)

    k = N_COND[conditioning]
    rng = np.random.default_rng(5)
    x = 0.3 * rng.standard_normal((B, N_ATOMS, 3))
    t = np.array([0.1, 0.37, 0.8])
    temps = np.tile(np.array([700.0, 300.0]), (B, 1))[:, :k]
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=k)
    out = apply_edge(model, {n: v.double() for n, v in state.items()}, torch.from_numpy(x),
                     torch.from_numpy(t), torch.from_numpy(temps), template.atom_ids,
                     template.edges).numpy()
    jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=k)
    jm = JaxCPaiNN(n_features=F, score_layers=LAYERS, conditioning=conditioning,
                   temp_length=10.0)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), ref)
        want = np.asarray(jax.jit(jax.vmap(lambda p, xx, tt, tp: jm.apply(
            p, MolGraph(xx, jt.atom_ids, tt, tp, jt.edges)), in_axes=(None, 0, 0, 0)))(
            p64, jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps)))
    assert out.shape == (B, N_ATOMS, 3) and out.dtype == np.float64
    np.testing.assert_allclose(out, want, **BAR)


def test_state_goes_to_the_card_unless_told(fcnet_file, monkeypatch):
    """No card and no ``device``: the composers raise, as every entry point
    of the port does; they never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_import.fcnet_state_from_torch(fcnet_file, FC_LAYERS)
