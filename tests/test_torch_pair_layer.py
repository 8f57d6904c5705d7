"""Kernel B1 (the pair-layer message kernel) of the PyTorch port.

On the CPU the wrapper takes the plain PyTorch version; it is held
against the JAX package's Pallas kernel run in interpret mode, on the same
flax weights and numpy inputs. Bars: the JAX package's own
(tests/test_pair_layer_kernel.py: f32 rtol 2e-5 / atol 2e-6 against
apply_dense; bf16 scaled atol 4e-2), the f32 one loosened 5x for the
cross-library summation order: rtol 1e-4 / atol 1e-5. The CUDA kernel
itself runs only on the card: tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.ops.pair_layer_kernel import apply_dense_pair_kernel as jax_pair_kernel
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.convert import params_from_flax
from ti_torch.models.cpainn import CPaiNN
from ti_torch.ops import _build
from ti_torch.ops.pair_layer_kernel import (
    apply_dense_pair_kernel,
    pack_layer,
    pair_kernel_drift,
    pair_layer,
    prepare,
)

N_ATOMS, F, LAYERS, B = 6, 16, 2, 3


@pytest.fixture(scope="module")
def setup():
    jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=2)
    jm = JaxCPaiNN(n_features=F, score_layers=LAYERS, conditioning="ambient")
    jp = jm.init(jax.random.PRNGKey(0), jt)
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    model = CPaiNN(F, LAYERS, n_atoms=N_ATOMS)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2)
    rng = np.random.default_rng(1)
    x = (0.3 * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    x -= x.mean(axis=1, keepdims=True)
    t = np.array([0.2, 0.5, 0.9], np.float32)
    temps = np.tile(np.array([700.0, 300.0], np.float32), (B, 1))
    return jm, jp, jt, params, model, template, x, t, temps


@pytest.mark.parametrize("compute_dtype", [None, "bf16_agg"])
def test_plain_pair_kernel_forward_matches_jax(setup, compute_dtype):
    jm, jp, jt, params, model, template, x, t, temps = setup
    ref = np.asarray(jax_pair_kernel(jm, jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps),
                                     jt.atom_ids, jt.edges, interpret=True,
                                     compute_dtype=compute_dtype))
    pm = prepare(model, params, template, compute_dtype, torch.device("cpu"))
    out = apply_dense_pair_kernel(pm, torch.from_numpy(x), torch.from_numpy(t),
                                  torch.from_numpy(temps)).numpy()
    assert out.dtype == np.float32
    if compute_dtype is None:
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    else:
        scale = max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(out / scale, ref / scale, atol=4e-2)


def test_drift_function_and_cpu_route(setup):
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; the drift function equals the layer-by-layer forward."""
    _jm, _jp, _jt, params, model, template, x, t, temps = setup
    _build.reset_launches()
    drift = pair_kernel_drift(model, params, template, device="cpu")
    xs = torch.from_numpy(x)
    out = drift(xs, 0.5, torch.from_numpy(temps))
    pm = prepare(model, params, template, None, torch.device("cpu"))
    ref = apply_dense_pair_kernel(pm, xs, torch.full((B,), 0.5), torch.from_numpy(temps),
                                  kernel=False)
    assert torch.equal(out, ref)
    assert _build.LAUNCHES["pair_layer"] == 0


def test_pack_layer_views_share_the_packed_buffers(setup):
    params = setup[3]
    w = pack_layer(params, 1, F, torch.float32, torch.device("cpu"))
    assert w.mats.numel() == 15 * F * F and w.vecs.numel() == 22 * F
    assert w.phi.w1.shape == (2 * F, F) and w.w.w3.shape == (F, 5 * F)
    assert w.w.w3.data_ptr() == w.mats[10 * F * F:].data_ptr()
    np.testing.assert_array_equal(w.phi.w2.numpy(), params["message_1.phi.Dense_1.weight"].t().numpy())
    np.testing.assert_array_equal(w.w.b3.numpy(), params["message_1.w.Dense_2.bias"].numpy())
    wb = pack_layer(params, 0, F, torch.bfloat16, torch.device("cpu"))
    assert wb.bf16 and wb.mats.dtype == torch.bfloat16 and wb.vecs.dtype == torch.float32


def test_rejections(setup):
    _jm, _jp, _jt, params, _model, template, *_ = setup
    with pytest.raises(NotImplementedError, match="complete graph"):
        prepare(CPaiNN(F, LAYERS, n_atoms=N_ATOMS, cutoff=1.0), params, template, None, "cpu")
    with pytest.raises(ValueError, match="bf16_agg"):
        prepare(CPaiNN(F, LAYERS, n_atoms=N_ATOMS), params, template, "f64", "cpu")
    w = pack_layer(params, 0, F, torch.float32, torch.device("cpu"))
    x = torch.zeros(1, N_ATOMS, 3)
    s = torch.zeros(1, N_ATOMS, F)
    v = torch.zeros(1, 3, N_ATOMS, F)
    e = torch.zeros(1, N_ATOMS ** 2, F)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pair_layer(x.to("meta"), s, v, e, w, 10.0)
