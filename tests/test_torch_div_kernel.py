"""Kernel B7 (the whole-network exact divergence) of the PyTorch port against
the JAX package.

On the CPU ``divergence_kernel_batch`` runs the plain version of the kernel
(``div_kernel_plain``); the JAX side runs its Pallas kernel in interpret
mode, on the same flax weights and numpy inputs, at the shapes of
tests/test_pallas_kernels.py::test_divergence_kernel_matches_linearize
(N = 6, F = 16, 2 layers, 3 chains). Bars: divergences rtol 3e-4 (that
test's bar); the primal states and packed stacks elementwise at rtol 1e-5 /
atol 1e-6 times the tensor's largest magnitude (the same math in another
library: a near-zero entry of a sum of O(1) terms keeps the terms' absolute
rounding); the kernel body's node
tangents rtol 1e-4 / atol 1e-5 (two layers of f32 tangent sums taken in
another order). The CUDA kernel runs only on the card: tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.models.cpainn_dense import dense_edge_type_matrix as jax_etype
from ti_tpu.ops import div_kernel as jdk
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.convert import params_from_flax
from ti_torch.models.cpainn import CPaiNN
from ti_torch.ops import _build
from ti_torch.ops import div_kernel as tdk
from ti_torch.ops.dense_divergence import dense_divergence
from ti_torch.ops.pair_layer_kernel import SMEM_LIMIT

N_ATOMS, F, LAYERS, B, T = 6, 16, 2, 3, 0.5


def _assert_state(a, r, name):
    r = np.asarray(r)
    np.testing.assert_allclose(a.numpy(), r, rtol=1e-5, atol=1e-6 * max(1.0, np.abs(r).max()),
                               err_msg=name)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def setup():
    jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=2)
    jm = JaxCPaiNN(n_features=F, score_layers=LAYERS, conditioning="ambient")
    jp = jm.init(jax.random.PRNGKey(0), jt)
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    model = CPaiNN(F, LAYERS, n_atoms=N_ATOMS)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2)
    rng = np.random.default_rng(1)
    xs = (0.3 * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    temps = np.tile(np.array([700.0, 300.0], np.float32), (B, 1))
    return jm, jp, jt, params, model, template, xs, temps


def _jax_kernel_outputs(jm, jp, jt, xs, temps, L):
    """The JAX package's primal states and its Pallas kernel's node
    tangents before the readout (``_div_kernel_run`` up to its
    pallas_call, in interpret mode): (states, d_s (C, LP, N, F),
    d_v (C, LP, N, F, 3))."""
    f, sl = jm.n_features, jm.score_layers
    c, n, _ = xs.shape
    d = 3 * n
    n_chunks = -(-d // L)
    lp = n_chunks * L
    n2p = -(-(n * n) // 8) * 8
    np_ = -(-n // 8) * 8
    etype = jnp.asarray(jax_etype(jt.edges))
    pad = jdk._pad_to

    def run(xs, temps):
        st = jax.vmap(lambda x, tp: jdk._primal_layer_states(
            jm, jp, x, jnp.asarray(T), tp, jnp.asarray(jt.atom_ids), etype))(xs, temps)
        geom = jnp.concatenate([st["d_dist"].reshape(c, d, n * n)[..., None],
                                st["d_direc"].reshape(c, d, n * n, 3)], axis=-1)
        geom = jnp.pad(geom, ((0, 0), (0, lp - d), (0, 0), (0, 4))).reshape(c, n_chunks, L * n * n, 8)
        w1s, w2s, w3s, vecs, b3s, uk, vk = jdk._pack_mlp_stacks(jp, sl)
        b3s = jnp.pad(b3s, ((0, 0), (0, 7), (0, 0)))
        chain = lambda shape: pl.BlockSpec((1,) + shape, lambda ci: (ci,) + (0,) * len(shape))
        shared = lambda shape: pl.BlockSpec(shape, lambda ci: (0,) * len(shape))
        out_spec = chain((n_chunks, L, np_, f))
        out_shape = jax.ShapeDtypeStruct((c, n_chunks, L, np_, f), jnp.float32)
        outs = pl.pallas_call(
            jdk._make_kernel(n, f, L, sl, n_chunks, np_), grid=(c,),
            in_specs=[chain((sl, np_, f))] * 4 + [chain((sl, n2p, f)), chain((n2p, f)),
                                                  chain((n2p, f)), chain((n2p, 8)),
                                                  chain((n_chunks, L * n * n, 8)),
                                                  shared((3 * sl, 2 * f, f)), shared((3 * sl, f, f)),
                                                  shared((3 * sl, f, 5 * f)), shared((3 * sl, 6, f)),
                                                  shared((3 * sl, 8, 5 * f)), shared((sl, f, f)),
                                                  shared((sl, f, f))],
            out_specs=[out_spec] * 4, out_shape=[out_shape] * 4, interpret=True,
        )(pad(st["s_l"], np_, axis=2),
          *[pad(st["v_l"][..., k], np_, axis=2) for k in range(3)],
          pad(st["e_l"].reshape(c, sl, n * n, f), n2p, axis=2),
          pad(st["pe"].reshape(c, n * n, f), n2p, axis=1),
          pad(st["pe_prime"].reshape(c, n * n, f), n2p, axis=1),
          pad(jnp.pad(st["direc"].reshape(c, n * n, 3), ((0, 0), (0, 0), (0, 5))), n2p, axis=1),
          geom, w1s, w2s, w3s, vecs, b3s, uk, vk)
        d_s, dv0, dv1, dv2 = [o.reshape(c, lp, np_, f)[:, :, :n] for o in outs]
        return st, d_s, jnp.stack([dv0, dv1, dv2], axis=-1)

    return jax.jit(run)(jnp.asarray(xs), jnp.asarray(temps))


@pytest.fixture(scope="module")
def jax_l4(setup):
    jm, jp, jt, _params, _model, _template, xs, temps = setup
    return _jax_kernel_outputs(jm, jp, jt, xs, temps, 4)


def _port_states(setup):
    _jm, _jp, _jt, params, model, template, xs, temps = setup
    etype = torch.as_tensor(tdk.dense_edge_type_matrix(template.edges)).long()
    st = tdk._primal_layer_states(model, params, _t(xs), T, _t(temps),
                                  torch.as_tensor(template.atom_ids), etype)
    return st, tdk._pack_mlp_stacks(params, LAYERS)


@pytest.mark.parametrize("lanes_per_chunk", [4, 6])
def test_divergence_kernel_batch_matches_jax(setup, lanes_per_chunk):
    jm, jp, jt, params, model, template, xs, temps = setup
    ref = jdk.divergence_kernel_batch(jm, jp, jnp.asarray(xs), T, jnp.asarray(temps), jt,
                                      lanes_per_chunk=lanes_per_chunk, interpret=True)
    _build.reset_launches()
    divs = tdk.divergence_kernel_batch(model, params, xs, T, temps, template,
                                       lanes_per_chunk=lanes_per_chunk, device="cpu")
    assert divs.shape == (B,) and divs.device.type == "cpu"
    assert not any(_build.LAUNCHES.values())  # the CPU route launches nothing
    np.testing.assert_allclose(divs.numpy(), np.asarray(ref), rtol=3e-4)


def test_primal_states_match_jax(setup, jax_l4):
    st_j = jax_l4[0]
    st, _ = _port_states(setup)
    for key in ("s_l", "v_l", "e_l", "s_fin", "v_fin", "pe", "pe_prime", "direc", "d_dist",
                "d_direc"):
        assert st[key].shape == st_j[key].shape, key
        _assert_state(st[key], st_j[key], key)


def test_mlp_stacks_match_jax(setup):
    _jm, jp, *_ = setup
    _, stacks = _port_states(setup)
    for name, a, r in zip(tdk.MLPStacks._fields, stacks, jdk._pack_mlp_stacks(jp, LAYERS)):
        assert a.shape == r.shape, name
        _assert_state(a, r, name)


def test_plain_body_matches_pallas_node_tangents(setup, jax_l4):
    _st_j, d_s_j, d_v_j = jax_l4
    st, stacks = _port_states(setup)
    out = tdk.div_kernel_plain(tdk.pack_inputs(st, 4), stacks, 4)
    assert out.shape == (B, 18 // 4 + 1, 4, 4, N_ATOMS, F)
    lanes = out.reshape(B, -1, 4, N_ATOMS, F)
    np.testing.assert_allclose(lanes[:, :, 3].numpy(), np.asarray(d_s_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lanes[:, :, :3].permute(0, 1, 3, 4, 2).numpy(), np.asarray(d_v_j),
                               rtol=1e-4, atol=1e-5)
    # the padded lanes (18 -> 20) carry zero geometry tangents, so zero state
    assert torch.all(lanes[:, 18:] == 0)


@pytest.mark.parametrize("lanes_per_chunk", [1, 5, 18])
def test_every_chunking_gives_dense_divergence(setup, lanes_per_chunk):
    """The plain kernel body at any L against the hand-propagated JVP of
    ops/dense_divergence.py, the same math unchunked."""
    _jm, _jp, _jt, params, model, template, xs, temps = setup
    divs = tdk.divergence_kernel_batch(model, params, xs, T, temps, template,
                                       lanes_per_chunk=lanes_per_chunk, device="cpu")
    ref = [dense_divergence(model, params, _t(xs[i]), T, _t(temps[i]), template.atom_ids,
                            template.edges)[1].item() for i in range(B)]
    np.testing.assert_allclose(divs.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_refusals(setup):
    _jm, _jp, _jt, params, _model, template, xs, temps = setup
    cut = CPaiNN(F, LAYERS, n_atoms=N_ATOMS, cutoff=5.0)
    with pytest.raises(NotImplementedError, match="complete graph"):
        tdk.divergence_kernel_batch(cut, params, xs, T, temps, template, device="cpu")
    with pytest.raises(NotImplementedError, match="complete graph"):
        dense_divergence(cut, params, _t(xs[0]), T, _t(temps[0]), template.atom_ids,
                         template.edges)
    st, stacks = _port_states(setup)
    inp = tdk.pack_inputs(st, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdk.div_kernel(inp._replace(s=inp.s.to("meta")), stacks, 4)


def test_shared_memory_fits_one_cta():
    assert tdk.smem_bytes() == 217_600 <= SMEM_LIMIT
    assert "div_kernel" in _build.KERNELS and "div_kernel" in _build.LAUNCHES
