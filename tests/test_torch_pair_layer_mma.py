"""Kernels B1 and B2 in bf16_agg on the tensor cores (csrc/pair_layer_mma.cu),
as far as the CPU reaches them: the wrapper's route table (B2 in f32 on B1's
3xTF32 kernel too), the tile plan, the fragment-order packing done once in
``prepare``, a numpy walk of the packed fragments in the kernel's row
mapping, and the CPU route; the tile plan and the walk at F = 256 too (the
library pair_layer_mma_f256, one tile a CTA of 16 warps). The plain version the kernels are held against
on the card (tests/test_torch_gpu.py) is held here against the JAX package's
chain-blocked Pallas kernel in interpret mode, in bf16_agg and in f32.
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
from ti_torch.ops import pair_layer_kernel as plk
from ti_torch.ops.mlp_block import BF16, MLPWeights, dot_bf16
from ti_torch.ops.pair_layer_kernel import (
    KERNEL_MAX_N,
    MAX_CHAIN_BLOCK,
    MMA_MAX_TILES,
    MMA_TILE_BYTES,
    SMEM_LIMIT,
    TC_ROWS,
    _route,
    apply_dense_pair_kernel,
    mma_max_tiles,
    mma_tile_bytes,
    mma_tile_groups,
    mma_tile_plan,
    pack_mma_weights,
    pack_pair_mlps,
    pair_layer,
    pair_layer_plain,
    prepare,
)


def _weights(f: int, dtype=BF16, seed: int = 0):
    rng = np.random.default_rng(seed)

    def mlp(f_in):
        def t(*shape):
            return torch.as_tensor(rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[0]))

        return MLPWeights(t(f_in, f), t(f), 1 + 0.1 * t(f), t(f), t(f, f), t(f), 1 + 0.1 * t(f), t(f),
                          t(f, 5 * f), t(5 * f))

    return pack_pair_mlps(mlp(2 * f), mlp(f), dtype, "cpu")


@pytest.mark.parametrize("bf16,chain_block,variant,lib", [
    (True, 1, None, "pair_layer_mma"), (True, 2, None, "pair_layer_mma"),
    (True, 3, None, "pair_layer_mma"), (True, 4, "tc", "pair_layer_mma"),
    (True, 1, "fma", "pair_layer"), (True, 4, "fma", "pair_layer"),
    (True, 5, None, "pair_layer_mma"), (True, 8, None, "pair_layer_mma"),
    (True, 5, "fma", "pair_layer"),
    (False, 1, None, "pair_layer_tf32x3"), (False, 1, "tc", "pair_layer_tf32x3"),
    (False, 1, "fma", "pair_layer"), (False, 2, None, "pair_layer_tf32x3"),
    (False, 4, None, "pair_layer_tf32x3"), (False, 5, None, "pair_layer_tf32x3"),
    (False, 8, "tc", "pair_layer_tf32x3"), (False, 4, "fma", "pair_layer"),
])
def test_route_table(bf16, chain_block, variant, lib):
    """Every chain block takes the tensor-core kernel of the weights' type,
    pair_layer_mma.cu for bf16_agg (min(C, 3) tiles a CTA) and
    pair_layer_tf32x3.cu for f32 (B1's tiles whatever C); ``variant="fma"``
    takes pair_layer.cu, which refuses C > 4 when it launches."""
    assert _route(bf16, chain_block, variant) == lib


@pytest.mark.parametrize("bf16,chain_block,lib", [
    (True, MAX_CHAIN_BLOCK + 1, "pair_layer_mma"),
    (True, 2 * MAX_CHAIN_BLOCK, "pair_layer_mma"),
    (False, 2, "pair_layer_tf32x3"),
    (False, MAX_CHAIN_BLOCK + 1, "pair_layer_tf32x3"),
])
def test_inapplicable_tensor_core_variant_raises(bf16, chain_block, lib):
    """An explicit "tc" now applies at every chain block (past
    csrc/pair_layer.cu's limit of 4 too); an unknown variant raises."""
    assert _route(bf16, chain_block, "tc") == lib
    with pytest.raises(ValueError, match="variant must be"):
        _route(bf16, 1, "mma")


@pytest.mark.parametrize("chain_block", [1, 2, 3, 4])
@pytest.mark.parametrize("b,n", [(1, 2), (13, 2), (13, 19), (130, 19), (7, 29), (130, 29),
                                 (5, KERNEL_MAX_N)])
def test_mma_tile_plan_covers_every_group_once(b, n, chain_block):
    """Every (chain, dst atom) group in exactly one row tile of one CTA, the
    tiles' rows contiguous in e, for batches that fill neither the last tile
    nor the last CTA."""
    _tile_plan_covers_every_group_once(b, n, chain_block, 128)


@pytest.mark.parametrize("chain_block", [1, 2, 4])
@pytest.mark.parametrize("b,n", [(1, 2), (16, 29), (128, 29), (13, 29), (7, 19), (5, KERNEL_MAX_N)])
def test_mma_tile_plan_covers_every_group_once_at_f256(b, n, chain_block):
    """The same at F = 256, where one 132,352-byte tile fills a CTA and
    every chain block takes one tile (so B2 is B1's launch); 29 atoms, the
    10506 molecule, at its 16 and 128 chains."""
    _tile_plan_covers_every_group_once(b, n, chain_block, 256)
    assert mma_tile_plan(b, n, chain_block, 256).tiles == 1


def _tile_plan_covers_every_group_once(b, n, chain_block, f):
    plan = mma_tile_plan(b, n, chain_block, f)
    assert plan.groups == TC_ROWS // n and plan.tiles == min(chain_block, mma_max_tiles(f))
    assert plan.smem == plan.tiles * mma_tile_bytes(f) <= SMEM_LIMIT
    seen = []
    for cta in range(plan.ctas):
        in_cta = 0
        for slot in range(plan.tiles):
            groups = mma_tile_groups(plan, cta, slot, b, n)
            assert len(groups) <= plan.groups
            rows = [q * n + j for q in groups for j in range(n)]
            assert rows == list(range(groups.start * n, groups.stop * n))  # contiguous in e
            seen += [divmod(q, n) for q in groups]
            in_cta += len(groups)
        assert in_cta > 0, f"CTA {cta} has no group"
    assert seen == [(bb, i) for bb in range(b) for i in range(n)]


def test_mma_plan_at_the_sde_batch():
    """8192 chains of 19 atoms: 51,883 row tiles of 57 rows; one, two or
    three a CTA, chain_block 4 taking three (four do not fit a CTA's shared
    memory)."""
    got = {c: mma_tile_plan(8192, 19, c) for c in (1, 2, 3, 4)}
    assert [p.ctas for p in got.values()] == [51_883, 25_942, 17_295, 17_295]
    assert [p.tiles for p in got.values()] == [1, 2, 3, 3]
    assert MMA_TILE_BYTES == 66_816 and got[3].smem == got[4].smem == 200_448
    assert (MMA_MAX_TILES + 1) * MMA_TILE_BYTES > SMEM_LIMIT
    assert mma_tile_plan(128, 19, 1).ctas == 811


def test_mma_plan_at_f256():
    """At F = 256 a tile is 64 (8F + 20) = 132,352 bytes and two exceed a
    CTA's 232,448; 16 chains of 29 atoms are 464 groups in 232 tiles of two
    groups (58 real rows), 1.76 waves over 132 SMs at one CTA an SM."""
    assert mma_tile_bytes(256) == 132_352 and 2 * mma_tile_bytes(256) > SMEM_LIMIT
    assert mma_max_tiles(256) == 1 and mma_max_tiles(128) == MMA_MAX_TILES == 3
    plan = mma_tile_plan(16, 29, 1, 256)
    assert (plan.groups, plan.tiles, plan.ctas, plan.smem) == (2, 1, 232, 132_352)
    assert mma_tile_plan(16, 29, 4, 256) == plan
    assert mma_tile_plan(128, 29, 1, 256).ctas == 1856


@pytest.fixture(scope="module")
def small_model():
    torch.manual_seed(0)
    model = CPaiNN(16, 2, n_atoms=5)
    template = graph_template(make_synthetic_molecule(5, seed=0), t_cond=2)
    return model, template


def test_prepare_packs_bf16_layers_once_and_b3_does_not_repack(small_model, monkeypatch):
    """``prepare`` gives every bf16_agg layer its fragment-order packing,
    once per layer; B3's divergence function, built on ``prepare``, packs no
    more."""
    from ti_torch.ops.pair_tangent_kernel import pair_tangent_div_fn

    model, template = small_model
    calls = []
    real = plk.pack_mma_weights
    monkeypatch.setattr(plk, "pack_mma_weights", lambda w: calls.append(1) or real(w))
    pm = prepare(model, None, template, "bf16_agg", "cpu")
    assert len(calls) == model.score_layers
    assert all(torch.equal(w.mma, real(w)) and plk.with_mma_weights(w) is w for w in pm.layers)
    calls.clear()
    pair_tangent_div_fn(model, None, template, compute_dtype="bf16_agg", device="cpu")
    assert len(calls) == model.score_layers  # its own prepare, and nothing after it
    assert all(w.mma is not None and w.mma.dtype == torch.float32
               for w in prepare(model, None, template, None, "cpu").layers)


def _b_tile(packed: np.ndarray, npt: int, kt: int, np0: int, n_pairs: int) -> np.ndarray:
    """The 16 x (16 n_pairs) B tile at k-tile kt, n-tile pairs np0 .., as
    the warp's lanes read it: the uint4 at ((kt npt + np) 32 + lane) holds
    w[16kt + 8h + 2t + e, 16np + 8q + g] at (q, h, e)."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    out = np.zeros((16, 16 * n_pairs), packed.dtype)
    for p in range(n_pairs):
        at = ((kt * npt + np0 + p) * 32 + lane) * 8
        frag = packed[at[:, None] + np.arange(8)]                 # lane, (q, h, e)
        for q in range(2):
            for h in range(2):
                for e in range(2):
                    out[8 * h + 2 * t + e, 16 * p + 8 * q + g] = frag[:, 4 * q + 2 * h + e]
    return out


@pytest.mark.parametrize("nwarp,tb", [(8, 1), (16, 2), (16, 3)])
@pytest.mark.parametrize("which,chunk", [(0, 0), (2, 3)])
def test_fragment_walk_in_the_kernel_row_mapping_reproduces_the_dot(nwarp, tb, which, chunk):
    """A product of csrc/pair_layer_mma.cu walked in numpy as its warps walk
    it: the CTA's TB row tiles hold the pair rows of consecutive tiles of
    the tile plan (N = 19: 57 real rows and 7 of padding); warp w takes rows
    16 (w % 4) .. of every tile and n-tile pairs (F/16)/(W/4) · (w / 4) ..
    of chunk ``chunk``; each B fragment it loads from the packed buffer feeds
    every tile of the CTA. Against ``dot_bf16`` on the same pair rows only the
    order of summation differs: rtol 1e-6, atol 2e-6 max |dot|."""
    _fragment_walk(128, 19, 9, nwarp, tb, which, chunk)


@pytest.mark.parametrize("which,chunk", [(0, 0), (1, 0), (2, 3), (5, 4)])
def test_fragment_walk_in_the_kernel_row_mapping_reproduces_the_dot_at_f256(which, chunk):
    """The same walk at F = 256 (pair_layer_mma_f256): one tile a CTA of 16
    warps, each a quarter of the columns, N = 29 (58 real rows and 6 of
    padding), on the packing at F = 256 (phi.w1 512 x 256, phi.w2, w.w3 256 x
    1280)."""
    _fragment_walk(256, 29, 3, 16, 1, which, chunk)


def _fragment_walk(f, n, b, nwarp, tb, which, chunk):
    wts = _weights(f, seed=1)
    mats = (wts.phi.w1, wts.phi.w2, wts.phi.w3, wts.w.w1, wts.w.w2, wts.w.w3)
    m = mats[which]
    k, n_out = m.shape
    off = sum(int(np.prod(q.shape)) for q in mats[:which])
    packed = pack_mma_weights(wts)[off: off + k * n_out].float().numpy()
    rng = np.random.default_rng(2)
    rows_all = torch.as_tensor(rng.standard_normal((b * n * n, k)).astype(np.float32)).to(BF16)
    plan = mma_tile_plan(b, n, tb, f)
    assert plan.tiles == tb
    tiles = []
    for slot in range(tb):  # the first CTA's tiles
        groups = mma_tile_groups(plan, 0, slot, b, n)
        tile = np.zeros((TC_ROWS, k), np.float32)
        real = rows_all[groups.start * n: groups.stop * n].float().numpy()
        tile[: len(real)] = real
        tiles.append((tile, len(real), groups.start * n))
    npt, n_pairs = n_out // 16, (f // 16) // (nwarp // 4)
    out = np.zeros((tb, TC_ROWS, f), np.float32)
    for warp in range(nwarp):
        row0, cb = 16 * (warp % 4), warp // 4
        np0 = chunk * (f // 16) + n_pairs * cb
        acc = np.zeros((tb, 16, 16 * n_pairs), np.float32)
        for kt in range(k // 16):
            bt = _b_tile(packed, npt, kt, np0, n_pairs)
            for c, (tile, _, _) in enumerate(tiles):
                acc[c] = acc[c] + (tile[row0: row0 + 16, 16 * kt: 16 * kt + 16] @ bt).astype(np.float32)
        out[:, row0: row0 + 16, 16 * n_pairs * cb: 16 * n_pairs * (cb + 1)] = acc
    ref = dot_bf16(rows_all, m)[:, chunk * f: (chunk + 1) * f].numpy()
    for c, (_, nreal, r0) in enumerate(tiles):
        want = ref[r0: r0 + nreal]
        np.testing.assert_allclose(out[c, :nreal], want, rtol=1e-6, atol=2e-6 * np.abs(ref).max())


def _layer_inputs(f=16, n=5, b=3, seed=3):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dt=BF16):
        return torch.as_tensor((scale * rng.standard_normal(shape)).astype(np.float32)).to(dt)

    return (t(b, n, 3, scale=0.3, dt=torch.float32), t(b, n, f), t(b, 3, n, f, scale=0.3),
            t(b, n * n, f))


@pytest.mark.parametrize("variant", [None, "tc", "fma"])
@pytest.mark.parametrize("chain_block", [1, 2, 3, 4, 5, 8])
def test_cpu_tensors_take_the_plain_version(chain_block, variant):
    """On the CPU every chain block and variant of bf16_agg is the plain
    version, bit for bit, and no kernel is launched or built."""
    base = _layer_inputs()
    wts = plk.with_mma_weights(_weights(16))
    before, by_route = dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES)
    out = pair_layer(*base, wts, 10.0, chain_block, variant=variant)
    ref = pair_layer_plain(*base, wts, 10.0)
    assert _build.LAUNCHES == before and _build.ROUTE_LAUNCHES == by_route
    for a, r in zip(out, ref):
        assert a.dtype == r.dtype and torch.equal(a, r)


N_ATOMS, F, LAYERS, B = 6, 16, 2, 3


@pytest.fixture(scope="module")
def jax_setup():
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


@pytest.mark.parametrize("chain_block", [2, 4, 5])
def test_plain_f32_forward_matches_jax_chain_blocks(jax_setup, chain_block):
    """``apply_dense_pair_kernel`` in f32 with ``chain_block`` 2, 4 and 5 (3
    chains: none divides the batch, and 5 is past csrc/pair_layer.cu's limit
    of 4, which B2 in f32 no longer meets: it is B1's 3xTF32 kernel) against
    the JAX package's chain-blocked Pallas kernel in interpret mode, at
    tests/test_torch_pair_layer.py's f32 bar: rtol 1e-4, atol 1e-5."""
    jm, jp, jt, params, model, template, x, t, temps = jax_setup
    ref = np.asarray(jax_pair_kernel(jm, jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps),
                                     jt.atom_ids, jt.edges, interpret=True,
                                     chain_block=chain_block))
    pm = prepare(model, params, template, None, torch.device("cpu"))
    assert _route(False, chain_block, None) == "pair_layer_tf32x3"
    out = apply_dense_pair_kernel(pm, torch.from_numpy(x), torch.from_numpy(t),
                                  torch.from_numpy(temps), chain_block=chain_block).numpy()
    assert out.dtype == np.float32 and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("chain_block", [2, 4])
def test_plain_bf16_agg_forward_matches_jax_chain_blocks(jax_setup, chain_block):
    """``apply_dense_pair_kernel`` in bf16_agg with ``chain_block`` 2 and 4
    (3 chains: neither divides the batch) against the JAX package's
    chain-blocked Pallas kernel in interpret mode, at
    tests/test_torch_pair_layer.py's bf16 bar: atol 4e-2 of max |ref|."""
    jm, jp, jt, params, model, template, x, t, temps = jax_setup
    ref = np.asarray(jax_pair_kernel(jm, jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps),
                                     jt.atom_ids, jt.edges, interpret=True,
                                     compute_dtype="bf16_agg", chain_block=chain_block))
    pm = prepare(model, params, template, "bf16_agg", torch.device("cpu"))
    out = apply_dense_pair_kernel(pm, torch.from_numpy(x), torch.from_numpy(t),
                                  torch.from_numpy(temps), chain_block=chain_block).numpy()
    assert out.dtype == np.float32 and np.isfinite(out).all()
    scale = max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(out / scale, ref / scale, atol=4e-2)
