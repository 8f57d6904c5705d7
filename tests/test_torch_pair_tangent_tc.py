"""The 3xTF32 tensor-core route of kernel B3 in f32
(csrc/pair_tangent_tf32x3.cu), as far as the CPU reaches it: the route table
of ``pair_tangent``, the kernel's shared-memory count, a numpy model of its
lane tiles (stacked row l·N + j is source atom j of the tile's lane l) and
the packed weights it reads. The kernel itself runs only on the card
(tests/test_torch_gpu.py); the plain version it is held against there is
held against the JAX package in tests/test_torch_pair_tangent.py.
"""

import numpy as np
import pytest
import torch

from ti_torch.ops import _build
from ti_torch.ops.mlp_block import BF16, MLPWeights
from ti_torch.ops.pair_layer_kernel import (
    SMEM_LIMIT,
    TC_ROWS,
    pack_mma_weights,
    pack_pair_mlps,
    pack_tf32_weights,
    with_mma_weights,
    with_tf32_weights,
)
from ti_torch.ops.pair_tangent_kernel import (
    _kernel_weights,
    _route,
    lane_tile_plan,
    pair_tangent,
    pair_tangent_plain,
    tf32_smem_bytes,
)


def _tile_rows(plan, tile: int, n: int, k: int):
    """The kernel's row map of one tile (pair_tangent_tf32x3.cu: lane
    l0 + r / N, source atom r - (r / N)·N for rows r below nl·N): per stacked
    row the lane (of all K) and the source atom, or (-1, -1) for padding."""
    l0 = tile * plan.lanes
    rows = min(plan.lanes, k - l0) * n
    lane = [l0 + r // n if r < rows else -1 for r in range(TC_ROWS)]
    atom = [r - (r // n) * n if r < rows else -1 for r in range(TC_ROWS)]
    return lane, atom


def _weights(f: int, dtype=torch.float32, seed: int = 0):
    rng = np.random.default_rng(seed)

    def mlp(f_in):
        def t(*shape):
            return torch.as_tensor(rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[0]))

        return MLPWeights(t(f_in, f), t(f), 1 + 0.1 * t(f), t(f), t(f, f), t(f), 1 + 0.1 * t(f), t(f),
                          t(f, 5 * f), t(5 * f))

    return pack_pair_mlps(mlp(2 * f), mlp(f), dtype, "cpu")


@pytest.mark.parametrize("bf16,variant,lib", [
    (False, "mma", "pair_tangent_tf32x3"),
    (False, "fma", "pair_tangent"),
    (True, "mma", "pair_tangent_mma"),
])
def test_route_table(bf16, variant, lib):
    """f32 takes the 3xTF32 kernel, f32 ``"fma"`` the f32-FMA kernel, bf16_agg
    the bf16 tensor-core kernel."""
    assert _route(bf16, variant) == lib


def test_route_refusals():
    with pytest.raises(ValueError, match="takes f32 weights"):
        _route(True, "fma")
    with pytest.raises(ValueError, match="variant must be one of"):
        _route(False, "tc")


@pytest.mark.parametrize("variant", ["mma", "fma"])
def test_f32_cpu_route_is_the_plain_version(variant):
    """f32 on the CPU: the plain version bit for bit, nothing launched, and no
    packing needed (these weights carry none)."""
    rng = np.random.default_rng(3)
    f, n, b, k = 16, 5, 2, 7

    def t(*shape, scale=1.0):
        return torch.as_tensor((scale * rng.standard_normal(shape)).astype(np.float32))

    base = (t(b, n, 3, scale=0.3), t(b, n, f), t(b, 3, n, f, scale=0.3), t(b, n * n, f))
    lanes = (t(b, k, n, 3), t(b, k, n, f, scale=0.1), t(b, k, 3, n, f, scale=0.1),
             t(b, k, n * n, f, scale=0.1))
    wts = _weights(f)
    assert wts.mma is None
    before, routes = dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES)
    out = pair_tangent(*base, *lanes, wts, 10.0, variant=variant)
    assert _build.LAUNCHES == before and _build.ROUTE_LAUNCHES == routes
    for a, r in zip(out, pair_tangent_plain(*base, *lanes, wts, 10.0)):
        assert a.dtype == r.dtype and torch.equal(a, r)


@pytest.mark.parametrize("n", [19, 29, 32])
def test_shared_memory_fits_at_every_atom_count(n):
    """One CTA's shared memory does not depend on N (residual tiles of 32
    rows) and fits the card; a tile takes 64 // N whole lanes."""
    assert tf32_smem_bytes() == 219_392 <= SMEM_LIMIT
    plan = lane_tile_plan(n, 57)
    assert plan.lanes == TC_ROWS // n and plan.lanes * n <= TC_ROWS
    assert plan.lanes == {19: 3, 29: 2, 32: 2}[n]


@pytest.mark.parametrize("k", [1, 5, 16, 57])
@pytest.mark.parametrize("n", [5, 19, 29, 32])
def test_lane_tiles_cover_every_row_once(n, k):
    """A numpy model of the kernel's lane tiles: each (lane, source atom) is
    one stacked row of exactly one tile, and padding rows reach no output.
    The model fills each tile's dh rows as the kernel's product rule does
    (padding rows get NaN here: the kernel zeroes them, so any read would
    show) and forms the outputs with the kernel's loops: the sums over j of
    each of the tile's lanes (thread idx owns lane idx // F) and de + dde
    on the real rows."""
    plan = lane_tile_plan(n, k)
    assert plan.tiles == -(-k // plan.lanes) and 1 <= plan.last <= plan.lanes
    value = np.arange(k * n, dtype=np.float64).reshape(k, n) + 1.0  # dh of (lane, j)
    seen = np.zeros((k, n), np.int64)
    sums = np.full(k, np.nan)
    de = np.full((k, n), np.nan)
    for tile in range(plan.tiles):
        lane, atom = _tile_rows(plan, tile, n, k)
        l0 = tile * plan.lanes
        nl = min(plan.lanes, k - l0)
        rows = nl * n
        assert nl == (plan.last if tile == plan.tiles - 1 else plan.lanes)
        dh = np.full(TC_ROWS, np.nan)
        for r in range(TC_ROWS):
            if r < rows:
                assert 0 <= atom[r] < n and lane[r] // plan.lanes == tile
                seen[lane[r], atom[r]] += 1
                dh[r] = value[lane[r], atom[r]]
            else:
                assert (lane[r], atom[r]) == (-1, -1)
        for warp_rows in (range(0, 32), range(32, 64)):  # a warp skips its products
            if warp_rows.start >= rows:                  # only where all its rows are padding
                assert all(lane[r] < 0 for r in warp_rows)
        for ll in range(nl):
            sums[l0 + ll] = sum(dh[ll * n + j] for j in range(n))
        for r in range(rows):
            de[l0 + r // n, r % n] = dh[r]
    assert (seen == 1).all()
    np.testing.assert_array_equal(sums, value.sum(axis=1))
    np.testing.assert_array_equal(de, value)


def _model_and_template():
    from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
    from ti_torch.models.cpainn import CPaiNN

    torch.manual_seed(0)
    return CPaiNN(16, 2, n_atoms=5), graph_template(make_synthetic_molecule(5, seed=0), t_cond=2)


def test_the_route_reads_the_packing_prepare_attaches():
    """``prepare`` splits every f32 layer once (``pack_tf32_weights``); the f32
    tensor-core route reads exactly that buffer, the f32-FMA route the
    row-major matrices, the bf16_agg route its fragment order."""
    from ti_torch.ops.pair_layer_kernel import prepare

    model, template = _model_and_template()
    x = torch.zeros(1, 5, 3)
    for w in prepare(model, None, template, None, "cpu").layers:
        assert torch.equal(w.mma, pack_tf32_weights(w))
        assert _kernel_weights("pair_tangent_tf32x3", w, x) is w.mma
        assert _kernel_weights("pair_tangent", w, x) is w.mats
    for w in prepare(model, None, template, "bf16_agg", "cpu").layers:
        assert _kernel_weights("pair_tangent_mma", w, x) is w.mma
        assert torch.equal(w.mma, pack_mma_weights(w))


def test_a_layer_without_its_packing_raises():
    x = torch.zeros(1, 5, 3)
    wts = _weights(16)
    with pytest.raises(ValueError, match="with_tf32_weights"):
        _kernel_weights("pair_tangent_tf32x3", wts, x)
    packed = with_tf32_weights(wts)
    with pytest.raises(ValueError, match="3xTF32 weights must be"):
        _kernel_weights("pair_tangent_tf32x3", packed._replace(mma=packed.mma[:-4]), x)
    with pytest.raises(ValueError, match="3xTF32 weights must be"):  # the bf16 order is not it
        _kernel_weights("pair_tangent_tf32x3",
                        packed._replace(mma=with_mma_weights(_weights(16, BF16)).mma), x)
    with pytest.raises(ValueError, match="with_mma_weights"):
        _kernel_weights("pair_tangent_mma", _weights(16, BF16), x)
