"""Kernel B7 in f32 on the tensor cores (csrc/div_kernel_tf32x3.cu, 3xTF32),
as far as the CPU reaches it: the route table of ``div_kernel``, the
kernel's shared-memory count, a numpy model of its work plan (G chunks of a
chain a CTA, the real lanes stacked 64 // N to a tile, the padded lanes
written as zeros), the 3xTF32 packing ``pack_tf32_stacks`` makes once a
call, and a plain-torch model of the kernel's 3xTF32 arithmetic on B7's
whole chain. The kernel itself runs only on the card
(tests/test_torch_gpu.py); the plain version it is held against there is
held against the JAX package in tests/test_torch_div_kernel.py.
"""

import numpy as np
import pytest
import torch

from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.cpainn import CPaiNN
from ti_torch.ops import _build
from ti_torch.ops import div_kernel as dk
from ti_torch.ops.mlp_block import MLPWeights
from ti_torch.ops.pair_layer_kernel import KERNEL_F, SMEM_LIMIT, TC_ROWS, split_tf32
from ti_torch.ops.pair_tangent_kernel import _ln_silu_tan

H100_SMS = 132


def _setup(n=5, f=16, layers=2, c=2, L=4, seed=1):
    """B7's packed inputs and stacks for c chains of an n-atom molecule on
    the CPU, from numpy coordinates."""
    torch.manual_seed(0)
    model = CPaiNN(f, layers, n_atoms=n)
    p = {k: t.detach() for k, t in model.state_dict().items()}
    template = graph_template(make_synthetic_molecule(n, seed=0), t_cond=2)
    xs = torch.as_tensor(0.3 * np.random.default_rng(seed).standard_normal((c, n, 3)),
                         dtype=torch.float32)
    temps = torch.tensor([[700.0, 300.0]]).expand(c, 2)
    etype = torch.as_tensor(dk.dense_edge_type_matrix(template.edges)).long()
    with torch.no_grad():
        st = dk._primal_layer_states(model, p, xs, 0.5, temps, torch.as_tensor(template.atom_ids),
                                     etype)
    return dk.pack_inputs(st, L), dk._pack_mlp_stacks(p, layers)


@pytest.mark.parametrize("variant,lib", [("tc", "div_kernel_tf32x3"), ("fma", "div_kernel")])
def test_route_table(variant, lib):
    assert dk._div_route(variant) == lib
    assert lib in _build.KERNELS


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="variant must be one of"):
        dk._div_route("mma")
    inp, stacks = _setup()
    with pytest.raises(ValueError, match="variant must be one of"):  # on the CPU as well
        dk.div_kernel(inp, stacks, 4, variant="wgmma")


@pytest.mark.parametrize("variant", ["tc", "fma"])
def test_cpu_tensors_take_the_plain_version(variant):
    """On the CPU either variant is the plain version, bit for bit, with no
    launch and no packing."""
    inp, stacks = _setup()
    before, routes = dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES)
    with torch.no_grad():
        out = dk.div_kernel(inp, stacks, 4, variant=variant)
        ref = dk.div_kernel_plain(inp, stacks, 4)
    assert _build.LAUNCHES == before and _build.ROUTE_LAUNCHES == routes
    assert torch.equal(out, ref)


@pytest.mark.parametrize("n", [5, 19, 29, 32])
def test_shared_memory_fits_the_card(n):
    """The tiles (stacked input 64 x 2F, two a2 tangents 64 x F, five
    residual tiles 32 x F) and the geometry: 215,808 bytes at any N, within
    the 232,448 a CTA may take; one CTA an SM. A tile's lanes fill at most
    its 64 rows, the residual tiles hold the N source atoms, and the update
    block's nine 32-row tiles fit in the same memory."""
    assert dk.tc_smem_bytes() == 215_808 <= SMEM_LIMIT
    assert 2 * dk.tc_smem_bytes() > SMEM_LIMIT
    lanes = TC_ROWS // n
    assert lanes >= 2 and lanes * n <= TC_ROWS and n <= 32
    tiles_bytes = 4 * KERNEL_F * (TC_ROWS * 2 + 2 * TC_ROWS + 5 * 32)
    assert 4 * 9 * 32 * KERNEL_F <= tiles_bytes < dk.tc_smem_bytes()


def _covered(c, n, L, plan):
    """A numpy model of the kernel's loops over one layer: CTA (group g,
    chain b) takes lanes [g G L, g G L + G L) of chain b (fewer in the last
    group), writes the lanes from 3N on as zeros once, and for each dst
    atom i stacks its real lanes ``lanes_per_tile`` to a tile, row
    r = l N + j of a tile being source atom j of the tile's lane l.
    Returns the times each (chain, lane, dst atom, source row) is computed,
    the times each lane is zero-written, and the lane tiles of each CTA."""
    n_chunks = -(-3 * n // L)
    lp = n_chunks * L
    t = plan.lanes_per_tile
    seen = np.zeros((c, lp, n, n), np.int64)
    zeroed = np.zeros((c, lp), np.int64)
    tiles = []
    for g in range(plan.groups):  # blockIdx.x; every chain (blockIdx.y) alike
        lb = g * plan.chunks * L
        nl = min(plan.chunks * L, lp - lb)
        nreal = min(nl, 3 * n - lb)
        assert nreal >= 1  # every CTA starts below the padding
        zeroed[:, lb + nreal:lb + nl] += 1
        count = 0
        for l0 in range(0, nreal, t):
            rows = min(t, nreal - l0) * n
            r = np.arange(TC_ROWS)
            real = r < rows
            assert rows <= TC_ROWS
            lane, j = lb + l0 + r[real] // n, r[real] % n
            for i in range(n):
                np.add.at(seen, (slice(None), lane, i, j), 1)
            count += 1
        tiles.append(count)
    return seen, zeroed, tiles


@pytest.mark.parametrize("c", [1, 3, 128, 130])
@pytest.mark.parametrize("L", [1, 3, 4, 6, 57])
@pytest.mark.parametrize("n", [2, 5, 19, 29, 32])
def test_work_plan_covers_every_lane_row_and_atom_once(n, L, c):
    """At the G ``div_tc_plan`` chooses: every (chain, real lane, dst atom,
    source row) is computed exactly once, the padded lanes (from 3N on)
    are only zero-written, once each, and no tile holds more than 64 rows.
    The grid is ceil(n_chunks / G) x C and the choice is no worse than any
    other G by the plan's own cost."""
    n_chunks = -(-3 * n // L)
    plan = dk.div_tc_plan(c, n, L, n_chunks, H100_SMS)
    assert 1 <= plan.chunks <= n_chunks and plan.lanes_per_tile == TC_ROWS // n
    assert plan.groups == -(-n_chunks // plan.chunks) and plan.ctas == plan.groups * c
    seen, zeroed, tiles = _covered(1, n, L, plan)  # chains repeat the same plan
    assert (seen[:, :3 * n] == 1).all() and (seen[:, 3 * n:] == 0).all()
    assert (zeroed[:, :3 * n] == 0).all() and (zeroed[:, 3 * n:] == 1).all()

    def cost(p):
        longest = max(dk._group_tiles(n, L, n_chunks, p.chunks, q) for q in range(p.groups))
        return -(-p.ctas // H100_SMS) * (1 + longest)

    assert max(tiles) == max(dk._group_tiles(n, L, n_chunks, plan.chunks, q)
                             for q in range(plan.groups))
    for g in range(1, n_chunks + 1):
        assert cost(plan) <= cost(dk.div_tc_plan(c, n, L, n_chunks, H100_SMS, g))
    if (c, n, L) in ((128, 19, 4), (130, 19, 4)):  # the node's shape: a chain a CTA, one wave
        assert (plan.chunks, plan.groups, plan.lanes_per_tile) == (15, 1, 3)
        assert tiles == [19]


def test_work_plan_at_every_chunk_count_and_across_chains():
    """Any G from 1 to n_chunks covers every (chain, lane, atom, row) once,
    here with the chains written out (C = 3, N = 19, L = 4); a G outside
    that range raises."""
    n, L, c = 19, 4, 3
    n_chunks = -(-3 * n // L)
    for g in range(1, n_chunks + 1):
        plan = dk.div_tc_plan(c, n, L, n_chunks, H100_SMS, g)
        seen, zeroed, _ = _covered(c, n, L, plan)
        assert (seen[:, :3 * n] == 1).all() and (seen[:, 3 * n:] == 0).all()
        assert (zeroed[:, 3 * n:] == 1).all() and zeroed[:, :3 * n].sum() == 0
    for bad in (0, n_chunks + 1):
        with pytest.raises(ValueError, match="chunks_per_cta"):
            dk.div_tc_plan(c, n, L, n_chunks, H100_SMS, bad)


def _unpack_tf32_matrix(packed: torch.Tensor, k: int, n: int):
    """The inverse of ``pair_layer_kernel._pack_tf32_matrix``: (hi, lo) of
    a k x n matrix."""
    parts = packed.reshape(k // 8, n // 8, 8, 4, 2, 2)  # ks, nt, g, t, hi|lo, e
    return [parts[..., h, :].permute(0, 3, 4, 1, 2).reshape(k, n) for h in range(2)]


def test_pack_tf32_stacks_round_trips_to_the_stacks():
    """Per layer phi's three matrices, w's (its first matrix without the zero
    rows MLPStacks pads it to 2F with), the update MLP's (its last without
    the 2F columns nothing reads), U and V: 2 x 23F² values a layer; each
    unpacks to ``split_tf32`` of the stacks' own matrix, and hi + lo is the
    matrix within 2^-22 of its magnitude."""
    f, layers = 16, 3
    _, stacks = _setup(f=f, layers=layers)
    packed = dk.pack_tf32_stacks(stacks)
    assert packed.shape == (layers, 2 * 23 * f * f) and packed.is_contiguous()
    for ly in range(layers):
        phi, w, up = 3 * ly, 3 * ly + 1, 3 * ly + 2
        assert torch.count_nonzero(stacks.w1[w, f:]) == 0  # the padding left out
        mats = (stacks.w1[phi], stacks.w2[phi], stacks.w3[phi], stacks.w1[w, :f], stacks.w2[w],
                stacks.w3[w], stacks.w1[up], stacks.w2[up], stacks.w3[up, :, :3 * f],
                stacks.uk[ly], stacks.vk[ly])
        off = 0
        for m in mats:
            k, cols = m.shape
            hi, lo = _unpack_tf32_matrix(packed[ly, off:off + 2 * k * cols], k, cols)
            want_hi, want_lo = split_tf32(m)
            assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
            assert ((hi.double() + lo.double() - m.double()).abs()
                    <= 2.0 ** -22 * m.abs().double() + 1e-30).all()
            off += 2 * k * cols
        assert off == 2 * 23 * f * f


def _mm(a: torch.Tensor, w: torch.Tensor, terms: str) -> torch.Tensor:
    """a @ w as the kernel's mma3 forms it: both operands split by
    ``split_tf32`` (cvt.rna twice); "3x" sums lo·w_hi + hi·w_lo + hi·w_hi,
    "1x" only hi·w_hi (plain TF32). Products and sums in f64, rounded to f32
    once."""
    hi, lo = split_tf32(a)
    w_hi, w_lo = split_tf32(w)
    d = torch.float64
    out = hi.to(d) @ w_hi.to(d)
    if terms == "3x":
        out = out + lo.to(d) @ w_hi.to(d) + hi.to(d) @ w_lo.to(d)
    return out.to(torch.float32)


def _model_div_kernel(inp, stacks, L, terms, monkeypatch):
    """``div_kernel_plain`` with every product the kernel takes on the tensor
    cores in its TF32 arithmetic: the message MLPs (primal and tangent), the
    update MLP's tangent, and d_v U and d_v V (U and V ride as a tensor type
    that takes its products through ``_mm``)."""
    class Weight(torch.Tensor):
        @classmethod
        def __torch_function__(cls, func, types, args=(), kwargs=None):
            if func in (torch.Tensor.__matmul__, torch.Tensor.matmul, torch.matmul):
                return _mm(*(x.as_subclass(torch.Tensor) for x in args), terms)
            return super().__torch_function__(func, types, args, kwargs or {})

    def mlp_store(x, w: MLPWeights, bf16):
        h1 = _mm(x, w.w1, terms) + w.b1
        a1 = _ln_silu(h1, w.ln1_scale, w.ln1_bias)
        h2 = _mm(a1, w.w2, terms) + w.b2
        return h1, h2, _mm(_ln_silu(h2, w.ln2_scale, w.ln2_bias), w.w3, terms) + w.b3

    def mlp_tan(dx, w, h1, h2, bf16):
        da1 = _ln_silu_tan(h1, _mm(dx, w.w1, terms), w.ln1_scale, w.ln1_bias)
        da2 = _ln_silu_tan(h2, _mm(da1, w.w2, terms), w.ln2_scale, w.ln2_bias)
        return _mm(da2, w.w3, terms)

    monkeypatch.setattr(dk, "_mlp_store", mlp_store)
    monkeypatch.setattr(dk, "_mlp_tan", mlp_tan)
    try:
        out = dk.div_kernel_plain(inp, stacks._replace(uk=stacks.uk.as_subclass(Weight),
                                                       vk=stacks.vk.as_subclass(Weight)), L)
        return out.as_subclass(torch.Tensor)
    finally:
        monkeypatch.undo()


def _ln_silu(h, scale, bias):
    mu = h.mean(-1, keepdim=True)
    cen = h - mu
    rstd = torch.rsqrt((cen ** 2).mean(-1, keepdim=True) + 1e-5)
    return torch.nn.functional.silu(cen * rstd * scale + bias)


def test_3xtf32_model_of_the_chain_meets_the_bar_and_1xtf32_does_not(monkeypatch):
    """B7's whole chain (3 layers, N = 5, F = 32) with every message-MLP
    product in the kernel's 3xTF32 arithmetic is within B7's bar (1e-4 of
    max |plain|) of the plain version; with plain TF32 products it is not."""
    inp, stacks = _setup(n=5, f=32, layers=3, c=2, L=4, seed=3)
    with torch.no_grad():
        ref = dk.div_kernel_plain(inp, stacks, 4)
        err = {}
        for terms in ("3x", "1x"):
            got = _model_div_kernel(inp, stacks, 4, terms, monkeypatch)
            err[terms] = ((got - ref).abs().max() / ref.abs().max()).item()
    assert err["3x"] <= 1e-4, err
    assert err["1x"] > 1e-4, err
    assert err["3x"] * 20 < err["1x"]
