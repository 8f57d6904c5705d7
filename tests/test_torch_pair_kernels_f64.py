"""Kernels B1/B2 and B3 at F = 64 on the tensor cores, in f32 (libraries
pair_layer_tf32x3_f64 and pair_tangent_tf32x3_f64) and in bf16_agg
(pair_layer_mma_f64 and pair_tangent_mma_f64), each built from its F = 128
source with -DPK_F=64, as far as the CPU reaches them, and the path
``ti_tpu`` runs through them: ``validate_mdqm9_physics``'s evaluation at its
default width.

- The route table at F = 64: both types take their ``_f64`` library at
  chain blocks 1-4, B3's ``"mma"`` too; ``"fma"`` refuses the width, naming
  the widths that run.
- The shared-memory and lane plans at F = 64: four layer CTAs of 50,432
  bytes an SM in f32, bf16_agg row tiles of 34,048 bytes (min(C, 4) a CTA),
  B3 bf16_agg lane blocks of 1, 2 or 4 (113,664 bytes at 4), B3 f32 lane
  tiles of 128 rows (181,504 bytes).
- The plain B1 and B3 at F = 64 (the kernels' yardsticks on the card) in
  both types against ``ti_tpu``'s Pallas kernels in interpret mode, on
  weights carried across by ``params_from_flax``, at the CLI's 4 atoms and
  its K = 12 lanes, on the first layer of the slice's field: one jitted
  JAX call a type holds both kernels (eager, each took 11-13 s on the CPU):
  B1 f32 at 2e-5 and bf16_agg at 4e-2 of max |ref|; B3 f32 velocity rtol
  2e-4 / atol 2e-5, lanes rtol 5e-4 / atol 5e-5, bf16_agg at 4e-2 of max
  |ref| (the bars of tests/test_torch_pair_tangent_f256.py).
- The CLI's evaluation route, ``make_ode_sampler(traj_drift=
  pair_kernel_drift, div_drift=pair_tangent_div_fn)`` with the exact
  divergence (the full orthogonal frame, K = 3N = 12, which makes dlogp
  independent of the draw), at 4 atoms, F = 64, 3 layers, 3 chains and
  GL-2 (3 Gauss gaps of one step), against ``ti_tpu``'s same sampler in
  interpret mode: samples rtol 1e-4 / atol 1e-5, dlogp rtol 1e-3. The
  solver is the CLI's ``--solver euler`` (RK4 is its default): ``ti_tpu``'s
  jitted sampler then traces the interpret-mode kernels once a step, not
  four times (8 s where RK4 took 22 s on the CPU); the kernels and the node
  route are the same.
- ``validate_mdqm9_physics.check_flags`` on a ``cuda`` device object (no
  card is touched): ``--features 64`` passes with each of the four kernel
  flags, ``--features 32`` is refused.
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
from ti_tpu.ops.pair_layer_kernel import pair_kernel_drift as jax_pair_kernel_drift
from ti_tpu.ops.pair_tangent_kernel import apply_dense_pair_tangent as jax_pair_tangent
from ti_tpu.ops.pair_tangent_kernel import pair_tangent_div_fn as jax_pair_tangent_div_fn
from ti_tpu.sampling.drivers import make_ode_sampler as jax_make_ode_sampler
from ti_tpu.sampling.drivers import molecular_v_fn_of as jax_molecular_v_fn_of
from ti_torch.cli import validate_mdqm9_physics
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.convert import params_from_flax
from ti_torch.models.cpainn import CPaiNN
from ti_torch.ops import _build
from ti_torch.ops import pair_layer_kernel as plk
from ti_torch.ops import pair_tangent_kernel as ptk
from ti_torch.ops.mlp_block import BF16
from ti_torch.sampling.drivers import make_ode_sampler, molecular_v_fn_of

F64 = 64
N_ATOMS, LAYERS, B, K = 4, 3, 3, 12  # validate_mdqm9_physics's defaults; its exact frame
ROUTE = "F = 64, 128 and 256 run in B1, B2 and B3 on the tensor cores"
TEMPS = (1000.0, 300.0)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("chain_block", [1, 2, 3, 4])
def test_route_table_at_f64(bf16, chain_block):
    """At F = 64 B1 and B2 take the type's ``_f64`` library for every chain
    block (bf16_agg with min(C, 4) row tiles a CTA), B3's ``"mma"`` the
    type's ``_f64`` build; each is registered, built from its F = 128
    source with -DPK_F=64, and names its own C functions."""
    layer = "pair_layer_mma" if bf16 else "pair_layer_tf32x3"
    tangent = "pair_tangent_mma" if bf16 else "pair_tangent_tf32x3"
    assert plk._route(bf16, chain_block, None, F64) == f"{layer}_f64"
    assert plk._route(bf16, chain_block, "tc", F64) == f"{layer}_f64"
    assert plk._route(bf16, chain_block, None) == layer
    assert ptk._route(bf16, "mma", F64) == f"{tangent}_f64"
    for lib in (layer, tangent):
        assert plk.LIB_WIDTHS[f"{lib}_f64"] == F64 and f"{lib}_f64" in _build.KERNELS
        assert _build.BUILT_FROM[f"{lib}_f64"] == (lib, ("-DPK_F=64",))
        assert _build.source_of(f"{lib}_f64") == lib
    if bf16:
        assert plk.mma_tiles(chain_block, F64) == chain_block


@pytest.mark.parametrize("bf16", [False, True])
def test_fma_refuses_f64(bf16):
    """The f32-FMA kernels (pair_layer.cu, pair_tangent.cu) stay F = 128's
    yardsticks: B1's ``"fma"`` route keeps its library, whose launch check
    refuses F = 64, and B3's refuses it in its route, each naming the widths
    that run; B3's ``"fma"`` takes f32 weights only."""
    assert plk._route(bf16, 1, "fma", F64) == "pair_layer"
    with pytest.raises(plk.WidthRefusal, match=f"pair_layer is built for F=128, got F=64; {ROUTE}"):
        plk.check_width(F64, "pair_layer", plk.LIB_WIDTHS.get("pair_layer", plk.KERNEL_F))
    if bf16:
        with pytest.raises(ValueError, match="takes f32 weights"):
            ptk._route(True, "fma", F64)
        return
    refusal = f"pair_tangent is built for F=128, got F=64; {ROUTE}"
    with pytest.raises(plk.WidthRefusal, match=refusal):
        ptk._route(False, "fma", F64)


@pytest.mark.parametrize("f", [16, 32, 96])
def test_unbuilt_widths_are_refused(f):
    """A width no library is built for routes to F = 128's libraries, whose
    launch check refuses it, naming the widths that run."""
    for lib in (plk._route(False, 1, None, f), plk._route(True, 4, None, f),
                ptk._route(False, "mma", f), ptk._route(True, "mma", f)):
        assert lib in ("pair_layer_tf32x3", "pair_layer_mma", "pair_tangent_tf32x3",
                       "pair_tangent_mma")
        with pytest.raises(plk.WidthRefusal, match=f"{lib} is built for F=128, got F={f}; {ROUTE}"):
            plk.check_width(f, lib, plk.LIB_WIDTHS.get(lib, plk.KERNEL_F))


def test_layer_plans_at_f64():
    """csrc/pair_layer_tf32x3.cu at F = 64: 4 warps and 50,432 bytes a CTA
    (four an SM), the 64-row tile of whole groups (16 at N = 4, the last
    tile ragged); csrc/pair_layer_mma.cu: 34,048-byte row tiles, four a CTA
    at most where six would fit. F = 128 and 256 keep theirs."""
    assert plk.tc_threads(F64) == 128 and plk.tc_smem_bytes(F64) == 50_432
    assert 4 * plk.tc_smem_bytes(F64) <= 233_472  # an SM's shared memory
    assert tuple(plk.tile_plan(1024, 4, F64)) == (16, 64, 256, 50_432)
    assert tuple(plk.tile_plan(130, 19, F64)) == (3, 57, 824, 50_432)
    assert plk.mma_tile_bytes(F64) == 34_048 and plk.SMEM_LIMIT // 34_048 == 6
    assert plk.mma_max_tiles(F64) == 4 and [plk.mma_tiles(c, F64) for c in (5, 8)] == [4, 4]
    assert tuple(plk.mma_tile_plan(1024, 4, 4, F64)) == (16, 4, 64, 4 * 34_048)
    assert tuple(plk.mma_tile_plan(130, 19, 3, F64)) == (3, 3, 275, 3 * 34_048)
    assert (plk.mma_max_tiles(), plk.mma_max_tiles(256)) == (3, 1)
    assert (plk.tc_smem_bytes(), plk.tc_smem_bytes(256)) == (99_584, 197_888)


@pytest.mark.parametrize("lane_block,need", [(1, 76_800), (2, 89_088), (4, 113_664)])
def test_tangent_plans_at_f64(lane_block, need):
    """B3 bf16_agg at F = 64 keeps F = 128's layout (every residual tile in
    shared memory) with lane blocks of 1, 2 or 4: 4 divides the CLI's frame
    (K = 12) and the Hutchinson counts 8 and 16. B3 f32 stacks lanes into
    128-row tiles: the CLI's 12 lanes at N = 4 are one tile."""
    assert ptk.smem_bytes(True, lane_block, F64) == need <= plk.SMEM_LIMIT
    ptk._check_lane_block(True, 12, lane_block, F64)
    assert [ptk._pick_lane_block(k, True, F64) for k in (12, 8, 16, 6, 3)] == [4, 4, 4, 2, 1]
    assert ptk._pick_lane_block(12, False, F64) == 1
    assert ptk.mma_scratch_tiles(F64) == 10 and ptk.tf32_scratch_floats(4, F64) == 10 * 4 * F64
    assert ptk.tf32_tile_rows(F64) == 128 and ptk.tf32_smem_bytes(F64) == 181_504
    assert tuple(ptk.lane_tile_plan(4, 12, F64)) == (32, 1, 12)
    assert tuple(ptk.lane_tile_plan(19, 57, F64)) == (6, 10, 3)
    assert tuple(ptk.lane_tile_plan(32, 5, F64)) == (4, 2, 1)
    assert ptk.smem_bytes(True, 4) == 222_976 and ptk.tf32_smem_bytes() == 219_392


@pytest.fixture(scope="module")
def setup():
    """The slice's field (flax's init of 3 layers, one compile) in both
    packages, and its first layer alone (the same weights but for layers 1
    and 2)."""
    jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=2)
    jm = JaxCPaiNN(n_features=F64, score_layers=LAYERS, conditioning="ambient")
    jp = jax.jit(lambda key: jm.init(key, jt))(jax.random.PRNGKey(0))
    later = {f"{kind}_{i}" for kind in ("message", "update") for i in range(1, LAYERS)}
    jp1 = {"params": {k: v for k, v in jp["params"].items() if k not in later}}
    jm1 = JaxCPaiNN(n_features=F64, score_layers=1, conditioning="ambient")
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2)
    rng = np.random.default_rng(1)
    x0 = (0.1 * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    x0 -= x0.mean(axis=1, keepdims=True)
    return dict(jt=jt, template=template, x0=x0, field=(
        jm, jp, params_from_flax(jax.tree_util.tree_map(np.asarray, jp)),
        CPaiNN(F64, LAYERS, n_atoms=N_ATOMS)), layer=(
        jm1, jp1, params_from_flax(jax.tree_util.tree_map(np.asarray, jp1)),
        CPaiNN(F64, 1, n_atoms=N_ATOMS)))


def _at(x0, b=2):
    x = 3.0 * x0[:b]
    t = np.array([0.2, 0.9, 0.5][:b], np.float32)
    temps = np.tile(np.array(TEMPS, np.float32), (b, 1))
    z = np.random.default_rng(5).standard_normal((b, K, N_ATOMS, 3)).astype(np.float32)
    return x, t, temps, z


@pytest.fixture(scope="module")
def jax_refs(setup):
    """Per type, ``ti_tpu``'s Pallas B1 forward and B3 (velocity, lanes) in
    interpret mode on the first layer: one jitted call."""
    jm, jp, _, _ = setup["layer"]
    jt = setup["jt"]
    refs = {}
    for compute_dtype in (None, "bf16_agg"):
        def both(p, x, t, temps, z, cd=compute_dtype):
            kw = dict(interpret=True, compute_dtype=cd)
            return (jax_pair_kernel(jm, p, x, t, temps, jt.atom_ids, jt.edges, **kw),
                    jax_pair_tangent(jm, p, x, t, temps, z, jt.atom_ids, jt.edges, **kw))

        b1, (vel, dvel) = jax.jit(both)(jp, *map(jnp.asarray, _at(setup["x0"])))
        refs[compute_dtype] = tuple(np.asarray(a) for a in (b1, vel, dvel))
    return refs


@pytest.mark.parametrize("compute_dtype,packed,bar", [
    (None, 2 * 15 * F64 ** 2, 2e-5), ("bf16_agg", 15 * F64 ** 2, 4e-2)])
def test_plain_b1_matches_jax_at_f64(setup, jax_refs, compute_dtype, packed, bar):
    """``apply_dense_pair_kernel`` at F = 64 (the plain version, the CPU's
    route; the weights carry the packing their ``_f64`` library reads)
    against ``ti_tpu``'s Pallas B1 in interpret mode."""
    _, _, params, model = setup["layer"]
    x, t, temps, _ = _at(setup["x0"])
    ref = jax_refs[compute_dtype][0]
    pm = plk.prepare(model, params, setup["template"], compute_dtype, torch.device("cpu"))
    assert all(w.mma is not None and w.mma.numel() == packed for w in pm.layers)
    out = plk.apply_dense_pair_kernel(pm, torch.from_numpy(x), torch.from_numpy(t),
                                      torch.from_numpy(temps)).numpy()
    assert out.shape == x.shape and np.isfinite(out).all()
    scale = max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(out / scale, ref / scale, atol=bar)


@pytest.mark.parametrize("compute_dtype", [None, "bf16_agg"])
def test_plain_b3_matches_jax_at_f64(setup, jax_refs, compute_dtype):
    """The plain B3 through ``apply_dense_pair_tangent`` at F = 64 (2 chains,
    the CLI's K = 12 lanes) against ``ti_tpu``'s Pallas B3 in interpret
    mode."""
    _, _, params, model = setup["layer"]
    x, t, temps, z = _at(setup["x0"])
    b = x.shape[0]
    _, vel_j, dvel_j = jax_refs[compute_dtype]
    pm = plk.prepare(model, params, setup["template"], compute_dtype, torch.device("cpu"))
    vel, dvel = ptk.apply_dense_pair_tangent(pm, torch.from_numpy(x), torch.from_numpy(t),
                                             torch.from_numpy(temps), torch.from_numpy(z))
    assert vel.shape == (b, N_ATOMS, 3) and dvel.shape == (b, K, N_ATOMS, 3)
    if compute_dtype is None:
        np.testing.assert_allclose(vel.numpy(), np.asarray(vel_j), rtol=2e-4, atol=2e-5)
        for lane in range(K):
            np.testing.assert_allclose(dvel[:, lane].numpy(), np.asarray(dvel_j[:, lane]),
                                       rtol=5e-4, atol=5e-5)
        return
    for a, r in ((vel, vel_j), (dvel, dvel_j)):
        r = np.asarray(r)
        scale = max(np.abs(r).max(), 1e-3)
        np.testing.assert_allclose(a.numpy() / scale, r / scale, atol=4e-2)


def test_cli_kernel_route_matches_jax_at_f64(setup):
    """The CLI's evaluation route at its own width in both packages: B1 in
    f32 on the trajectory, B3 in f32 at the Gauss nodes on the full
    orthogonal frame (the exact divergence), 3 Gauss gaps of one step; on
    the CPU the port takes the kernels' plain versions."""
    jm, jp, params, model = setup["field"]
    jt, template, x0 = setup["jt"], setup["template"], setup["x0"]
    temps = np.tile(np.array(TEMPS, np.float32), (B, 1))
    kw = dict(solver="euler", n_steps=3, n_save=2, divergence="exact", steps_per_dispatch=16,
              dlogp_quad_points=2, dlogp_quad="gauss", num_probes=K, probe_mode="orthogonal")
    ref = jax_make_ode_sampler(
        jax_molecular_v_fn_of(jm, jp, jt),
        traj_drift=jax_pair_kernel_drift(jm, jp, jt, interpret=True),
        div_drift=jax_pair_tangent_div_fn(jm, jp, jt, num_probes=K, probe_mode="orthogonal",
                                          interpret=True), **kw,
    )(jnp.asarray(x0), jnp.asarray(temps), jax.random.PRNGKey(0))
    _build.reset_launches()
    out = make_ode_sampler(
        molecular_v_fn_of(model, params, template, device="cpu"),
        traj_drift=plk.pair_kernel_drift(model, params, template, device="cpu"),
        div_drift=ptk.pair_tangent_div_fn(model, params, template, num_probes=K,
                                          probe_mode="orthogonal", device="cpu"),
        device="cpu", **kw,
    )(x0, temps, torch.Generator().manual_seed(0))
    assert not any(_build.LAUNCHES.values())
    xs, dlogp = out.xs.numpy(), out.dlogp.numpy()
    assert xs.shape == np.asarray(ref.xs).shape == (B, 2, N_ATOMS, 3)
    np.testing.assert_allclose(xs, np.asarray(ref.xs), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dlogp[:, -1], np.asarray(ref.dlogp)[:, -1], rtol=1e-3)


@pytest.mark.parametrize("traj_impl,div_impl", [
    ("pair_kernel", "pair_tangent"), ("pair_kernel_bf16", "pair_tangent_bf16"),
    ("pair_kernel", "default"), ("default", "pair_tangent_bf16")])
def test_validate_cli_takes_f64_and_refuses_f32_width_on_cuda(traj_impl, div_impl):
    """``check_flags`` with a ``cuda`` device object (no card is touched):
    every kernel flag passes at the CLI's default ``--features 64``, and
    ``--features 32``, built by no library, raises the width refusal naming
    the first flag's library."""
    dev = torch.device("cuda")
    flags = ["--quad_dlogp", "--traj_impl", traj_impl, "--div_impl", div_impl]
    args = validate_mdqm9_physics.parse(flags)
    assert args.features == F64
    validate_mdqm9_physics.check_flags(args, dev)
    first = ("pair_layer_mma" if traj_impl.endswith("bf16") else "pair_layer_tf32x3"
             ) if traj_impl != "default" else "pair_tangent_mma"
    args = validate_mdqm9_physics.parse([*flags, "--features", "32"])
    with pytest.raises(plk.WidthRefusal, match=f"{first} is built for F=128, got F=32; {ROUTE}"):
        validate_mdqm9_physics.check_flags(args, dev)


@pytest.mark.parametrize("bf16", [False, True])
def test_cpu_tensors_take_the_plain_version_at_f64(bf16):
    """On the CPU B1/B2 and B3 at F = 64 are the plain versions, bit for
    bit, and no kernel is launched or built."""
    dtype = BF16 if bf16 else torch.float32
    rng = np.random.default_rng(3)

    def t(*shape, scale=1.0, dt=dtype):
        return torch.as_tensor((scale * rng.standard_normal(shape)).astype(np.float32)).to(dt)

    b, n, k = 2, 5, 4
    base = (t(b, n, 3, scale=0.3, dt=torch.float32), t(b, n, F64), t(b, 3, n, F64, scale=0.3),
            t(b, n * n, F64))
    lanes = (t(b, k, n, 3, dt=torch.float32), t(b, k, n, F64, scale=0.1),
             t(b, k, 3, n, F64, scale=0.1), t(b, k, n * n, F64, scale=0.1))
    model = CPaiNN(F64, 1, n_atoms=n, generator=torch.Generator().manual_seed(0))
    params = {key: v.detach() for key, v in model.state_dict().items()}
    wts = plk.with_mma_weights(plk.with_tf32_weights(plk.pack_layer(params, 0, F64, dtype, "cpu")))
    before, by_route = dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES)
    outs = [plk.pair_layer(*base, wts, 10.0, 4), ptk.pair_tangent(*base, *lanes, wts, 10.0, 2)]
    refs = [plk.pair_layer_plain(*base, wts, 10.0),
            ptk.pair_tangent_plain(*base, *lanes, wts, 10.0, 2)]
    assert _build.LAUNCHES == before and _build.ROUTE_LAUNCHES == by_route
    for out, ref in zip(outs, refs):
        for a, r in zip(out, ref):
            assert a.dtype == r.dtype and torch.equal(a, r)
