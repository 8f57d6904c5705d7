"""Kernel B3 at F = 256 on the tensor cores, in bf16_agg (library
pair_tangent_mma_f256, built from csrc/pair_tangent_mma.cu with -DPK_F=256)
and in f32 (library pair_tangent_tf32x3_f256, csrc/pair_tangent_tf32x3.cu
with -DPK_F=256), as far as the CPU reaches them, and the path ``ti_tpu``
runs through them: the 10506 profile's divergence nodes.

- The route table at F = 256: both types on ``"mma"`` take their ``_f256``
  library, ``"fma"`` refuses the width naming the routes that take it, and
  every B3 library refuses F = 32, a width no library is built for.
- The shared memory of every lane block the wrapper accepts at F = 256 (1
  and 2 in bf16_agg; 4 is refused), the f32 kernel's, and the lane tiles
  of 32 rows.
- The plain B3 at F = 256 (the kernels' yardstick on the card) against
  ``ti_tpu``'s Pallas kernel in interpret mode on weights carried across by
  ``params_from_flax``: f32 at tests/test_torch_pair_tangent.py's bars
  (velocity rtol 2e-4 / atol 2e-5, lanes rtol 5e-4 / atol 5e-5), bf16_agg
  at 4e-2 of max |ref|.
- ``sample_ambient`` under the 10506 fast profile with B3 at the nodes
  (``div_forward_impl="pair_tangent"``, ``divergence="exact"``: the full
  orthogonal frame makes dlogp independent of the draw), cut to 6 atoms, F
  = 256, 2 layers, 3 chains, ``n_steps=9``, against ``ti_tpu``'s: samples
  rtol 1e-4 / atol 1e-5, dlogp rtol 1e-3 / atol 1e-3 (measured: 3.3e-4 on
  a chain whose dlogp is -0.149, |dlogp| up to 8.2; the f32 bars of
  tests/test_torch_pair_layer_f256.py on the same field). The trajectory
  is B1 in f32 (``traj_forward_impl="pair_kernel"``): with the profile's
  bf16_agg trajectory the two packages' samples part by rounding (5.5e-3
  on this field, tests/test_torch_pair_layer_f256.py).
- ``validate_mdqm9_physics.check_flags`` on a ``cuda`` device object (it
  touches no card): ``--features 256`` passes with either B3 route,
  ``--features 32`` is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_tpu.config import ambient_preset as jax_preset
from ti_tpu.config import fast_profile as jax_fast_profile
from ti_tpu.data.mdqm9 import graph_template as jax_template
from ti_tpu.data.mdqm9 import make_synthetic_molecule as jax_molecule
from ti_tpu.models.cpainn import CPaiNN as JaxCPaiNN
from ti_tpu.ops.pair_tangent_kernel import apply_dense_pair_tangent as jax_pair_tangent
from ti_tpu.sampling.drivers import sample_ambient as jax_sample_ambient
from ti_torch.cli import validate_mdqm9_physics
from ti_torch.config import ambient_preset, fast_profile
from ti_torch.data.mdqm9 import graph_template, make_synthetic_molecule
from ti_torch.models.convert import params_from_flax
from ti_torch.models.cpainn import CPaiNN
from ti_torch.ops import _build
from ti_torch.ops import pair_layer_kernel as plk
from ti_torch.ops import pair_tangent_kernel as ptk
from ti_torch.ops.mlp_block import BF16
from ti_torch.sampling.drivers import sample_ambient

F256 = 256
N_ATOMS, LAYERS, B = 6, 2, 3
SIZE = dict(n_features=F256, score_layers=LAYERS, batch_size=B)
LIBS = ("pair_tangent", "pair_tangent_mma", "pair_tangent_tf32x3", "pair_tangent_mma_f256",
        "pair_tangent_tf32x3_f256")
B3_ROUTE = "F = 64, 128 and 256 run in B1, B2 and B3 on the tensor cores"


def _inputs(dtype, f=F256, n=5, b=2, k=4, seed=3):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dt=dtype):
        return torch.as_tensor((scale * rng.standard_normal(shape)).astype(np.float32)).to(dt)

    base = (t(b, n, 3, scale=0.3, dt=torch.float32), t(b, n, f), t(b, 3, n, f, scale=0.3),
            t(b, n * n, f))
    lanes = (t(b, k, n, 3, dt=torch.float32), t(b, k, n, f, scale=0.1),
             t(b, k, 3, n, f, scale=0.1), t(b, k, n * n, f, scale=0.1))
    return base, lanes


def _weights(dtype, n=5):
    model = CPaiNN(F256, 1, n_atoms=n, generator=torch.Generator().manual_seed(0))
    params = {k: v.detach() for k, v in model.state_dict().items()}
    return plk.with_mma_weights(plk.pack_layer(params, 0, F256, dtype, "cpu"))


@pytest.mark.parametrize("bf16,lib", [(True, "pair_tangent_mma_f256"),
                                      (False, "pair_tangent_tf32x3_f256")])
def test_tensor_core_routes_take_the_f256_libraries(bf16, lib):
    """At F = 256 ``"mma"`` takes the type's ``_f256`` library, whose width
    and input check pass; at F = 128 the route is unchanged."""
    assert ptk._route(bf16, "mma", F256) == lib
    assert ptk._route(bf16, "mma") == lib.removesuffix("_f256")
    assert plk.LIB_WIDTHS[lib] == F256 and lib in _build.KERNELS
    assert _build.BUILT_FROM[lib] == (lib.removesuffix("_f256"), ("-DPK_F=256",))
    dtype = BF16 if bf16 else torch.float32
    base, _ = _inputs(dtype)
    assert plk._check_pair_inputs(*base, _weights(dtype), lib) == (2, 5, F256, dtype)


def test_fma_refuses_f256():
    """The f32-FMA kernel is built for F = 128 only: its route refuses F =
    256, naming the routes that take it."""
    assert ptk._route(False, "fma") == "pair_tangent"
    with pytest.raises(plk.WidthRefusal, match=f"pair_tangent is built for F=128, got F=256; "
                                               f"{B3_ROUTE}"):
        ptk._route(False, "fma", F256)
    with pytest.raises(ValueError, match="takes f32 weights"):
        ptk._route(True, "fma", F256)


@pytest.mark.parametrize("lib", LIBS)
def test_every_b3_library_refuses_f64(lib):
    """F = 32 is built by no B3 library (F = 64 now is:
    tests/test_torch_pair_kernels_f64.py): at F = 32 the tensor-core routes
    are F = 128's, and the launch check of each library refuses the width."""
    assert ptk._route(True, "mma", 32) == "pair_tangent_mma"
    assert ptk._route(False, "mma", 32) == "pair_tangent_tf32x3"
    with pytest.raises(plk.WidthRefusal, match=f"{lib} is built for F=(128|256), got F=32; "
                                               f"{B3_ROUTE}"):
        plk.check_width(32, lib, plk.LIB_WIDTHS.get(lib, plk.KERNEL_F))
    with pytest.raises(plk.WidthRefusal):
        ptk._route(False, "fma", 32)


@pytest.mark.parametrize("lane_block,accepted", [(1, True), (2, True), (4, False)])
def test_lane_blocks_and_shared_memory_at_f256(lane_block, accepted):
    """bf16_agg at F = 256 lays its work buffers out for two lanes: lane
    blocks 1 and 2 take 229,632 bytes, 4 would need 343,296 and is refused;
    the pick is the largest that fits and divides K. F = 128 keeps its
    counts."""
    need = ptk.smem_bytes(True, lane_block, F256)
    assert need == (229_632 if accepted else 343_296)
    if accepted:
        assert need <= plk.SMEM_LIMIT
        ptk._check_lane_block(True, 8, lane_block, F256)
    else:
        assert need > plk.SMEM_LIMIT
        with pytest.raises(ValueError, match=f"lane_block 4 needs {need} bytes"):
            ptk._check_lane_block(True, 8, lane_block, F256)
    assert [ptk._pick_lane_block(k, True, F256) for k in (32, 16, 6, 87, 3)] == [2, 2, 2, 1, 1]
    assert [ptk._pick_lane_block(k, True) for k in (32, 18, 87)] == [4, 2, 1]
    assert ptk._pick_lane_block(32, False, F256) == 1
    assert ptk.smem_bytes(True, 4) == 222_976 and ptk.tf32_smem_bytes() == 219_392
    assert ptk.tf32_smem_bytes(F256) == 169_856 <= plk.SMEM_LIMIT


@pytest.mark.parametrize("n,k,plan", [(29, 32, (1, 32, 1)), (29, 87, (1, 87, 1)),
                                      (32, 3, (1, 3, 1)), (16, 5, (2, 3, 1)),
                                      (10, 7, (3, 3, 1)), (2, 40, (16, 3, 8))])
def test_lane_tile_plan_at_f256(n, k, plan):
    """f32 at F = 256 stacks whole lanes into 32-row tiles (one lane a tile
    at the 10506 molecule's 29 atoms); F = 128 keeps its 64-row tiles. Every
    lane lands in exactly one tile."""
    got = ptk.lane_tile_plan(n, k, F256)
    assert tuple(got) == plan and ptk.tf32_tile_rows(F256) == 32
    assert got.lanes * n <= 32 and (got.tiles - 1) * got.lanes + got.last == k
    assert ptk.lane_tile_plan(n, k).lanes == 64 // n
    assert ptk.tf32_scratch_floats(n, F256) == 10 * n * F256 + 5 * 32 * F256
    assert ptk.mma_scratch_tiles(F256) == 14 and ptk.mma_scratch_tiles() == 10


@pytest.mark.parametrize("variant", ["mma", "fma"])
def test_cpu_tensors_take_the_plain_version_at_f256(variant):
    """On the CPU B3 at F = 256 is the plain version, bit for bit, whatever
    the variant, and no kernel is launched or built."""
    base, lanes = _inputs(torch.float32)
    wts = _weights(torch.float32)
    before, by_route = dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES)
    out = ptk.pair_tangent(*base, *lanes, wts, 10.0, 2, variant=variant)
    ref = ptk.pair_tangent_plain(*base, *lanes, wts, 10.0, 2)
    assert _build.LAUNCHES == before and _build.ROUTE_LAUNCHES == by_route
    for a, r in zip(out, ref):
        assert a.dtype == r.dtype and torch.equal(a, r)


@pytest.fixture(scope="module")
def setup():
    jt = jax_template(jax_molecule(N_ATOMS, seed=0), t_cond=2)
    jm = JaxCPaiNN(n_features=F256, score_layers=LAYERS, conditioning="ambient")
    jp = jm.init(jax.random.PRNGKey(0), jt)
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    model = CPaiNN(F256, LAYERS, n_atoms=N_ATOMS)
    template = graph_template(make_synthetic_molecule(N_ATOMS, seed=0), t_cond=2)
    rng = np.random.default_rng(1)
    x0 = (0.1 * rng.standard_normal((B, N_ATOMS, 3))).astype(np.float32)
    x0 -= x0.mean(axis=1, keepdims=True)
    return jm, jp, jt, params, model, template, x0


@pytest.mark.parametrize("compute_dtype", [None, "bf16_agg"])
def test_plain_b3_matches_jax_at_f256(setup, compute_dtype):
    """The plain B3 through ``apply_dense_pair_tangent`` at F = 256 (2
    chains, K = 4 lanes) against ``ti_tpu``'s Pallas B3 in interpret mode."""
    jm, jp, jt, params, model, template, x0 = setup
    b, k = 2, 4
    x = 3.0 * x0[:b]
    t = np.array([0.3, 0.8], np.float32)
    temps = np.tile(np.array([700.0, 300.0], np.float32), (b, 1))
    z = np.random.default_rng(5).standard_normal((b, k, N_ATOMS, 3)).astype(np.float32)
    vel_j, dvel_j = jax_pair_tangent(jm, jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(temps),
                                     jnp.asarray(z), jt.atom_ids, jt.edges, interpret=True,
                                     compute_dtype=compute_dtype)
    pm = plk.prepare(model, params, template, compute_dtype, torch.device("cpu"))
    vel, dvel = ptk.apply_dense_pair_tangent(pm, torch.from_numpy(x), torch.from_numpy(t),
                                             torch.from_numpy(temps), torch.from_numpy(z))
    assert vel.shape == (b, N_ATOMS, 3) and dvel.shape == (b, k, N_ATOMS, 3)
    if compute_dtype is None:
        np.testing.assert_allclose(vel.numpy(), np.asarray(vel_j), rtol=2e-4, atol=2e-5)
        for lane in range(k):
            np.testing.assert_allclose(dvel[:, lane].numpy(), np.asarray(dvel_j[:, lane]),
                                       rtol=5e-4, atol=5e-5)
        return
    for a, r in ((vel, vel_j), (dvel, dvel_j)):
        r = np.asarray(r)
        scale = max(np.abs(r).max(), 1e-3)
        np.testing.assert_allclose(a.numpy() / scale, r / scale, atol=4e-2)


def test_sample_ambient_10506_b3_nodes_match_jax(setup):
    """The 10506 fast profile with B3 at its nodes and the exact divergence
    (the orthogonal frame, K = 3N = 18) in both packages."""
    jm, jp, jt, params, model, template, x0 = setup
    over = dict(n_steps=9, compute_dtype="f32", traj_forward_impl="pair_kernel",
                divergence="exact", div_forward_impl="pair_tangent")
    cfg = fast_profile(ambient_preset("10506", **SIZE), **over)
    jcfg = jax_fast_profile(jax_preset("10506", **SIZE), **over)
    for c in (cfg, jcfg):
        assert (c.n_features, c.dlogp_quad, c.dlogp_quad_points, c.div_forward_impl) == \
            (F256, "gauss", 8, "pair_tangent")
    ref = jax_sample_ambient(jcfg, jm, jp, jt, x0, save=False)
    _build.reset_launches()
    out = sample_ambient(cfg, model, params, template, x0, save=False, device="cpu")
    assert not any(_build.LAUNCHES.values())
    assert out["samples"].shape == ref["samples"].shape == (B, 2, N_ATOMS, 3)
    np.testing.assert_allclose(out["samples"], ref["samples"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["dlogps"], ref["dlogps"], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("div_impl", ["pair_tangent", "pair_tangent_bf16"])
def test_validate_cli_takes_f256_and_refuses_f64_on_cuda(div_impl):
    """``check_flags`` with a ``cuda`` device object (no card is touched):
    B3 at ``--features 256`` passes, ``--features 32`` (built by no
    library) raises the width refusal naming the library."""
    dev = torch.device("cuda")
    args = validate_mdqm9_physics.parse(["--quad_dlogp", "--div_impl", div_impl,
                                         "--features", "256"])
    validate_mdqm9_physics.check_flags(args, dev)
    lib = "pair_tangent_mma" if div_impl.endswith("bf16") else "pair_tangent_tf32x3"
    args = validate_mdqm9_physics.parse(["--quad_dlogp", "--div_impl", div_impl,
                                         "--features", "32"])
    with pytest.raises(plk.WidthRefusal, match=f"{lib} is built for F=128, got F=32"):
        validate_mdqm9_physics.check_flags(args, dev)
