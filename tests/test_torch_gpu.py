"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one;
this file imports neither jax nor ti_tpu, so it runs where only PyTorch
is installed:
``python -m pytest --noconftest tests/test_torch_gpu.py -m gpu``
(``--noconftest`` skips tests/conftest.py, which imports JAX).
Bars (max |kernel - plain| / max |plain|): 2e-5 in f32 (full f32 FMA in
both), 2e-2 in bf16_agg (one bf16 rounding may flip where the two sum in
another order).
"""

import pytest
import torch

from ti_torch.models.cpainn import CPaiNN
from ti_torch.ops import _build
from ti_torch.ops.pair_layer_kernel import pack_layer, pair_layer, pair_layer_plain
from ti_torch.ops.pair_tangent_kernel import pair_tangent, pair_tangent_plain

N, F, B = 19, 128, 6
BARS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _layer(dtype, k=0):
    torch.manual_seed(0)
    params = {n: t.detach() for n, t in CPaiNN(F, 1, n_atoms=N).state_dict().items()}
    w = pack_layer(params, 0, F, dtype, "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")).to(dtype)

    x = 0.3 * torch.randn(B, N, 3, generator=g, device="cuda")
    base = (x, rnd(B, N, F), rnd(B, 3, N, F, scale=0.3), rnd(B, N * N, F))
    lanes = (torch.randn(B, k, N, 3, generator=g, device="cuda"), rnd(B, k, N, F, scale=0.1),
             rnd(B, k, 3, N, F, scale=0.1), rnd(B, k, N * N, F, scale=0.1))
    return w, base, lanes


def _assert_close(outs, refs, dtype):
    for a, r in zip(outs, refs):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert torch.isfinite(a.float()).all()
        err = (a.float() - r.float()).abs().max() / r.float().abs().max()
        assert err.item() <= BARS[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_layer_kernel_matches_plain(dtype):
    _card()
    w, base, _ = _layer(dtype)
    before = _build.LAUNCHES["pair_layer"]
    out = pair_layer(*base, w, 10.0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pair_layer"] == before + 1
    _assert_close(out, pair_layer_plain(*base, w, 10.0), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,k,lane_block", [(torch.float32, 3, 1), (torch.bfloat16, 8, 4),
                                                (torch.bfloat16, 6, 2)])
def test_pair_tangent_kernel_matches_plain(dtype, k, lane_block):
    _card()
    w, base, lanes = _layer(dtype, k)
    before = _build.LAUNCHES["pair_tangent"]
    out = pair_tangent(*base, *lanes, w, 10.0, lane_block)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pair_tangent"] == before + 1
    _assert_close(out, pair_tangent_plain(*base, *lanes, w, 10.0, lane_block), dtype)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take():
    _card()
    w, (x, s, v, e), lanes = _layer(torch.float32, 4)
    with pytest.raises(ValueError, match="F=128"):
        pair_layer(x, s[..., :64].contiguous(), v, e, w, 10.0)
    with pytest.raises(ValueError, match="contiguous"):
        pair_layer(x, s.transpose(0, 1).contiguous().transpose(0, 1), v, e, w, 10.0)
    with pytest.raises(ValueError, match="must be"):
        pair_layer(x, s.to(torch.bfloat16), v, e, w, 10.0)
    with pytest.raises(ValueError, match="lane_block"):
        pair_tangent(x, s, v, e, *lanes, w, 10.0, 3)
    with pytest.raises(ValueError, match="shared memory"):
        pair_tangent(x, s, v, e, *lanes, w, 10.0, 2)
