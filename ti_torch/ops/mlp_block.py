"""The MLP-block math shared by the dense forward and both CUDA kernels'
plain versions (port of ti_tpu/ops/pallas_kernels.py:31-178).

One reference MLP is Dense-LN-SiLU ×2 -> Dense. Precision profiles:

- f32: every product and statistic in float32.
- bf16 (``compute_dtype=torch.bfloat16``): bf16 dot operands, f32
  accumulation and f32 outputs, f32 LayerNorm.
- bf16_agg (``bf16_out=True``): bf16 operands AND bf16 dot outputs — each
  product is accumulated in f32 and rounded once to bf16 — with f32
  LayerNorm statistics over bf16-stored activations.

Every bf16 product is written as ``(a_bf16.float() @ b_bf16.float())``
so the CPU and the card compute the same thing: bf16 operands, f32
accumulation, rounded once where the profile rounds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16


class MLPWeights(NamedTuple):
    """Weights of one reference-style MLP, matrices as (in, out)."""

    w1: torch.Tensor  # (f_in, f_hidden)
    b1: torch.Tensor
    ln1_scale: torch.Tensor
    ln1_bias: torch.Tensor
    w2: torch.Tensor  # (f_hidden, f_hidden)
    b2: torch.Tensor
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor
    w3: torch.Tensor  # (f_hidden, f_out)
    b3: torch.Tensor


def mlp_weights(params, prefix: str) -> MLPWeights:
    """MLPWeights of the MLP at ``prefix`` in a CPaiNN state dict
    (``nn.Linear.weight`` is (out, in); the math here uses (in, out))."""
    def g(name):
        return params[f"{prefix}.{name}"]

    return MLPWeights(
        w1=g("Dense_0.weight").t(), b1=g("Dense_0.bias"),
        ln1_scale=g("LayerNorm_0.weight"), ln1_bias=g("LayerNorm_0.bias"),
        w2=g("Dense_1.weight").t(), b2=g("Dense_1.bias"),
        ln2_scale=g("LayerNorm_1.weight"), ln2_bias=g("LayerNorm_1.bias"),
        w3=g("Dense_2.weight").t(), b3=g("Dense_2.bias"),
    )


def dot_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 accumulation, f32 result."""
    return a.to(BF16).float() @ b.to(BF16).float()


def dot_bf16_agg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 accumulation, rounded once to bf16."""
    return dot_bf16(a, b).to(BF16)


def _ln_silu_block(h, scale, bias):
    """LayerNorm -> SiLU, the elementwise segment between the MLP dots."""
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    return F.silu((h - mu) * torch.rsqrt(var + 1e-5) * scale + bias)


def _ln_silu_block_agg(h, scale, bias):
    """LN -> SiLU with f32 statistics over a low-precision input; the
    output is stored back in the input dtype."""
    h32 = h.float()
    mu = h32.mean(-1, keepdim=True)
    var = ((h32 - mu) ** 2).mean(-1, keepdim=True)
    l = (h32 - mu) * torch.rsqrt(var + 1e-5) * scale + bias
    return F.silu(l).to(h.dtype)


def _mlp_block(x, w: MLPWeights, compute_dtype=None, bf16_out: bool = False):
    """The MLP body (see the module docstring for the profiles)."""
    if bf16_out and compute_dtype is not None:
        h = dot_bf16_agg(x, w.w1) + w.b1.to(BF16)
        h = _ln_silu_block_agg(h, w.ln1_scale, w.ln1_bias)
        h = dot_bf16_agg(h, w.w2) + w.b2.to(BF16)
        h = _ln_silu_block_agg(h, w.ln2_scale, w.ln2_bias)
        return dot_bf16_agg(h, w.w3) + w.b3.to(BF16)
    dot = dot_bf16 if compute_dtype is not None else torch.matmul
    h = dot(x, w.w1) + w.b1
    h = _ln_silu_block(h, w.ln1_scale, w.ln1_bias)
    h = dot(h, w.w2) + w.b2
    h = _ln_silu_block(h, w.ln2_scale, w.ln2_bias)
    return dot(h, w.w3) + w.b3


def _ln_silu_jvp(h, dh, scale, bias):
    """(LayerNorm -> SiLU) with its JVP, recompute-style."""
    mu = h.mean(-1, keepdim=True)
    cen = h - mu
    var = (cen ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + 1e-5)
    l = cen * rstd * scale + bias

    dmu = dh.mean(-1, keepdim=True)
    dcen = dh - dmu
    dvar = 2.0 * (cen * dh).mean(-1, keepdim=True)
    drstd = -0.5 * rstd * rstd * rstd * dvar
    dl = (dcen * rstd + cen * drstd) * scale

    sig = torch.sigmoid(l)
    return l * sig, sig * (1.0 + l * (1.0 - sig)) * dl


def _mlp_block_jvp(x, dx, w: MLPWeights):
    """(out, dout) of the f32 MLP under input tangent dx (weights fixed).
    Broadcasts: a (B, 1, ...) primal against (B, K, ...) tangent lanes
    computes the primal chain once."""
    h = x @ w.w1 + w.b1
    dh = dx @ w.w1
    a, da = _ln_silu_jvp(h, dh, w.ln1_scale, w.ln1_bias)
    h = a @ w.w2 + w.b2
    dh = da @ w.w2
    a, da = _ln_silu_jvp(h, dh, w.ln2_scale, w.ln2_bias)
    return a @ w.w3 + w.b3, da @ w.w3
