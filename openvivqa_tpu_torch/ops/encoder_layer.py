"""Kernel F: the whole post-LN self-attention sublayer of an eval encode with a
key-only padding bias, beside its plain PyTorch version.

Counterpart of ``fused_encoder_self_attention`` in
``openvivqa_tpu/ops/encoder_layer.py``; the CUDA source is
``csrc/encoder_layer.cu``.  Each sample attends only over its own keys, so a
sample whose keys are all masked attends uniformly over them, as the JAX
package's XLA path does (its Pallas kernel packs samples block-diagonally and
lets such a sample see other samples' values).

The attention's dot operands are rounded to the weights' dtype (bf16 on the
card, float32 on the CPU); softmax, LayerNorm and accumulators are float32.  On
the card the two projections run on gemm_sm90.cu's wgmma + TMA core under
``_cuda.gemm_plan``'s plans and the attention on block B's bf16 instance,
resident or ring by ``fused_attention.attention_block("encoder", ...)``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import _cuda
from .decode_step import _dot
from .fused_attention import attention_block


def fused_encoder_self_attention_plain(
    x, w: Dict[str, torch.Tensor], key_bias, scale: float, h: int, eps: float
):
    b, s, hd = x.shape
    d = hd // h
    op_dtype = w["wqkv"].dtype
    qkv = (_dot(x, w["wqkv"]) + w["bqkv"]).to(op_dtype).float()
    q, k, v = (part.reshape(b, s, h, d) for part in qkv.split(hd, dim=-1))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    weights = torch.softmax(logits + key_bias[:, None, None, :], dim=-1)
    weights = weights.to(op_dtype).float()
    context = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, s, hd)
    out = _dot(context, w["wo"]) + w["bo"]
    return F.layer_norm(x + out, (hd,), w["ln_scale"], w["ln_bias"], eps)


def fused_encoder_self_attention(
    x, w: Dict[str, torch.Tensor], key_bias, scale: float, h: int, eps: float
):
    """x (b, S, hd) float32; key_bias (b, S) float32 additive (0 / MASK_VALUE);
    w holds wqkv (hd, 3hd), bqkv, wo (hd, hd), bo, ln_scale, ln_bias, matrices
    pre-cast to bf16 on the card.  Returns (b, S, hd) float32."""
    if not _cuda.uses_kernel(x, key_bias, *w.values()):
        return fused_encoder_self_attention_plain(x, w, key_bias, scale, h, eps)
    if x.ndim != 3:
        raise ValueError(f"x: expected (b, S, hd), got {tuple(x.shape)}")
    b, s, hd = x.shape
    _cuda.require_width(hd, "fused_encoder_self_attention")
    _cuda.require_attention_shape(s, hd, h, "fused_encoder_self_attention")
    _cuda.require(x, "x", torch.float32, (b, s, hd))
    _cuda.require(key_bias, "key_bias", torch.float32, (b, s))
    _cuda.require(w["wqkv"], "wqkv", torch.bfloat16, (hd, 3 * hd))
    _cuda.require(w["bqkv"], "bqkv", torch.float32, (3 * hd,))
    _cuda.require(w["wo"], "wo", torch.bfloat16, (hd, hd))
    for name in ("bo", "ln_scale", "ln_bias"):
        _cuda.require(w[name], name, torch.float32, (hd,))
    if b > 65535:
        raise ValueError(f"fused_encoder_self_attention: {b} samples, at most 65535")
    y = _encoder_attention_launch(x, w, key_bias, scale, h, eps)
    _cuda.count("fused_encoder_self_attention", b * s)
    return y


def encoder_attention_plans(rows: int, hd: int) -> Tuple[_cuda.GemmPlan, _cuda.GemmPlan]:
    """Kernel F's two products: the q|k|v projection with the bias epilogue,
    the out projection with the residual + LayerNorm one."""
    return _cuda.gemm_plan(rows, 3 * hd, hd, "bias"), _cuda.gemm_plan(rows, hd, hd, "ln")


def _encoder_attention_launch(x, w, key_bias, scale: float, h: int, eps: float, block=None):
    """Kernel F's launch on checked operands, under encoder_attention_plans and
    block B `block` (default: attention_block's; the tests force either)."""
    b, s, hd = x.shape
    rows = b * s
    plans = encoder_attention_plans(rows, hd)
    block = block or attention_block("encoder", s, s, hd // h, hd // h)
    floats = max(plans[0].partial_floats(rows, 3 * hd), plans[1].partial_floats(rows, hd), 1)

    def bf16_rows(width):
        return torch.empty((rows, width), dtype=torch.bfloat16, device=x.device)

    xb, qkv, context = bf16_rows(hd), bf16_rows(3 * hd), bf16_rows(hd)
    partial = torch.empty(floats, dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    p = _cuda.ptr
    _cuda.launch(
        "ovq_encoder_attention_forward", p(x), p(w["wqkv"]), p(w["bqkv"]),
        p(w["wo"]), p(w["bo"]), p(w["ln_scale"]), p(w["ln_bias"]), p(key_bias),
        p(xb), p(qkv), p(context), p(partial), p(y), b, s, hd, h, int(block == "resident"),
        *plans[0], *plans[1], scale, eps,
    )
    return y
