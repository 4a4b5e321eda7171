"""Packed attention, softmax(scale * Q K^T + bias) V on the raw (b, S, h * d)
projections, forward only, beside its plain PyTorch version.

Counterpart of ``fused_attention_packed`` in ``openvivqa_tpu/ops/fused_attention.py``
(its custom VJP arrives with the training slice); the CUDA source is
``csrc/fused_attention.cu``.  The bias is head-shared, ``(bb, 1, bq, Sk)`` with
``bb`` in {1, b} and ``bq`` in {1, Sq}, and is never broadcast in memory.

Dot operands and softmax weights are rounded to ``op_dtype`` (bf16 on the card,
as in the TPU kernel; float32 on the CPU unless asked otherwise); the softmax
and accumulators are float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda


def _bias_3d(bias: Optional[torch.Tensor], b: int, sq: int, sk: int, device):
    """(bb, 1, bq, Sk) additive bias -> (bb, bq, Sk) float32, validated."""
    if bias is None:
        return torch.zeros((1, 1, sk), dtype=torch.float32, device=device)
    if bias.ndim != 4 or bias.shape[1] != 1:
        raise ValueError(f"packed attention needs a (b, 1, q, k) bias, got {tuple(bias.shape)}")
    bb, _, bq, bk = bias.shape
    if bb not in (1, b) or bq not in (1, sq) or bk != sk:
        raise ValueError(
            f"bias {tuple(bias.shape)} does not broadcast to ({b}, 1, {sq}, {sk}) "
            "with its batch and query dims each 1 or full"
        )
    return bias[:, 0].to(torch.float32)


def fused_attention_packed_plain(
    q, k, v, bias, scale: float, num_heads: int, op_dtype: Optional[torch.dtype] = None
):
    op_dtype = op_dtype or _cuda.kernel_dtype(q.device)
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // num_heads

    def heads(x, s):
        return x.to(op_dtype).float().reshape(b, s, num_heads, d)

    logits = torch.einsum("bqhd,bkhd->bhqk", heads(q, sq), heads(k, sk)) * scale
    logits = logits + _bias_3d(bias, b, sq, sk, q.device)[:, None]
    weights = torch.softmax(logits, dim=-1).to(op_dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", weights, heads(v, sk))
    return out.reshape(b, sq, hd)


def fused_attention_packed(q, k, v, bias, scale: float, num_heads: int):
    """q (b, Sq, h*d), k/v (b, Sk, h*d) float32; bias (bb, 1, bq, Sk) or None.
    Returns (b, Sq, h*d) float32, the layout the out projection consumes."""
    tensors = (q, k, v) if bias is None else (q, k, v, bias)
    if not _cuda.uses_kernel(*tensors):
        return fused_attention_packed_plain(q, k, v, bias, scale, num_heads)
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError("q must be (b, Sq, hd) and k, v (b, Sk, hd)")
    b, sq, hd = q.shape
    sk = k.shape[1]
    _cuda.require_attention_shape(sk, hd, num_heads, "fused_attention_packed")
    _cuda.require(q, "q", torch.float32, (b, sq, hd))
    _cuda.require(k, "k", torch.float32, (b, sk, hd))
    _cuda.require(v, "v", torch.float32, (b, sk, hd))
    bias3 = _bias_3d(bias, b, sq, sk, q.device).contiguous()
    bb, bq, _ = bias3.shape
    out = torch.empty_like(q)
    p = _cuda.ptr
    _cuda.launch(
        "ovq_packed_attention_forward", p(q), p(k), p(v), p(bias3),
        0 if bb == 1 else bq * sk, 0 if bq == 1 else sk, p(out),
        b, sq, sk, hd, num_heads, scale,
    )
    _cuda.count("fused_attention_packed")
    return out
