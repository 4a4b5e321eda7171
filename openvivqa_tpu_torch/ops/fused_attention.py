"""Packed attention, softmax(scale * Q K^T + bias) V on the raw (b, S, h * d)
projections, with and without in-kernel dropout on the attention weights, and
with a second, per-head bias, each beside its plain PyTorch version.

Counterparts of ``fused_attention_packed``, ``fused_attention_packed_dropout``
and ``fused_attention_packed_2bias`` in ``openvivqa_tpu/ops/fused_attention.py``;
the CUDA sources are ``csrc/fused_attention.cu``, ``csrc/fused_attention_dropout.cu``
and ``csrc/fused_attention_2bias.cu``.  The bias is
head-shared, ``(bb, 1, bq, Sk)`` with ``bb`` in {1, b} and ``bq`` in {1, Sq}, and
is never broadcast in memory.  It is a mask constant: neither gradient flows to
it (the JAX package returns zeros for it under dropout and never uses the
packed one's).

Dot operands and softmax weights are rounded to ``op_dtype`` (bf16 on the card,
as in the TPU kernels; float32 on the CPU unless asked otherwise); the softmax
and accumulators are float32.

The two-bias attention is forward only on the card: the backbones that call it
(T5, DeBERTa) run frozen, under ``torch.no_grad()``.

Gradients:
  * ``fused_attention_packed``: the analytic formula of the JAX package's
    ``_packed_bwd`` in plain PyTorch, in float32, as XLA computes it there;
  * ``fused_attention_packed_dropout``: a CUDA kernel pair on the card, the
    plain version of the TPU backward kernel on the CPU.  The mask is
    regenerated, never stored: Philox4x32-10 keyed by the per-call seed,
    counted by (key column // 4, query row, head, sample), word key column % 4
    (``philox4x32_10``, the same function as ``csrc/common.cuh``'s).  Kernel and
    plain version draw identical masks.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


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


def _heads(x, num_heads: int, op_dtype):
    b, s, hd = x.shape
    return x.to(op_dtype).float().reshape(b, s, num_heads, hd // num_heads)


def _softmax_weights(qh, kh, bias, scale: float):
    """(b, h, Sq, Sk) float32 softmax of the head-split operands."""
    b, sq = qh.shape[:2]
    sk = kh.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    logits = logits + _bias_3d(bias, b, sq, sk, qh.device)[:, None]
    return torch.softmax(logits, dim=-1)


def fused_attention_packed_plain(
    q, k, v, bias, scale: float, num_heads: int, op_dtype: Optional[torch.dtype] = None
):
    op_dtype = op_dtype or _cuda.kernel_dtype(q.device)
    b, sq, hd = q.shape
    weights = _softmax_weights(_heads(q, num_heads, op_dtype), _heads(k, num_heads, op_dtype),
                               bias, scale).to(op_dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", weights, _heads(v, num_heads, op_dtype))
    return out.reshape(b, sq, hd)


def fused_attention_packed_backward_plain(q, k, v, bias, g, scale: float, num_heads: int):
    """(dq, dk, dv) of the packed attention: ``_packed_bwd``'s analytic
    formula, in float32 (no operand rounding, as XLA computes it)."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    f32 = torch.float32
    qh, kh, vh, gh = (_heads(x, num_heads, f32) for x in (q, k, v, g))
    weights = _softmax_weights(qh, kh, bias, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", weights, gh)
    dw = torch.einsum("bqhd,bkhd->bhqk", gh, vh)
    dlogits = weights * (dw - (dw * weights).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", dlogits, kh) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dlogits, qh) * scale
    return dq.reshape(b, sq, hd), dk.reshape(b, sk, hd), dv.reshape(b, sk, hd)


def _check_packed(q, k, v, num_heads: int, what: str):
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"{what}: q must be (b, Sq, hd) and k, v (b, Sk, hd)")
    b, sq, hd = q.shape
    sk = k.shape[1]
    _cuda.require_attention_shape(sk, hd, num_heads, what)
    _cuda.require(q, "q", torch.float32, (b, sq, hd))
    _cuda.require(k, "k", torch.float32, (b, sk, hd))
    _cuda.require(v, "v", torch.float32, (b, sk, hd))
    return b, sq, sk, hd


def _bias_strides(bias3):
    bb, bq, sk = bias3.shape
    return 0 if bb == 1 else bq * sk, 0 if bq == 1 else sk


def _packed_kernel(q, k, v, bias, scale: float, num_heads: int):
    b, sq, sk, hd = _check_packed(q, k, v, num_heads, "fused_attention_packed")
    bias3 = _bias_3d(bias, b, sq, sk, q.device).contiguous()
    out = torch.empty_like(q)
    p = _cuda.ptr
    _cuda.launch(
        "ovq_packed_attention_forward", p(q), p(k), p(v), p(bias3), *_bias_strides(bias3),
        p(out), b, sq, sk, hd, num_heads, scale,
    )
    _cuda.count("fused_attention_packed")
    return out


class PackedAttention(torch.autograd.Function):
    """The packed attention with the analytic backward in plain PyTorch."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale: float, num_heads: int, use_kernel: bool):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale, ctx.num_heads = scale, num_heads
        if use_kernel:
            return _packed_kernel(q, k, v, bias, scale, num_heads)
        return fused_attention_packed_plain(q, k, v, bias, scale, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = fused_attention_packed_backward_plain(
            q, k, v, bias, g, ctx.scale, ctx.num_heads
        )
        return dq, dk, dv, None, None, None, None


def fused_attention_packed(q, k, v, bias, scale: float, num_heads: int):
    """q (b, Sq, h*d), k/v (b, Sk, h*d) float32; bias (bb, 1, bq, Sk) or None.
    Returns (b, Sq, h*d) float32, the layout the out projection consumes."""
    tensors = (q, k, v) if bias is None else (q, k, v, bias)
    return PackedAttention.apply(q, k, v, bias, scale, num_heads, _cuda.uses_kernel(*tensors))


# -- dropout on the attention weights ----------------------------------------------
def dropout_threshold(rate: float) -> int:
    """Drop an element when (bits >> 9) < threshold (``_dropout_threshold``)."""
    return min(int(rate * (1 << 23)), (1 << 23) - 1)


def _mulhilo(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of a * m for int64 tensors a in [0, 2^32), in
    16-bit halves so that no int64 product overflows."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    a_hi, a_lo = a >> 16, a & 0xFFFF
    mid = a_hi * m_lo + a_lo * m_hi
    low = a_lo * m_lo + ((mid & 0xFFFF) << 16)
    high = a_hi * m_hi + (mid >> 16) + (low >> 32)
    return high & _MASK32, low & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit words (broadcasting):
    the four output words of counter (c0, c1, c2, c3) under key (k0, k1)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def dropout_factors(seed: torch.Tensor, b: int, heads: int, sq: int, sk: int, rate: float):
    """(b, heads, Sq, Sk) float32: 1 / (1 - rate) where the Philox mask keeps
    the weight, 0 where it drops it."""
    device = seed.device

    def axis(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)

    seed = seed.reshape(1, 1, 1, 1).to(torch.int64)
    words = philox4x32_10(
        axis(-(-sk // 4), 3), axis(sq, 2), axis(heads, 1), axis(b, 0),
        seed & _MASK32, (seed >> 32) & _MASK32,
    )
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(b, heads, sq, -1)[..., :sk]
    keep = (bits >> 9) >= dropout_threshold(rate)
    return torch.where(keep, torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=device),
                       torch.tensor(0.0, dtype=torch.float32, device=device))


def fused_attention_packed_dropout_plain(
    q, k, v, bias, seed, scale: float, num_heads: int, rate: float,
    op_dtype: Optional[torch.dtype] = None,
):
    """out = bf16(keep * softmax / (1 - rate)) V per head, the mask from
    ``dropout_factors(seed, ...)``; seed is a (1,) int64 tensor."""
    op_dtype = op_dtype or _cuda.kernel_dtype(q.device)
    b, sq, hd = q.shape
    weights = _softmax_weights(_heads(q, num_heads, op_dtype), _heads(k, num_heads, op_dtype),
                               bias, scale)
    factors = dropout_factors(seed, b, num_heads, sq, k.shape[1], rate)
    dropped = (weights * factors).to(op_dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", dropped, _heads(v, num_heads, op_dtype))
    return out.reshape(b, sq, hd)


def fused_attention_packed_dropout_backward_plain(
    q, k, v, bias, seed, g, scale: float, num_heads: int, rate: float,
    op_dtype: Optional[torch.dtype] = None,
):
    """(dq, dk, dv) float32 with the forward's mask regenerated: the TPU
    backward kernel's arithmetic (``_packed_dropout_bwd_kernel``)."""
    op_dtype = op_dtype or _cuda.kernel_dtype(q.device)
    b, sq, hd = q.shape
    sk = k.shape[1]
    qh, kh, vh, gh = (_heads(x, num_heads, op_dtype) for x in (q, k, v, g))
    weights = _softmax_weights(qh, kh, bias, scale)
    factors = dropout_factors(seed, b, num_heads, sq, sk, rate)
    dropped = (weights * factors).to(op_dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", dropped, gh)
    dw = torch.einsum("bqhd,bkhd->bhqk", gh, vh) * factors
    dlogits = (weights * (dw - (dw * weights).sum(dim=-1, keepdim=True))).to(op_dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dlogits, kh) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dlogits, qh) * scale
    return dq.reshape(b, sq, hd), dk.reshape(b, sk, hd), dv.reshape(b, sk, hd)


def _check_seed(seed):
    _cuda.require(seed, "seed", torch.int64, (1,))


def _dropout_forward_kernel(q, k, v, bias, seed, scale: float, num_heads: int, rate: float):
    """out and the rows' softmax (max, denominator) as (b, h, Sq, 2)."""
    b, sq, sk, hd = _check_packed(q, k, v, num_heads, "fused_attention_packed_dropout")
    _check_seed(seed)
    bias3 = _bias_3d(bias, b, sq, sk, q.device).contiguous()
    out = torch.empty_like(q)
    stats = torch.empty((b, num_heads, sq, 2), dtype=torch.float32, device=q.device)
    p = _cuda.ptr
    _cuda.launch(
        "ovq_packed_dropout_forward", p(q), p(k), p(v), p(bias3), *_bias_strides(bias3),
        p(seed), dropout_threshold(rate), 1.0 / (1.0 - rate), p(stats), p(out),
        b, sq, sk, hd, num_heads, scale,
    )
    _cuda.count("fused_attention_packed_dropout")
    return out, stats


def _dropout_backward_kernel(q, k, v, bias, seed, stats, g, scale: float, num_heads: int,
                             rate: float):
    b, sq, sk, hd = _check_packed(q, k, v, num_heads, "fused_attention_packed_dropout backward")
    _check_seed(seed)
    _cuda.require(g, "g", torch.float32, (b, sq, hd))
    _cuda.require(stats, "stats", torch.float32, (b, num_heads, sq, 2))
    bias3 = _bias_3d(bias, b, sq, sk, q.device).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, num_heads, sq), dtype=torch.float32, device=q.device)
    p = _cuda.ptr
    _cuda.launch(
        "ovq_packed_dropout_backward", p(q), p(k), p(v), p(g), p(bias3), *_bias_strides(bias3),
        p(seed), dropout_threshold(rate), 1.0 / (1.0 - rate), p(stats), p(delta),
        p(dq), p(dk), p(dv), b, sq, sk, hd, num_heads, scale,
    )
    _cuda.count("fused_attention_packed_dropout_backward")
    return dq, dk, dv


class PackedDropoutAttention(torch.autograd.Function):
    """The dropout attention: both directions through the kernels when
    `use_kernel`, else through the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale: float, num_heads: int, rate: float,
                use_kernel: bool):
        stats = None
        if use_kernel:
            out, stats = _dropout_forward_kernel(q, k, v, bias, seed, scale, num_heads, rate)
        else:
            out = fused_attention_packed_dropout_plain(q, k, v, bias, seed, scale, num_heads, rate)
        ctx.save_for_backward(q, k, v, bias, seed, stats)
        ctx.args = (scale, num_heads, rate, use_kernel)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, seed, stats = ctx.saved_tensors
        scale, num_heads, rate, use_kernel = ctx.args
        g = g.float().contiguous()
        if use_kernel:
            grads = _dropout_backward_kernel(q, k, v, bias, seed, stats, g, scale, num_heads, rate)
        else:
            grads = fused_attention_packed_dropout_backward_plain(
                q, k, v, bias, seed, g, scale, num_heads, rate
            )
        return (*grads, None, None, None, None, None, None)


def fused_attention_packed_dropout(q, k, v, bias, seed, scale: float, num_heads: int,
                                   rate: float):
    """Packed attention with dropout on the attention weights, rate in [0, 1);
    seed a (1,) int64 tensor on q's device (one draw per call)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    tensors = (q, k, v, seed) if bias is None else (q, k, v, seed, bias)
    return PackedDropoutAttention.apply(
        q, k, v, bias, seed, scale, num_heads, rate, _cuda.uses_kernel(*tensors)
    )


# -- a second, per-head bias (T5 relative positions, DeBERTa) ------------------------
def _check_2bias_shapes(q, k, v, bias, head_bias, num_heads: int) -> None:
    """Raise ValueError unless q is (b, Sq, h * d), k and v (b, Sk, h * d), bias
    broadcasts as a head-shared (bb, 1, bq, Sk) and head_bias is a float32
    (hb, h, Sq, Sk) with hb in {1, b}."""
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError("fused_attention_packed_2bias: q must be (b, Sq, hd) and k, v (b, Sk, hd)")
    b, sq, hd = q.shape
    sk = k.shape[1]
    if num_heads <= 0 or hd % num_heads:
        raise ValueError(f"fused_attention_packed_2bias: {num_heads} heads do not tile width {hd}")
    _bias_3d(bias, b, sq, sk, q.device)
    if head_bias.ndim != 4 or head_bias.shape[0] not in (1, b) \
            or tuple(head_bias.shape[1:]) != (num_heads, sq, sk):
        raise ValueError(
            f"fused_attention_packed_2bias: head_bias {tuple(head_bias.shape)} is not "
            f"(1 or {b}, {num_heads}, {sq}, {sk})"
        )
    if head_bias.dtype != torch.float32:
        raise ValueError(f"fused_attention_packed_2bias: head_bias must be float32, "
                         f"got {head_bias.dtype}")


def fused_attention_packed_2bias_plain(
    q, k, v, bias, head_bias, scale: float, num_heads: int,
    op_dtype: Optional[torch.dtype] = None,
):
    """The TPU kernel's arithmetic: logits (scale * q k^T + bias) + head_bias in
    float32 on op_dtype-rounded operands, the softmax weights rounded to
    op_dtype before the product with V."""
    op_dtype = op_dtype or _cuda.kernel_dtype(q.device)
    b, sq, hd = q.shape
    sk = k.shape[1]
    qh, kh, vh = (_heads(x, num_heads, op_dtype) for x in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    logits = logits + _bias_3d(bias, b, sq, sk, q.device)[:, None] + head_bias.float()
    weights = torch.softmax(logits, dim=-1).to(op_dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", weights, vh).reshape(b, sq, hd)


def _packed_2bias_kernel(q, k, v, bias, head_bias, scale: float, num_heads: int):
    b, sq, sk, hd = _check_packed(q, k, v, num_heads, "fused_attention_packed_2bias")
    hb = head_bias.shape[0]
    _cuda.require(head_bias, "head_bias", torch.float32, (hb, num_heads, sq, sk))
    bias3 = _bias_3d(bias, b, sq, sk, q.device).contiguous()
    out = torch.empty_like(q)
    p = _cuda.ptr
    _cuda.launch(
        "ovq_packed_2bias_attention_forward", p(q), p(k), p(v), p(bias3), *_bias_strides(bias3),
        p(head_bias), 0 if hb == 1 else num_heads * sq * sk, p(out), b, sq, sk, hd, num_heads,
        scale,
    )
    _cuda.count("fused_attention_packed_2bias")
    return out


def fused_attention_packed_2bias(q, k, v, bias, head_bias, scale: float, num_heads: int):
    """softmax(scale * Q K^T + bias + head_bias) V on packed projections: q (b,
    Sq, h*d), k/v (b, Sk, h*d) float32; bias head-shared (bb, 1, bq, Sk) or None;
    head_bias (hb, h, Sq, Sk) float32 with hb in {1, b} (T5's relative-position
    table shared by the batch, or per-sample terms).  Returns (b, Sq, h*d).

    On the card it launches the kernel, forward only: it raises when a gradient
    would be needed.  On the CPU the plain version runs, with autograd."""
    _check_2bias_shapes(q, k, v, bias, head_bias, num_heads)
    tensors = (q, k, v, head_bias) if bias is None else (q, k, v, head_bias, bias)
    if not _cuda.uses_kernel(*tensors):
        return fused_attention_packed_2bias_plain(q, k, v, bias, head_bias, scale, num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            "fused_attention_packed_2bias has no backward kernel: call it on frozen "
            "inputs or under torch.no_grad()"
        )
    return _packed_2bias_kernel(q, k, v, bias, head_bias, scale, num_heads)
