"""Kernel C (the BERT FFN sublayer on rows) and kernel D (one M4C decode token's
self-attention sublayer over [frozen context | decoded slots]), each beside its
plain PyTorch version.

Counterparts of ``fused_ffn_step`` and ``fused_bert_self_step`` in
``openvivqa_tpu/ops/decode_step.py``.  The CUDA sources are ``csrc/ffn.cu`` and
``csrc/bert_self_step.cu``; their notes say what bounds each on the H100.

Numerics, the same in a kernel and its plain version: activations, softmax,
LayerNorm and accumulators are float32; every projection casts its activation
to the weight's dtype (bf16 on the card, where the weights are pre-cast once,
float32 on the CPU) and accumulates in float32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import _cuda

MASK_VALUE = -10e4  # equal to models/modules/masks.py MASK_VALUE
_LN_EPS = 1e-6  # flax nn.LayerNorm default, as in the JAX package


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with a rounded to w's dtype and a float32 result."""
    return a.to(w.dtype).float() @ w.float()


# ---------------------------------------------------------------------------
# kernel C
# ---------------------------------------------------------------------------
def fused_ffn_step_plain(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float = _LN_EPS):
    hidden = F.gelu(_dot(x, w1) + b1)
    out = _dot(hidden, w2) + b2
    return F.layer_norm(x + out, (x.shape[-1],), ln_scale, ln_bias, eps)


def fused_ffn_step(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float = _LN_EPS):
    """LayerNorm(x + GELU(x @ w1 + b1) @ w2 + b2) on (rows, hd) float32 rows.
    On the card w1 (hd, d_ff) and w2 (d_ff, hd) are bf16, the rest float32."""
    if not _cuda.uses_kernel(x, w1, b1, w2, b2, ln_scale, ln_bias):
        return fused_ffn_step_plain(x, w1, b1, w2, b2, ln_scale, ln_bias, eps)
    if x.ndim != 2:
        raise ValueError(f"x: expected (rows, hd), got {tuple(x.shape)}")
    rows, hd = x.shape
    d_ff = w1.shape[-1]
    _cuda.require_width(hd, "fused_ffn_step")
    _cuda.require(x, "x", torch.float32, (rows, hd))
    _cuda.require(w1, "w1", torch.bfloat16, (hd, d_ff))
    _cuda.require(w2, "w2", torch.bfloat16, (d_ff, hd))
    for name, vec, n in (("b1", b1, d_ff), ("b2", b2, hd),
                         ("ln_scale", ln_scale, hd), ("ln_bias", ln_bias, hd)):
        _cuda.require(vec, name, torch.float32, (n,))
    hidden = torch.empty((rows, d_ff), dtype=torch.bfloat16, device=x.device)
    partial, splits, k_per_split = _cuda.row_partials(rows, d_ff, hd, x.device)
    y = torch.empty_like(x)
    p = _cuda.ptr
    _cuda.launch(
        "ovq_ffn_forward", p(x), p(w1), p(b1), p(w2), p(b2), p(ln_scale),
        p(ln_bias), p(hidden), p(partial), p(y), rows, hd, d_ff, splits, k_per_split, eps,
    )
    _cuda.count("fused_ffn_step")
    return y


# ---------------------------------------------------------------------------
# kernel D
# ---------------------------------------------------------------------------
def _slot(step: int, n_slots: int) -> int:
    # a step past the last slot overwrites the last slot, like the JAX
    # package's clamped dynamic_update_slice
    return min(int(step), n_slots - 1)


def fused_bert_self_step_plain(
    x, w: Dict[str, torch.Tensor], ctx_kv, slot_k, slot_v, step: int, ctx_bias,
    scale: float, h: int, eps: float,
):
    bs, hd = x.shape
    d = hd // h
    n_slots = slot_k.shape[1]
    t = _slot(step, n_slots)
    q, k_new, v_new = (_dot(x, w["wqkv"]) + w["bqkv"]).split(hd, dim=-1)
    slot_k[:, t] = k_new.to(slot_k.dtype)
    slot_v[:, t] = v_new.to(slot_v.dtype)
    keys = torch.cat([ctx_kv[0], slot_k], dim=1).float().view(bs, -1, h, d)
    values = torch.cat([ctx_kv[1], slot_v], dim=1).float().view(bs, -1, h, d)
    slot_bias = torch.where(
        torch.arange(n_slots, device=x.device) <= t, 0.0, MASK_VALUE
    ).to(torch.float32)
    bias = torch.cat([ctx_bias, slot_bias.expand(bs, n_slots)], dim=1)
    logits = torch.einsum("bhd,bkhd->bhk", q.view(bs, h, d), keys) * scale
    weights = torch.softmax(logits + bias[:, None, :], dim=-1)
    context = torch.einsum("bhk,bkhd->bhd", weights, values).reshape(bs, hd)
    out = _dot(context, w["wo"]) + w["bo"]
    y = F.layer_norm(x + out, (hd,), w["ln_scale"], w["ln_bias"], eps)
    return y, slot_k, slot_v


def fused_bert_self_step(
    x, w: Dict[str, torch.Tensor], ctx_kv: Tuple[torch.Tensor, torch.Tensor],
    slot_k, slot_v, step: int, ctx_bias, scale: float, h: int, eps: float,
):
    """One decode token's self-attention sublayer: q|k|v projection of x (bs, hd),
    the new k/v written into slot min(step, T-1) of slot_k/slot_v (bs, T, hd) IN
    PLACE, one softmax over [ctx K/V (bs, C, hd), read-only | slots <= that slot],
    out projection, residual and LayerNorm.  ctx_bias (bs, C) float32 carries
    MASK_VALUE on padded context keys.  w holds wqkv (hd, 3hd), bqkv, wo (hd, hd),
    bo, ln_scale, ln_bias.  Returns (y, slot_k, slot_v)."""
    tensors = (x, ctx_kv[0], ctx_kv[1], slot_k, slot_v, ctx_bias, *w.values())
    if not _cuda.uses_kernel(*tensors):
        return fused_bert_self_step_plain(
            x, w, ctx_kv, slot_k, slot_v, step, ctx_bias, scale, h, eps
        )
    if x.ndim != 2 or slot_k.ndim != 3 or ctx_kv[0].ndim != 3:
        raise ValueError("x must be (bs, hd); ctx K/V and slots (bs, rows, hd)")
    bs, hd = x.shape
    ctx_len, n_slots = ctx_kv[0].shape[1], slot_k.shape[1]
    _cuda.require_width(hd, "fused_bert_self_step")
    if hd % h or hd // h > 256:
        raise ValueError(f"head dim {hd}/{h} must be an integer of at most 256")
    _cuda.require(x, "x", torch.float32, (bs, hd))
    _cuda.require(w["wqkv"], "wqkv", torch.bfloat16, (hd, 3 * hd))
    _cuda.require(w["bqkv"], "bqkv", torch.float32, (3 * hd,))
    _cuda.require(w["wo"], "wo", torch.bfloat16, (hd, hd))
    for name in ("bo", "ln_scale", "ln_bias"):
        _cuda.require(w[name], name, torch.float32, (hd,))
    for name, cache in (("ctx_k", ctx_kv[0]), ("ctx_v", ctx_kv[1])):
        _cuda.require(cache, name, torch.bfloat16, (bs, ctx_len, hd))
    for name, cache in (("slot_k", slot_k), ("slot_v", slot_v)):
        _cuda.require(cache, name, torch.bfloat16, (bs, n_slots, hd))
    _cuda.require(ctx_bias, "ctx_bias", torch.float32, (bs, ctx_len))
    qkv = torch.empty((bs, 3 * hd), dtype=torch.float32, device=x.device)
    context = torch.empty((bs, hd), dtype=torch.float32, device=x.device)
    partial, splits, k_per_split = _cuda.row_partials(bs, hd, hd, x.device)
    y = torch.empty_like(x)
    p = _cuda.ptr
    _cuda.launch(
        "ovq_bert_self_step_forward", p(x), p(w["wqkv"]), p(w["bqkv"]),
        p(w["wo"]), p(w["bo"]), p(w["ln_scale"]), p(w["ln_bias"]),
        p(ctx_kv[0]), p(ctx_kv[1]), p(ctx_bias), p(slot_k), p(slot_v),
        p(qkv), p(context), p(partial), p(y), bs, ctx_len, n_slots, _slot(step, n_slots),
        hd, h, splits, k_per_split, scale, eps,
    )
    _cuda.count("fused_bert_self_step")
    return y, slot_k, slot_v
