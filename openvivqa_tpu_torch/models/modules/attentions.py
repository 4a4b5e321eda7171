"""The scaled dot-product attention core and the multi-head wrapper with its
decode-time caches.

Counterpart of ``ScaledDotProductAttention``, ``_DecodeKVCache``,
``_StaticEncKVCache`` and ``MultiHeadAttention`` in
``openvivqa_tpu/models/modules/attentions.py``, with the geometry, memory and
adaptive cores (``AugmentedGeometryScaledDotProductAttention``,
``AugmentedMemoryScaledDotProductAttention``,
``AdaptiveScaledDotProductAttention``) and the AoA gates.  Parameter names are
the reference's (``attention.fc_q`` ... ``attention.fc_o``, ``layer_norm``,
``informative_attention``, ``gated_attention``).  The three extra cores are plain
torch, as the JAX package calls no kernel there; a core takes the extra inputs
it reads (``boxes``, ``language_signals``) by keyword and ignores the others.

The dispatch is the JAX package's (``attentions.py:71-171``) without its
key-count crossover, which the card does not have.  ``ScaledDotProductAttention``
runs on the raw (b, S, h * d) projections through the packed attention kernel
(``ops/fused_attention.fused_attention_packed``, with its autograd function in
training) when d_k == d_v and the bias is shared by the heads, through the
streamed kernel (``fused_attention_packed_streamed``) past the packed kernel's
reach (``packed_attention_viable``: a key-count rule on the card), and through
``attend`` otherwise.  ``attend`` is the flat attention kernel
(``fused_attention``) over head-split views of the packed projections, for
every 4-D bias form (b|1, h|1, Sq|1, Sk) and any d_k, d_v.

Decode (one token per row): the stateful self-attention keeps a ring cache of
projected keys and values (``_DecodeKVCache``), the cross-attention the encoder
projections computed once per generate (``_StaticEncKVCache``).  Each has two
routes, chosen by the caller from ``ops/decode_step.decode_kernel_parts()``: the
stage kernel (A or B; `weights` given), or the module route (projections as
``nn.Linear``, ``attend``'s flat attention on the ring or the encoder cache).
The whole-layer route lives in ``decoders.DecoderLayer``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ...builders import META_ATTENTION, build_attention
from ...ops import _cuda
from ...ops import decode_step as _ds
from ...ops import fused_attention as _attn
from .bert import dropout, vector
from .ffn import LN_EPS, matrix
from .masks import MASK_VALUE, box_relational_embedding


def _bias_4d(attention_bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A (bs, sk) key-padding bias becomes (bs, 1, 1, sk); 4-D passes."""
    if attention_bias is None or attention_bias.ndim == 4:
        return attention_bias
    if attention_bias.ndim == 2:
        return attention_bias[:, None, None, :]
    raise ValueError(
        "attention_bias must be 4-D (bs/1, h/1, sq/1, sk) or 2-D (bs, sk); "
        f"got ndim={attention_bias.ndim}"
    )


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(b, S, h * d) -> the (b, h, S, d) view (no copy for float32 x)."""
    b, s, _ = x.shape
    return x.float().reshape(b, s, heads, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(b, h, S, d) -> (b, S, h * d): a view of the flat kernel's output."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _packed(*projections):
    """The packed kernels' operands: contiguous float32."""
    return (x.float().contiguous() for x in projections)


class _ProjectionMixin:
    """The q/k/v/o projections every attention core shares."""

    def _build_projections(self, config) -> None:
        self.h = config.HEAD
        self.d_k = config.D_KEY
        self.d_v = config.D_VALUE
        self.d_model = config.D_MODEL
        self.scale = 1.0 / math.sqrt(self.d_k)
        self.fc_q = nn.Linear(self.d_model, self.h * self.d_k)
        self.fc_k = nn.Linear(self.d_model, self.h * self.d_k)
        self.fc_v = nn.Linear(self.d_model, self.h * self.d_v)
        self.fc_o = nn.Linear(self.h * self.d_v, self.d_model)

    def attend(self, q, k, v, attention_bias=None) -> torch.Tensor:
        """softmax(q k^T / sqrt(d_k) + bias) v on packed projections q (b, Sq,
        h * d_k), k (b, Sk, h * d_k), v (b, Sk, h * d_v) through the flat
        attention, which reads their head-split views as they are; returns (b,
        Sq, h * d_v) before the out projection."""
        out = _attn.fused_attention(_split_heads(q, self.h), _split_heads(k, self.h),
                                    _split_heads(v, self.h), _bias_4d(attention_bias), self.scale)
        return _merge_heads(out)


@META_ATTENTION.register()
class ScaledDotProductAttention(nn.Module, _ProjectionMixin):
    """softmax(Q K^T / sqrt(d_k) + bias) V with its four projections."""

    def __init__(self, config):
        super().__init__()
        self._build_projections(config)

    def forward(self, queries, keys, values, attention_bias=None, **_) -> torch.Tensor:
        q, k, v = self.fc_q(queries), self.fc_k(keys), self.fc_v(values)
        if self.d_k == self.d_v and (
            attention_bias is None or (attention_bias.ndim == 4 and attention_bias.shape[1] == 1)
        ):
            sq, sk, hd = q.shape[1], k.shape[1], self.h * self.d_k
            if _attn.packed_attention_viable(sq, sk, hd, self.h):
                return self.fc_o(_attn.fused_attention_packed(
                    *_packed(q, k, v), attention_bias, self.scale, self.h))
            if _attn.streamed_attention_viable(sq, sk, hd, self.h):
                return self.fc_o(_attn.fused_attention_packed_streamed(
                    *_packed(q, k, v), attention_bias, self.scale, self.h))
        return self.fc_o(self.attend(q, k, v, attention_bias))


def _plain_attention(q, k, v, scale: float, *biases) -> torch.Tensor:
    """softmax(q k^T * scale + biases) v on (b, h, S, d) heads."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    for bias in biases:
        if bias is not None:
            logits = logits + bias
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)


@META_ATTENTION.register()
class AugmentedGeometryScaledDotProductAttention(nn.Module, _ProjectionMixin):
    """Self-attention whose logits gain a per-head log box-relation bias:
    log(max(relu(fc_g(geometry)), 1e-6)) of the (bs, n, n, d_g) pairwise box
    embedding (d_g = D_MODEL / HEAD with TRIGNOMETRIC_EMBEDDING, else 4)."""

    def __init__(self, config):
        super().__init__()
        self._build_projections(config)
        self.trignometric_embedding = bool(config.TRIGNOMETRIC_EMBEDDING)
        self.d_g = config.D_MODEL // config.HEAD if self.trignometric_embedding else 4
        self.fc_g = nn.Linear(self.d_g, self.h)

    def forward(self, queries, keys, values, attention_bias=None, boxes=None, **_):
        geometry = box_relational_embedding(boxes, dim_g=self.d_g,
                                            trignometric_embedding=self.trignometric_embedding)
        g_bias = torch.log(torch.clamp(torch.relu(self.fc_g(geometry)), min=1e-6))
        out = _plain_attention(
            _split_heads(self.fc_q(queries), self.h), _split_heads(self.fc_k(keys), self.h),
            _split_heads(self.fc_v(values), self.h), self.scale, _bias_4d(attention_bias),
            g_bias.permute(0, 3, 1, 2))
        return self.fc_o(_merge_heads(out))


@META_ATTENTION.register()
class AugmentedMemoryScaledDotProductAttention(nn.Module, _ProjectionMixin):
    """MEMORY learned key and value slots (scaled by sqrt(d_k) and sqrt(m))
    appended to the projected keys and values; the bias covers the real keys
    only."""

    def __init__(self, config):
        super().__init__()
        self._build_projections(config)
        self.m = int(config.MEMORY)
        self.m_k = nn.Parameter(torch.randn(1, self.m, self.h * self.d_k) / self.d_k)
        self.m_v = nn.Parameter(torch.randn(1, self.m, self.h * self.d_v) / self.m)

    def init_weights_(self, generator: torch.Generator) -> None:
        """The projections by the MCAN family's law, then the slots by the JAX
        package's (normal with std 1 / d_k and 1 / m), drawn from `generator`."""
        from ..base import init_xavier_law_

        init_xavier_law_(self, generator)
        with torch.no_grad():
            self.m_k.copy_(torch.randn(self.m_k.shape, generator=generator) / self.d_k)
            self.m_v.copy_(torch.randn(self.m_v.shape, generator=generator) / self.m)

    def forward(self, queries, keys, values, attention_bias=None, **_):
        bs = keys.shape[0]
        m_k = math.sqrt(self.d_k) * self.m_k.expand(bs, self.m, self.h * self.d_k)
        m_v = math.sqrt(self.m) * self.m_v.expand(bs, self.m, self.h * self.d_v)
        k = _split_heads(torch.cat([self.fc_k(keys), m_k], dim=1), self.h)
        v = _split_heads(torch.cat([self.fc_v(values), m_v], dim=1), self.h)
        q = _split_heads(self.fc_q(queries), self.h)
        bias = _bias_4d(attention_bias)
        if bias is not None:
            b, h, sq, sk = q.shape[0], self.h, q.shape[2], keys.shape[1]
            bias = torch.cat([bias.float().expand(b, h, sq, sk),
                              torch.zeros((b, h, sq, self.m), device=bias.device)], dim=-1)
        return self.fc_o(_merge_heads(_plain_attention(q, k, v, self.scale, bias)))


@META_ATTENTION.register()
class AdaptiveScaledDotProductAttention(nn.Module, _ProjectionMixin):
    """Adaptive attention: each query's language signal s_i (``fc_s`` of the
    frozen language model's output) is one more column of its softmax, with
    logit q_i . s_i / sqrt(d_k); out_i = sum_k w_ik v_k + w_i,s s_i."""

    def __init__(self, config):
        super().__init__()
        self._build_projections(config)
        self.fc_s = nn.Linear(self.d_model, self.h * self.d_k)

    def attend_adaptive(self, q, k, v, signals, bias) -> torch.Tensor:
        """The core on (b, Sq, h * d) q and signals and (b, Sk, h * d) k, v
        projections; returns (b, Sq, h * d_v) before the out projection."""
        q, k, v = (_split_heads(x, self.h) for x in (q, k, v))
        s = _split_heads(self.fc_s(signals), self.h)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * self.scale
        if bias is not None:
            logits = logits + bias
        lang = (q * s).sum(dim=-1, keepdim=True) * self.scale
        combined = torch.softmax(torch.cat([logits, lang], dim=-1), dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", combined[..., :-1], v) + combined[..., -1:] * s
        return _merge_heads(out)

    def forward(self, queries, keys, values, attention_bias=None, language_signals=None, **_):
        return self.fc_o(self.attend_adaptive(
            self.fc_q(queries), self.fc_k(keys), self.fc_v(values), language_signals,
            _bias_4d(attention_bias)))


class _DecodeKVCache:
    """The stateful self-attention's ring: packed (rows, T, h * d) float32 keys
    and values and the (rows, T) float32 padding bias of the tokens written so
    far.  Slot min(t, T - 1) is written at step t (a step past the end
    overwrites the last slot, as the JAX package's clamped update does).  Beam
    search reorders the three tensors between steps."""

    def __init__(self, rows: int, max_len: int, k_width: int, v_width: int, device):
        self.key = torch.zeros((rows, max_len, k_width), dtype=torch.float32, device=device)
        self.value = torch.zeros((rows, max_len, v_width), dtype=torch.float32, device=device)
        self.bias = torch.zeros((rows, max_len), dtype=torch.float32, device=device)

    def append(self, k_new, v_new, step_bias, t: int):
        """Write one token's (rows, 1, width) projections and (rows,) bias in
        place; returns the ring and its (rows, 1, 1, T) bias with the slots
        past t masked."""
        max_len = self.key.shape[1]
        slot = min(int(t), max_len - 1)
        self.key[:, slot] = k_new[:, 0]
        self.value[:, slot] = v_new[:, 0]
        self.bias[:, slot] = step_bias
        future = torch.where(
            torch.arange(max_len, device=self.key.device) > slot, MASK_VALUE, 0.0
        ).to(torch.float32)
        return self.key, self.value, (self.bias + future)[:, None, None, :]


class _StaticEncKVCache:
    """The cross-attention's encoder projections, (rows, Sk, h * d) each,
    computed once per generate (the encoder stream is constant across decode
    steps and identical across a sample's beams, so beam search never reorders
    it)."""

    def __init__(self, key: torch.Tensor, value: torch.Tensor):
        self.key = key
        self.value = value


class MultiHeadAttention(nn.Module):
    """Attention core, dropout on its output, residual and post-LayerNorm, with
    the decode-time caches."""

    def __init__(self, config):
        super().__init__()
        self.use_aoa = bool(config.USE_AOA)
        if self.use_aoa:
            self.informative_attention = nn.Linear(2 * config.D_MODEL, config.D_MODEL)
            self.gated_attention = nn.Linear(2 * config.D_MODEL, config.D_MODEL)
        self.attention = build_attention(config)
        self.dropout = config.DROPOUT
        self.layer_norm = nn.LayerNorm(config.D_MODEL, eps=LN_EPS)
        self.can_be_stateful = bool(config.CAN_BE_STATEFUL)

    def _aoa(self, queries, out):
        """The attention-on-attention gates over [queries | out], when on."""
        if not self.use_aoa:
            return out
        both = torch.cat([queries, out], dim=-1)
        return self.informative_attention(both) * torch.sigmoid(self.gated_attention(both))

    def forward(self, queries, keys, values, attention_bias=None,
                generator: Optional[torch.Generator] = None, **extras) -> torch.Tensor:
        """`extras` (``boxes``, ``language_signals``) go to the core."""
        out = self.attention(queries, keys, values, attention_bias, **extras)
        out = dropout(out, self.dropout, generator)
        return self._aoa(queries, self.layer_norm(queries + out))

    # -- decode ------------------------------------------------------------------
    def supports_fused_decode(self) -> bool:
        """Whether kernels A / B and the layer step compute this module: no
        AoA gates, a scaled dot-product core whose heads tile the model width,
        d_k == d_v and h * d_k == d_model."""
        core = self.attention
        return (
            not self.use_aoa
            and type(core) is ScaledDotProductAttention
            and core.d_k == core.d_v
            and core.h * core.d_k == core.d_model
        )

    @torch.no_grad()
    def fused_weights(self, dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
        """The decode kernels' operands, matrices as (in, out) in `dtype` (bf16
        on the card unless told otherwise), vectors float32: with q|k|v packed
        into one (d_model, 3 h d) matrix for the stateful self-attention
        (kernel A), with the q projection alone for the cross-attention (kernel
        B, whose keys and values are cached)."""
        core = self.attention
        dtype = dtype or _cuda.kernel_dtype(core.fc_q.weight.device)
        out = {
            "wo": matrix(core.fc_o, dtype), "bo": vector(core.fc_o.bias),
            "ln_scale": vector(self.layer_norm.weight),
            "ln_bias": vector(self.layer_norm.bias),
        }
        if self.can_be_stateful:
            projections = (core.fc_q, core.fc_k, core.fc_v)
            out["wqkv"] = torch.cat([matrix(p, dtype) for p in projections], dim=1)
            out["bqkv"] = torch.cat([vector(p.bias) for p in projections])
        else:
            out["wq"] = matrix(core.fc_q, dtype)
            out["bq"] = vector(core.fc_q.bias)
        return out

    def _require_cached_core(self) -> None:
        """Decode caches projected keys and values: the geometry and memory
        cores (encoder cores) have no decode route, as in the JAX package."""
        if type(self.attention) not in (ScaledDotProductAttention,
                                        AdaptiveScaledDotProductAttention):
            raise NotImplementedError(
                f"decode needs a ScaledDotProduct or Adaptive core, not "
                f"{type(self.attention).__name__}")

    def init_decode_cache(self, rows: int, max_len: int, device) -> _DecodeKVCache:
        self._require_cached_core()
        core = self.attention
        return _DecodeKVCache(rows, max_len, core.h * core.d_k, core.h * core.d_v, device)

    def fill_enc_cache(self, keys, values, dtype: torch.dtype = torch.float32) -> _StaticEncKVCache:
        """Project the constant encoder stream once, stored in `dtype`."""
        self._require_cached_core()
        core = self.attention
        return _StaticEncKVCache(
            core.fc_k(keys).to(dtype).contiguous(), core.fc_v(values).to(dtype).contiguous()
        )

    def decode_step(self, queries, cache: _DecodeKVCache, step_bias, t: int,
                    weights: Optional[Dict[str, torch.Tensor]] = None,
                    language_signals=None) -> torch.Tensor:
        """One token (rows, 1, d_model) through the stateful self-attention:
        its key and value join the ring at slot min(t, T - 1) with the token's
        padding bias step_bias (rows,), and it attends over the slots up to
        there.  With `weights` (``fused_weights()``) the whole sublayer is kernel
        A; without, the module route (the flat attention on the ring; for the
        adaptive core its plain attention with the token's language signal)."""
        if weights is not None:
            y, _, _, _ = _ds.fused_self_attention_step(
                queries[:, 0].float().contiguous(), weights, step_bias, t,
                cache.key, cache.value, cache.bias, self.attention.scale, self.attention.h,
                LN_EPS,
            )
            return y[:, None, :]
        core = self.attention
        keys, values, bias = cache.append(core.fc_k(queries), core.fc_v(queries), step_bias, t)
        if isinstance(core, AdaptiveScaledDotProductAttention):
            out = core.fc_o(core.attend_adaptive(core.fc_q(queries), keys, values,
                                                 language_signals, bias))
        else:
            out = core.fc_o(core.attend(core.fc_q(queries), keys, values, bias))
        return self._aoa(queries, self.layer_norm(queries + out))

    def cross_decode_step(self, queries, enc_cache: _StaticEncKVCache, enc_bias,
                          weights: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """One token (rows, 1, d_model) against the cached encoder projections
        under enc_bias (rows, Sk): kernel B with `weights`, else the
        module route."""
        if weights is not None:
            y = _ds.fused_cross_attention_step(
                queries[:, 0].float().contiguous(), weights, enc_cache.key, enc_cache.value,
                enc_bias, self.attention.scale, self.attention.h, LN_EPS,
            )
            return y[:, None, :]
        core = self.attention
        out = core.fc_o(core.attend(
            core.fc_q(queries), enc_cache.key, enc_cache.value, enc_bias[:, None, None, :]
        ))
        return self._aoa(queries, self.layer_norm(queries + out))


def key_bias_rows(attention_bias: Optional[torch.Tensor], rows: int, keys: int,
                  device) -> torch.Tensor:
    """A (bs/1, 1, 1, Sk) key-padding bias, or None, as the contiguous (rows, Sk)
    float32 tensor the decode kernels read."""
    if attention_bias is None:
        return torch.zeros((rows, keys), dtype=torch.float32, device=device)
    return attention_bias[:, 0, 0, :].expand(rows, keys).float().contiguous()

