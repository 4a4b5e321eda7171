"""The T5 / mT5 encoder stack, under Hugging Face's parameter names.

Counterpart of ``openvivqa_tpu/models/modules/t5.py`` (HF's
``T5Stack(is_decoder=False)`` semantics): RMS LayerNorm (no mean, no bias,
variance in float32, eps 1e-6); pre-LN blocks with additive residuals;
attention without a 1/sqrt(d) scale (T5 folds it into its initialisation) and
bias-free projections whose inner width h * d_kv may differ from d_model
(mT5-small: 6 x 64 = 384 against 512); one bucketed relative-position table
(32 buckets, max distance 128) in the first block, shared by every block; a
gated ``gelu_new`` (tanh GELU) FFN for mT5 and T5 v1.1, a ReLU one for T5 v1.0;
a final RMS LayerNorm.

Parameter names are HF ``T5EncoderModel``'s (``shared``,
``encoder.block.N.layer.0.SelfAttention.q``, ...,
``encoder.block.0.layer.0.SelfAttention.relative_attention_bias``,
``encoder.block.N.layer.1.DenseReluDense.wi_0``, ``encoder.final_layer_norm``),
``encoder.embed_tokens`` being ``shared`` itself, so a local HF checkpoint loads
with ``load_state_dict`` and ``hf_conversion.convert_t5_encoder_weights`` reads
the state dict.

Every self-attention takes ``ops/fused_attention.fused_attention_packed_2bias``
on the packed projections: the (b, 1, 1, L) padding bias as its head-shared
operand and the (1, h, L, L) position table as its per-head one (the JAX package
adds them into a (b, h, L, L) tensor first).  The stack runs frozen and in eval,
so it has no dropout.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import fused_attention as _attn

T5_EPS = 1e-6


class T5LayerNorm(nn.Module):
    """RMS norm: a scale and no bias, the variance in float32."""

    def __init__(self, d_model: int, eps: float = T5_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d_model))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        variance = x.float().pow(2).mean(dim=-1, keepdim=True)
        return self.weight * (x * torch.rsqrt(variance + self.eps).to(x.dtype))


def relative_position_bucket(relative_position: np.ndarray, bidirectional: bool = True,
                             num_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """Mesh-TF's bucket of each relative position (HF modeling_t5.py), on the
    host: sequence lengths are static, so the (L, L) table is a constant."""
    relative_buckets = np.zeros_like(relative_position)
    if bidirectional:
        num_buckets //= 2
        relative_buckets += (relative_position > 0).astype(np.int64) * num_buckets
        relative_position = np.abs(relative_position)
    else:
        relative_position = -np.minimum(relative_position, 0)
    max_exact = num_buckets // 2
    is_small = relative_position < max_exact
    large = max_exact + (
        np.log(np.maximum(relative_position, 1).astype(np.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    relative_buckets += np.where(is_small, relative_position, large)
    return relative_buckets


def encoder_bucket_table(seq_len: int, num_buckets: int = 32,
                         max_distance: int = 128) -> np.ndarray:
    """(L, L) int64 bucket ids of a bidirectional encoder."""
    context = np.arange(seq_len, dtype=np.int64)[:, None]
    memory = np.arange(seq_len, dtype=np.int64)[None, :]
    return relative_position_bucket(memory - context, bidirectional=True,
                                    num_buckets=num_buckets, max_distance=max_distance)


class T5Attention(nn.Module):
    """Self-attention: unscaled Q K^T + padding bias + position table, no
    projection biases; the first block's holds the relative-position table."""

    def __init__(self, d_model: int, num_heads: int, d_kv: int,
                 has_relative_attention_bias: bool = False, num_buckets: int = 32):
        super().__init__()
        self.num_heads = num_heads
        inner = num_heads * d_kv
        self.q = nn.Linear(d_model, inner, bias=False)
        self.k = nn.Linear(d_model, inner, bias=False)
        self.v = nn.Linear(d_model, inner, bias=False)
        self.o = nn.Linear(inner, d_model, bias=False)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(num_buckets, num_heads)

    def forward(self, hidden_states, attention_bias: Optional[torch.Tensor],
                position_bias: torch.Tensor) -> torch.Tensor:
        """attention_bias (b, 1, 1, L) or None, position_bias (1, h, L, L)."""
        context = _attn.fused_attention_packed_2bias(
            self.q(hidden_states), self.k(hidden_states), self.v(hidden_states),
            attention_bias, position_bias, 1.0, self.num_heads,
        )
        return self.o(context)


class T5FF(nn.Module):
    """Feed-forward, HF's ``DenseReluDense``: gated (act(wi_0 x) * wi_1 x) or
    plain (act(wi x)), then wo.  ``gelu_new`` is the tanh GELU, ``gelu`` the
    exact one."""

    def __init__(self, d_model: int, d_ff: int, gated_act: bool = True,
                 act_fn: str = "gelu_new"):
        super().__init__()
        self.gated_act = gated_act
        self.act_fn = act_fn
        if gated_act:
            self.wi_0 = nn.Linear(d_model, d_ff, bias=False)
            self.wi_1 = nn.Linear(d_model, d_ff, bias=False)
        else:
            self.wi = nn.Linear(d_model, d_ff, bias=False)
        self.wo = nn.Linear(d_ff, d_model, bias=False)

    def _act(self, x):
        if self.act_fn == "gelu_new":
            return F.gelu(x, approximate="tanh")
        if self.act_fn == "gelu":
            return F.gelu(x)
        return F.relu(x)

    def forward(self, x):
        if self.gated_act:
            h = self._act(self.wi_0(x)) * self.wi_1(x)
        else:
            h = self._act(self.wi(x))
        return self.wo(h)


class _SelfAttentionLayer(nn.Module):
    def __init__(self, d_model, num_heads, d_kv, has_relative_attention_bias, num_buckets):
        super().__init__()
        self.SelfAttention = T5Attention(d_model, num_heads, d_kv, has_relative_attention_bias,
                                         num_buckets)
        self.layer_norm = T5LayerNorm(d_model)


class _FFLayer(nn.Module):
    def __init__(self, d_model, d_ff, gated_act, act_fn):
        super().__init__()
        self.DenseReluDense = T5FF(d_model, d_ff, gated_act, act_fn)
        self.layer_norm = T5LayerNorm(d_model)


class T5EncoderBlock(nn.Module):
    """x + SelfAttention(LN(x)), then x + DenseReluDense(LN(x))."""

    def __init__(self, d_model: int, num_heads: int, d_kv: int, d_ff: int,
                 gated_act: bool = True, act_fn: str = "gelu_new",
                 has_relative_attention_bias: bool = False, num_buckets: int = 32):
        super().__init__()
        self.layer = nn.ModuleList([
            _SelfAttentionLayer(d_model, num_heads, d_kv, has_relative_attention_bias,
                                num_buckets),
            _FFLayer(d_model, d_ff, gated_act, act_fn),
        ])

    def forward(self, hidden_states, attention_bias, position_bias):
        attn, ff = self.layer
        hidden_states = hidden_states + attn.SelfAttention(
            attn.layer_norm(hidden_states), attention_bias, position_bias)
        return hidden_states + ff.DenseReluDense(ff.layer_norm(hidden_states))


class _Stack(nn.Module):
    def __init__(self, shared: nn.Embedding, blocks, d_model: int):
        super().__init__()
        self.embed_tokens = shared
        self.block = nn.ModuleList(blocks)
        self.final_layer_norm = T5LayerNorm(d_model)


class T5EncoderStack(nn.Module):
    """Token ids -> last hidden state, HF ``T5EncoderModel(...).last_hidden_state``
    under the same weights.  ``attention_bias`` is the framework's additive
    padding bias (0 / -1e5, (b, 1, 1, L)), added to the position table's logits
    where HF adds its extended attention mask."""

    def __init__(self, vocab_size: int, d_model: int, num_layers: int, num_heads: int,
                 d_kv: int = 64, d_ff: Optional[int] = None, num_buckets: int = 32,
                 max_distance: int = 128, gated_act: bool = True, act_fn: str = "gelu_new"):
        super().__init__()
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        d_ff = d_ff or 4 * d_model
        self.shared = nn.Embedding(vocab_size, d_model)
        self.encoder = _Stack(self.shared, [
            T5EncoderBlock(d_model, num_heads, d_kv, d_ff, gated_act, act_fn,
                           has_relative_attention_bias=(i == 0), num_buckets=num_buckets)
            for i in range(num_layers)
        ], d_model)

    def init_weights_(self, generator: torch.Generator) -> None:
        """The JAX package's T5 initialisers, drawn from `generator` in
        parameter order: N(0, 1) tables (the token embedding, the position
        buckets), N(0, 1 / fan_in) projections (flax's lecun_normal, untruncated),
        unit RMS norms."""
        with torch.no_grad():
            for name, param in self.named_parameters():
                if name.endswith("layer_norm.weight"):
                    param.fill_(1.0)
                elif param.ndim == 2 and ("shared" in name or "relative_attention_bias" in name):
                    param.copy_(torch.randn(param.shape, generator=generator))
                else:
                    std = param.shape[1] ** -0.5
                    param.copy_(torch.randn(param.shape, generator=generator) * std)

    def position_bias(self, seq_len: int, device) -> torch.Tensor:
        """(1, h, L, L) float32: the first block's table at each bucket."""
        buckets = torch.from_numpy(
            encoder_bucket_table(seq_len, self.num_buckets, self.max_distance)).to(device)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias
        return table(buckets).permute(2, 0, 1)[None].contiguous()

    def forward(self, token_ids: torch.Tensor,
                attention_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden = self.shared(token_ids.long())
        position_bias = self.position_bias(token_ids.shape[1], token_ids.device)
        for block in self.encoder.block:
            hidden = block(hidden, attention_bias, position_bias)
        return self.encoder.final_layer_norm(hidden)
