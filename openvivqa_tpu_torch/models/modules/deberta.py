"""The DeBERTa-v2 / v3 encoder stack, under Hugging Face's parameter names.

Counterpart of ``openvivqa_tpu/models/modules/deberta.py`` (HF
``DebertaV2Model``) at the layouts the published v2 / v3 checkpoints use:
embeddings (word, absolute positions only when ``position_biased_input``, no
token types, LayerNorm eps 1e-7, times the input mask), one relative-position
table shared by the layers (LayerNormed when ``norm_rel_ebd`` says so),
log-bucketed relative positions, disentangled attention (content-to-content,
content-to-position and position-to-content terms, each over
sqrt(3 * head_dim)), an optional convolution merged after layer 0
(v2-xlarge), post-LN layers with an exact-GELU FFN.

Parameter names are HF ``DebertaV2Model``'s (``embeddings.word_embeddings``,
``encoder.rel_embeddings``, ``encoder.LayerNorm``,
``encoder.layer.N.attention.self.{query_proj,key_proj,value_proj}``,
``...attention.output.{dense,LayerNorm}``, ``...intermediate.dense``,
``...output.{dense,LayerNorm}``, ``encoder.conv.{conv,LayerNorm}``), so a local
checkpoint loads with ``load_state_dict``.

The stack runs frozen and in eval.  The (L, L) bucket table is computed on the
host in float64 numpy, integer-equal to the JAX package's; the c2p and p2c terms
are ``torch.gather``s of the (b, h, L, 2S) position scores (the JAX package's
one-hot products at HIGHEST precision give the same values).  Each layer's
attention core is ``ops/fused_attention.fused_attention_packed_2bias`` on the
packed projections: the (b, 1, 1, L) padding bias as its head-shared operand,
the disentangled terms as its per-sample, per-head one (hb = b).  The
attention output (Linear, residual LayerNorm) stays in torch; the FFN sublayer
(exact GELU, Linear, residual LayerNorm eps 1e-7) is kernel C
(``ops/decode_step.fused_ffn_step``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...ops import _cuda
from ...ops import decode_step as _ds
from ...ops import fused_attention as _attn
from .albert import init_lecun_law_
from ...parallel.mesh import whole
from .bert import _matrix, vector


def make_log_bucket_position(relative_pos: np.ndarray, bucket_size: int,
                             max_position: int) -> np.ndarray:
    """Log-bucketed relative positions (HF modeling_deberta_v2), in float64."""
    sign = np.sign(relative_pos)
    mid = bucket_size // 2
    abs_pos = np.where((relative_pos < mid) & (relative_pos > -mid), mid - 1,
                       np.abs(relative_pos))
    log_pos = np.ceil(np.log(abs_pos.astype(np.float64) / mid)
                      / math.log((max_position - 1) / mid) * (mid - 1)) + mid
    bucket_pos = np.where(abs_pos <= mid, relative_pos.astype(np.float64), log_pos * sign)
    return bucket_pos.astype(np.int64)


def build_relative_position(query_size: int, key_size: int, bucket_size: int = -1,
                            max_position: int = -1) -> np.ndarray:
    """(L_q, L_k) int64 relative positions q_i - k_j, log-bucketed when
    bucket_size and max_position are positive."""
    rel = (np.arange(query_size, dtype=np.int64)[:, None]
           - np.arange(key_size, dtype=np.int64)[None, :])
    if bucket_size > 0 and max_position > 0:
        rel = make_log_bucket_position(rel, bucket_size, max_position)
    return rel


class DisentangledSelfAttention(nn.Module):
    """HF ``DisentangledSelfAttention``'s projections; `forward` is the core
    (before the output Linear)."""

    def __init__(self, hidden_size: int, num_heads: int, share_att_key: bool = False,
                 att_span: int = 256):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden size {hidden_size} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.share_att_key = share_att_key
        self.att_span = att_span
        # the c2c, c2p and p2c terms
        self.scale = math.sqrt(3 * self.head_dim)
        self.query_proj = nn.Linear(hidden_size, hidden_size)
        self.key_proj = nn.Linear(hidden_size, hidden_size)
        self.value_proj = nn.Linear(hidden_size, hidden_size)
        if not share_att_key:
            self.pos_key_proj = nn.Linear(hidden_size, hidden_size)
            self.pos_query_proj = nn.Linear(hidden_size, hidden_size)

    def _heads(self, x):
        return x.reshape(*x.shape[:-1], self.num_heads, self.head_dim)

    def relative_bias(self, q, k, relative_pos, rel_embeddings) -> torch.Tensor:
        """(b, h, L, L) float32: the c2p and p2c terms over the scale."""
        b, length = q.shape[:2]
        span = self.att_span
        rel_emb = rel_embeddings[: span * 2]
        index = relative_pos.expand(b, self.num_heads, length, length)
        pos_key = self._heads((self.key_proj if self.share_att_key
                               else self.pos_key_proj)(rel_emb))
        c2p = torch.einsum("bqhd,shd->bhqs", self._heads(q), pos_key)
        bias = torch.gather(c2p, -1, torch.clamp(index + span, 0, 2 * span - 1))
        pos_query = self._heads((self.query_proj if self.share_att_key
                                 else self.pos_query_proj)(rel_emb))
        p2c = torch.einsum("bkhd,shd->bhks", self._heads(k), pos_query)
        # out[b, h, q, k] = p2c[b, h, k, clamp(-rel[k, q] + span)]
        gathered = torch.gather(p2c, -1, torch.clamp(-index + span, 0, 2 * span - 1))
        return ((bias + gathered.transpose(-1, -2)) / self.scale).float().contiguous()

    def forward(self, hidden, attention_bias, relative_pos, rel_embeddings) -> torch.Tensor:
        q, k, v = self.query_proj(hidden), self.key_proj(hidden), self.value_proj(hidden)
        head_bias = self.relative_bias(q, k, relative_pos, rel_embeddings)
        return _attn.fused_attention_packed_2bias(
            q.float().contiguous(), k.float().contiguous(), v.float().contiguous(),
            attention_bias, head_bias, 1.0 / self.scale, self.num_heads)


class _DenseLayerNorm(nn.Module):
    def __init__(self, in_size: int, hidden_size: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(in_size, hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=eps)


class _Attention(nn.Module):
    def __init__(self, hidden_size, num_heads, share_att_key, att_span, eps):
        super().__init__()
        self.self = DisentangledSelfAttention(hidden_size, num_heads, share_att_key, att_span)
        self.output = _DenseLayerNorm(hidden_size, hidden_size, eps)


class _Intermediate(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int):
        super().__init__()
        self.dense = nn.Linear(hidden_size, intermediate_size)


class DebertaV2Layer(nn.Module):
    """Disentangled attention, its output Linear and residual LayerNorm, then
    the FFN sublayer."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 share_att_key: bool = False, att_span: int = 256, ln_eps: float = 1e-7):
        super().__init__()
        self.ln_eps = ln_eps
        self.attention = _Attention(hidden_size, num_heads, share_att_key, att_span, ln_eps)
        self.intermediate = _Intermediate(hidden_size, intermediate_size)
        self.output = _DenseLayerNorm(intermediate_size, hidden_size, ln_eps)

    @torch.no_grad()
    def ffn_kernel_weights(self, dtype: torch.dtype):
        return {
            "w1": _matrix(self.intermediate.dense, dtype),
            "b1": vector(self.intermediate.dense.bias),
            "w2": _matrix(self.output.dense, dtype),
            "b2": vector(self.output.dense.bias),
            "ln_scale": vector(self.output.LayerNorm.weight),
            "ln_bias": vector(self.output.LayerNorm.bias),
        }

    def ffn(self, hidden):
        """Kernel C: exact GELU, Linear, residual LayerNorm."""
        f = self.ffn_kernel_weights(_cuda.kernel_dtype(hidden.device))
        rows = hidden.reshape(-1, hidden.shape[-1]).float().contiguous()
        out = _ds.fused_ffn_step(rows, f["w1"], f["b1"], f["w2"], f["b2"], f["ln_scale"],
                                 f["ln_bias"], eps=self.ln_eps)
        return out.reshape(hidden.shape)

    def forward(self, hidden, attention_bias, relative_pos, rel_embeddings):
        context = self.attention.self(hidden, attention_bias, relative_pos, rel_embeddings)
        out = self.attention.output
        attended = out.LayerNorm(out.dense(context) + hidden)
        return self.ffn(attended)


class _ConvLayer(nn.Module):
    def __init__(self, hidden_size: int, kernel_size: int, groups: int, eps: float):
        super().__init__()
        self.conv = nn.Conv1d(hidden_size, hidden_size, kernel_size,
                              padding=(kernel_size - 1) // 2, groups=groups)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=eps)


class _Encoder(nn.Module):
    def __init__(self, hidden_size, num_layers, layer_args, att_span, norm_rel_ebd,
                 conv_kernel_size, conv_groups, ln_eps):
        super().__init__()
        self.layer = nn.ModuleList(DebertaV2Layer(*layer_args) for _ in range(num_layers))
        self.rel_embeddings = nn.Embedding(att_span * 2, hidden_size)
        if "layer_norm" in norm_rel_ebd:
            self.LayerNorm = nn.LayerNorm(hidden_size, eps=ln_eps)
        if conv_kernel_size > 0:
            self.conv = _ConvLayer(hidden_size, conv_kernel_size, conv_groups, ln_eps)


class _Embeddings(nn.Module):
    def __init__(self, vocab_size, hidden_size, max_position_embeddings, position_biased_input,
                 ln_eps):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        if position_biased_input:
            self.position_embeddings = nn.Embedding(max_position_embeddings, hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=ln_eps)

    def forward(self, token_ids):
        token_ids = token_ids.long()
        out = self.word_embeddings(token_ids)
        if hasattr(self, "position_embeddings"):
            out = out + self.position_embeddings(
                torch.arange(token_ids.shape[1], device=token_ids.device)[None])
        return self.LayerNorm(out)


class DebertaV2EncoderStack(nn.Module):
    """Token ids -> last hidden state, HF ``DebertaV2Model(...).last_hidden_state``
    under the same weights.  ``attention_bias`` is the framework's additive
    (b, 1, 1, L) padding bias (0 / -1e5) or None."""

    def __init__(self, vocab_size: int, hidden_size: int, num_layers: int, num_heads: int,
                 intermediate_size: Optional[int] = None, max_position_embeddings: int = 512,
                 position_biased_input: bool = True, position_buckets: int = -1,
                 max_relative_positions: int = -1, share_att_key: bool = False,
                 norm_rel_ebd: str = "none", conv_kernel_size: int = 0, conv_groups: int = 1,
                 ln_eps: float = 1e-7):
        super().__init__()
        self.ln_eps = ln_eps
        self.position_buckets = position_buckets
        self.max_rel = (max_relative_positions if max_relative_positions > 0
                        else max_position_embeddings)
        att_span = position_buckets if position_buckets > 0 else self.max_rel
        self.embeddings = _Embeddings(vocab_size, hidden_size, max_position_embeddings,
                                      position_biased_input, ln_eps)
        layer_args = (hidden_size, num_heads, intermediate_size or 4 * hidden_size,
                      share_att_key, att_span, ln_eps)
        self.encoder = _Encoder(hidden_size, num_layers, layer_args, att_span, norm_rel_ebd,
                                conv_kernel_size, conv_groups, ln_eps)

    def init_weights_(self, generator: torch.Generator) -> None:
        init_lecun_law_(self, generator)

    def relative_position(self, length: int, device) -> torch.Tensor:
        """The (L, L) int64 bucket table, computed on the host."""
        return torch.from_numpy(build_relative_position(
            length, length, self.position_buckets, self.max_rel)).to(device)

    def forward(self, token_ids: torch.Tensor,
                attention_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden = self.embeddings(token_ids)
        mask = None
        if attention_bias is not None:
            mask = (attention_bias[:, 0, 0, :] == 0).to(hidden.dtype)[..., None]
            hidden = hidden * mask
        encoder = self.encoder
        rel_embeddings = whole(encoder.rel_embeddings.weight)
        if hasattr(encoder, "LayerNorm"):
            rel_embeddings = encoder.LayerNorm(rel_embeddings)
        relative_pos = self.relative_position(token_ids.shape[1], hidden.device)
        first_input = hidden
        for i, layer in enumerate(encoder.layer):
            out = layer(hidden, attention_bias, relative_pos, rel_embeddings)
            if i == 0 and hasattr(encoder, "conv"):
                conv = encoder.conv.conv(first_input.transpose(1, 2)).transpose(1, 2)
                if mask is not None:
                    conv = conv * mask
                out = encoder.conv.LayerNorm(out + torch.tanh(conv))
                if mask is not None:
                    out = out * mask
            hidden = out
        return hidden
