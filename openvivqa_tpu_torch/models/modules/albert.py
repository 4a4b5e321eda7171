"""The ALBERT encoder stack, under Hugging Face's parameter names.

Counterpart of ``openvivqa_tpu/models/modules/albert.py`` (HF ``AlbertModel``
without its pooler): factorised embeddings (word, position and token-type tables
at ``embedding_size``, LayerNorm eps 1e-12), one ``embedding_hidden_mapping_in``
Linear to the hidden width, then ``num_layers`` post-LN layers drawn from
``num_groups`` shared groups of ``inner_group_num`` layers (layer i runs group
i * num_groups // num_layers; the released checkpoints have one group of one
layer, applied num_layers times).

Parameter names are HF ``AlbertModel``'s (``embeddings.word_embeddings``,
``encoder.embedding_hidden_mapping_in``,
``encoder.albert_layer_groups.G.albert_layers.J.attention.{query,key,value,dense,
LayerNorm}``, ``...ffn``, ``...ffn_output``, ``...full_layer_layer_norm``), so a
local checkpoint loads with ``load_state_dict``.

The stack runs frozen and in eval (the JAX wrappers call it with
``train=False``).  Each layer's attention sublayer (q/k/v projections, softmax
under the key-padding bias, the ``dense`` projection, residual and LayerNorm eps
1e-12) is kernel F (``ops/encoder_layer.fused_encoder_self_attention``); the FFN
stays in torch, as its activation is ``gelu_new`` (the tanh GELU) and kernel C
computes the exact one.  A shared layer's weight bundle is built once per
forward and reused by every layer that runs it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import _cuda
from ...ops import encoder_layer as _enc
from .attentions import key_bias_rows
from .bert import _matrix, vector

LN_EPS = 1e-12


def init_lecun_law_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initialisers for ALBERT and DeBERTa, drawn from
    `generator` in module order: normal(0.02) embedding tables, lecun-normal
    (N(0, 1 / fan_in), untruncated) Linear and Conv1d weights, zero biases,
    LayerNorm scale 1 and bias 0."""
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, nn.Embedding):
                sub.weight.copy_(torch.randn(sub.weight.shape, generator=generator) * 0.02)
            elif isinstance(sub, (nn.Linear, nn.Conv1d)):
                fan_in = sub.weight[0].numel()
                sub.weight.copy_(torch.randn(sub.weight.shape, generator=generator)
                                 * fan_in ** -0.5)
                if sub.bias is not None:
                    sub.bias.zero_()
            elif isinstance(sub, nn.LayerNorm):
                sub.weight.fill_(1.0)
                sub.bias.zero_()
    return module


class AlbertEmbeddings(nn.Module):
    """Word + position + token-type tables at `embedding_size`, LayerNorm."""

    def __init__(self, vocab_size: int, embedding_size: int = 128,
                 max_position_embeddings: int = 512, type_vocab_size: int = 2):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, embedding_size)
        self.position_embeddings = nn.Embedding(max_position_embeddings, embedding_size)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, embedding_size)
        self.LayerNorm = nn.LayerNorm(embedding_size, eps=LN_EPS)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        token_ids = token_ids.long()
        positions = torch.arange(token_ids.shape[1], device=token_ids.device)[None]
        return self.LayerNorm(self.word_embeddings(token_ids)
                              + self.position_embeddings(positions)
                              + self.token_type_embeddings(torch.zeros_like(token_ids)))


class AlbertAttention(nn.Module):
    """HF ``AlbertSdpaAttention``'s parameters: q/k/v, ``dense``, ``LayerNorm``."""

    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden size {hidden_size} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.scale = 1.0 / float(hidden_size // num_heads) ** 0.5
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)
        self.dense = nn.Linear(hidden_size, hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=LN_EPS)

    @torch.no_grad()
    def kernel_weights(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """Kernel F's bundle: q|k|v packed into one (hd, 3hd) matrix."""
        return {
            "wqkv": torch.cat([_matrix(self.query, dtype), _matrix(self.key, dtype),
                               _matrix(self.value, dtype)], dim=1),
            "bqkv": torch.cat([vector(self.query.bias), vector(self.key.bias),
                              vector(self.value.bias)]),
            "wo": _matrix(self.dense, dtype),
            "bo": vector(self.dense.bias),
            "ln_scale": vector(self.LayerNorm.weight),
            "ln_bias": vector(self.LayerNorm.bias),
        }

    def forward(self, hidden, key_bias, weights):
        return _enc.fused_encoder_self_attention(
            hidden.float().contiguous(), weights, key_bias, self.scale, self.num_heads, LN_EPS)


class AlbertLayer(nn.Module):
    """Kernel F's attention sublayer, then LayerNorm(x + ffn_output(gelu_new(ffn(x))))."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int):
        super().__init__()
        self.attention = AlbertAttention(hidden_size, num_heads)
        self.ffn = nn.Linear(hidden_size, intermediate_size)
        self.ffn_output = nn.Linear(intermediate_size, hidden_size)
        self.full_layer_layer_norm = nn.LayerNorm(hidden_size, eps=LN_EPS)

    def forward(self, hidden, key_bias, weights):
        attended = self.attention(hidden, key_bias, weights)
        out = self.ffn_output(F.gelu(self.ffn(attended), approximate="tanh"))
        return self.full_layer_layer_norm(out + attended)


class _AlbertLayerGroup(nn.Module):
    def __init__(self, hidden_size, num_heads, intermediate_size, inner_group_num):
        super().__init__()
        self.albert_layers = nn.ModuleList(
            AlbertLayer(hidden_size, num_heads, intermediate_size) for _ in range(inner_group_num))


class _AlbertTransformer(nn.Module):
    def __init__(self, embedding_size, hidden_size, num_heads, intermediate_size, num_groups,
                 inner_group_num):
        super().__init__()
        self.embedding_hidden_mapping_in = nn.Linear(embedding_size, hidden_size)
        self.albert_layer_groups = nn.ModuleList(
            _AlbertLayerGroup(hidden_size, num_heads, intermediate_size, inner_group_num)
            for _ in range(num_groups))


class AlbertEncoderStack(nn.Module):
    """Token ids -> last hidden state, HF ``AlbertModel(...).last_hidden_state``
    under the same weights.  ``attention_bias`` is the framework's additive
    (b, 1, 1, L) padding bias (0 / -1e5) or None."""

    def __init__(self, vocab_size: int, hidden_size: int, num_layers: int, num_heads: int,
                 embedding_size: int = 128, intermediate_size: Optional[int] = None,
                 num_groups: int = 1, inner_group_num: int = 1,
                 max_position_embeddings: int = 512):
        super().__init__()
        self.num_layers = num_layers
        self.num_groups = num_groups
        self.embeddings = AlbertEmbeddings(vocab_size, embedding_size, max_position_embeddings)
        self.encoder = _AlbertTransformer(embedding_size, hidden_size, num_heads,
                                          intermediate_size or 4 * hidden_size, num_groups,
                                          inner_group_num)

    def init_weights_(self, generator: torch.Generator) -> None:
        init_lecun_law_(self, generator)

    def schedule(self):
        """The layer each of the num_layers steps runs, in order."""
        groups = self.encoder.albert_layer_groups
        return [layer for i in range(self.num_layers)
                for layer in groups[i * self.num_groups // self.num_layers].albert_layers]

    def forward(self, token_ids: torch.Tensor,
                attention_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden = self.encoder.embedding_hidden_mapping_in(self.embeddings(token_ids))
        b, s, _ = hidden.shape
        key_bias = key_bias_rows(attention_bias, b, s, hidden.device)
        dtype = _cuda.kernel_dtype(hidden.device)
        bundles = {}
        for layer in self.schedule():
            if id(layer) not in bundles:
                bundles[id(layer)] = layer.attention.kernel_weights(dtype)
            hidden = layer(hidden, key_bias, bundles[id(layer)])
        return hidden
