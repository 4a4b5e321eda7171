"""Encoder stacks: the self-attention encoder and MCAN's guided-attention one.

Counterpart of ``EncoderLayer``, ``GuidedEncoderLayer``, ``Encoder`` and
``GuidedAttentionEncoder`` in ``openvivqa_tpu/models/modules/encoders.py``, under
the reference's parameter names (``layers.N.mhatt``, ``guided_attn_layers.N.
self_mhatt`` ...).  The geometric, co-attention and cross-modality encoders wait
for the models that use them (ROADMAP queue 1, slice 5).  A `generator` selects
the training route (dropout drawn from it).
"""

from __future__ import annotations

from torch import nn

from ...builders import META_ENCODER
from .attentions import MultiHeadAttention
from .ffn import LN_EPS, PositionWiseFeedForward
from .position import SinusoidPositionalEmbedding


class EncoderLayer(nn.Module):
    """Attention + FFN."""

    def __init__(self, config):
        super().__init__()
        self.mhatt = MultiHeadAttention(config)
        self.pwff = PositionWiseFeedForward(config)

    def forward(self, queries, keys, values, attention_bias, generator=None):
        att = self.mhatt(queries, keys, values, attention_bias, generator)
        return self.pwff(att, generator)


class GuidedEncoderLayer(nn.Module):
    """Self-attention, then guided (cross) attention, then FFN."""

    def __init__(self, config):
        super().__init__()
        self.self_mhatt = MultiHeadAttention(config)
        self.guided_mhatt = MultiHeadAttention(config)
        self.pwff = PositionWiseFeedForward(config)

    def forward(self, queries, keys, values, self_attention_bias, guided_attention_bias,
                generator=None):
        self_att = self.self_mhatt(queries, queries, queries, self_attention_bias, generator)
        guided_att = self.guided_mhatt(self_att, keys, values, guided_attention_bias, generator)
        return self.pwff(guided_att, generator)


@META_ENCODER.register()
class Encoder(nn.Module):
    """LayerNorm + sinusoid positions, then N self-attention layers."""

    def __init__(self, config):
        super().__init__()
        self.pos_embedding = SinusoidPositionalEmbedding(config.D_MODEL)
        self.layer_norm = nn.LayerNorm(config.D_MODEL, eps=LN_EPS)
        self.layers = nn.ModuleList(
            EncoderLayer(config.SELF_ATTENTION) for _ in range(config.LAYERS)
        )

    def forward(self, features, padding_bias, generator=None):
        out = self.layer_norm(features) + self.pos_embedding(features)
        for layer in self.layers:
            out = layer(out, out, out, padding_bias, generator)
        return out


@META_ENCODER.register()
class GuidedAttentionEncoder(nn.Module):
    """MCAN's guided-attention stack: the vision stream attends itself, then
    the encoded language stream, in every layer."""

    def __init__(self, config):
        super().__init__()
        self.pos_embedding = SinusoidPositionalEmbedding(config.D_MODEL)
        self.layer_norm = nn.LayerNorm(config.D_MODEL, eps=LN_EPS)
        self.guided_attn_layers = nn.ModuleList(
            GuidedEncoderLayer(config.GUIDED_ATTENTION) for _ in range(config.LAYERS)
        )

    def forward(self, vision_features, vision_padding_bias, language_features,
                language_padding_bias, generator=None):
        out = self.layer_norm(vision_features) + self.pos_embedding(vision_features)
        for layer in self.guided_attn_layers:
            out = layer(out, language_features, language_features, vision_padding_bias,
                        language_padding_bias, generator)
        return out
