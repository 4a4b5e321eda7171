"""Encoder stacks: the self-attention encoder, MCAN's guided-attention one and
the ViLBERT co-attention one.

Counterpart of ``EncoderLayer``, ``GuidedEncoderLayer``, ``Encoder`` (with its
single-token ``decode_step``), ``MultiModalEncoder``, ``GuidedAttentionEncoder``
and ``CoAttentionEncoder`` and ``GeometricEncoder`` (whose layers hand the boxes to
the geometry attention core) in
``openvivqa_tpu/models/modules/encoders.py``, under the reference's parameter
names (``layers.N.mhatt``, ``guided_attn_layers.N.self_mhatt``,
``vision_language_attn_layers.N.mhatt`` ...), and ``CrossModalityEncoderLayer``
and ``CrossModalityEncoder`` (LXMERT's stack, ``layers.N.vision_language_mhattn``
... after the JAX layer's attribute names).  A `generator` selects the training
route (dropout drawn from it).
"""

from __future__ import annotations

import torch
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

    def forward(self, queries, keys, values, attention_bias, generator=None, **extras):
        att = self.mhatt(queries, keys, values, attention_bias, generator, **extras)
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


class CrossModalityEncoderLayer(nn.Module):
    """LXMERT's dual-stream layer: per stream cross-attention, then
    self-attention over its output, then the FFN (the published dataflow; the
    reference's self-attention overwrites the cross output instead).  Both
    cross-attentions read the streams as they entered the layer."""

    def __init__(self, config):
        super().__init__()
        self.vision_language_mhattn = MultiHeadAttention(config.VISION_LANGUAGE_ATTENTION)
        self.language_vision_mhattn = MultiHeadAttention(config.LANGUAGE_VISION_ATTENTION)
        self.vision_mhattn = MultiHeadAttention(config.VISION_SELF_ATTENTION)
        self.language_mhattn = MultiHeadAttention(config.LANGUAGE_SELF_ATTENTION)
        self.vision_pff = PositionWiseFeedForward(config.VISION_SELF_ATTENTION)
        self.language_pff = PositionWiseFeedForward(config.LANGUAGE_SELF_ATTENTION)

    def forward(self, vision, vision_padding_bias, language, language_padding_bias,
                generator=None):
        vision_cross = self.vision_language_mhattn(vision, language, language,
                                                   language_padding_bias, generator)
        language_cross = self.language_vision_mhattn(language, vision, vision,
                                                     vision_padding_bias, generator)
        vision_attn = self.vision_mhattn(vision_cross, vision_cross, vision_cross,
                                         vision_padding_bias, generator)
        language_attn = self.language_mhattn(language_cross, language_cross, language_cross,
                                             language_padding_bias, generator)
        return (self.vision_pff(vision_attn, generator),
                self.language_pff(language_attn, generator))


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

    def forward(self, features, padding_bias, generator=None, return_layer_inputs: bool = False):
        """With ``return_layer_inputs`` also each layer's input: the keys and
        values an incremental decode caches beside its own prefix."""
        out = self.layer_norm(features) + self.pos_embedding(features)
        layer_inputs = []
        for layer in self.layers:
            layer_inputs.append(out)
            out = layer(out, out, out, padding_bias, generator)
        if return_layer_inputs:
            return out, layer_inputs
        return out

    def decode_step(self, token_features, position, context_inputs, caches, step: int,
                    attention_bias):
        """One new token (bs, 1, d), before the LayerNorm and positions, through
        every layer at the 1-based absolute `position` (bs, 1): layer i writes
        its input into slot `step` of caches[i] (bs, T, d) in place and attends
        [context_inputs[i] (bs, C, d) | caches[i]] under attention_bias (bs, 1,
        1, C + T).  Eval only.  Returns (bs, 1, d)."""
        x = self.layer_norm(token_features) + self.pos_embedding.encode_positions(position)
        for layer, context, cache in zip(self.layers, context_inputs, caches):
            cache[:, step] = x[:, 0]
            kv = torch.cat([context, cache], dim=1)
            x = layer(x, kv, kv, attention_bias)
        return x


@META_ENCODER.register()
class MultiModalEncoder(Encoder):
    """The Encoder under the name the M4C-family configs give their
    single-stream encoder; the prefix-LM models pass it a full (bs, 1, L, L)
    bias."""


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


@META_ENCODER.register()
class CoAttentionEncoder(nn.Module):
    """ViLBERT's co-attention stack.  Both streams share one sinusoid table,
    each behind its own LayerNorm; in each layer the vision stream
    cross-attends the language stream, the language stream cross-attends the
    vision stream as just updated, then each stream attends itself."""

    def __init__(self, config):
        super().__init__()
        self.pos_embedding = SinusoidPositionalEmbedding(config.D_MODEL)
        self.vision_layer_norm = nn.LayerNorm(config.D_MODEL, eps=LN_EPS)
        self.language_layer_norm = nn.LayerNorm(config.D_MODEL, eps=LN_EPS)

        def stack(attention):
            return nn.ModuleList(EncoderLayer(attention) for _ in range(config.LAYERS))

        self.vision_language_attn_layers = stack(config.VISION_LANGUAGE_ATTENTION)
        self.language_vision_attn_layers = stack(config.LANGUAGE_VISION_ATTENTION)
        self.vision_self_attn_layers = stack(config.VISION_SELF_ATTENTION)
        self.language_self_attn_layers = stack(config.LANGUAGE_SELF_ATTENTION)

    def forward(self, vision_features, vision_padding_bias, language_features,
                language_padding_bias, generator=None):
        vision = self.vision_layer_norm(vision_features) + self.pos_embedding(vision_features)
        language = (self.language_layer_norm(language_features)
                    + self.pos_embedding(language_features))
        for vl, lv, vs, ls in zip(self.vision_language_attn_layers,
                                  self.language_vision_attn_layers,
                                  self.vision_self_attn_layers,
                                  self.language_self_attn_layers):
            vision = vl(vision, language, language, language_padding_bias, generator)
            language = lv(language, vision, vision, vision_padding_bias, generator)
            vision = vs(vision, vision, vision, vision_padding_bias, generator)
            language = ls(language, language, language, language_padding_bias, generator)
        return vision, language


@META_ENCODER.register()
class CrossModalityEncoder(nn.Module):
    """LXMERT's stack: each stream behind its own LayerNorm plus the shared
    sinusoid table, then N ``CrossModalityEncoderLayer``s."""

    def __init__(self, config):
        super().__init__()
        self.pos_embedding = SinusoidPositionalEmbedding(config.D_MODEL)
        self.vision_layer_norm = nn.LayerNorm(config.D_MODEL, eps=LN_EPS)
        self.language_layer_norm = nn.LayerNorm(config.D_MODEL, eps=LN_EPS)
        self.layers = nn.ModuleList(
            CrossModalityEncoderLayer(config) for _ in range(config.LAYERS))

    def forward(self, vision_features, vision_padding_bias, language_features,
                language_padding_bias, generator=None):
        vision = self.vision_layer_norm(vision_features) + self.pos_embedding(vision_features)
        language = (self.language_layer_norm(language_features)
                    + self.pos_embedding(language_features))
        for layer in self.layers:
            vision, language = layer(vision, vision_padding_bias, language,
                                     language_padding_bias, generator)
        return vision, language


@META_ENCODER.register()
class GeometricEncoder(nn.Module):
    """LayerNorm + sinusoid positions, then N self-attention layers whose
    cores receive the (bs, n, 4) boxes (the geometry-augmented attention)."""

    def __init__(self, config):
        super().__init__()
        self.pos_embedding = SinusoidPositionalEmbedding(config.D_MODEL)
        self.layer_norm = nn.LayerNorm(config.D_MODEL, eps=LN_EPS)
        self.layers = nn.ModuleList(
            EncoderLayer(config.SELF_ATTENTION) for _ in range(config.LAYERS)
        )

    def forward(self, features, boxes, padding_bias, generator=None):
        out = self.layer_norm(features) + self.pos_embedding(features)
        for layer in self.layers:
            out = layer(out, out, out, padding_bias, generator, boxes=boxes)
        return out
