"""IterativeMCAN: the MCAN encoder stack under a transformer decoder.

Counterpart of ``openvivqa_tpu/models/iterative_mcan.py``: the question through
the self-attention encoder, the regions through the guided-attention encoder
against it, both streams concatenated, fused by an FFN and a LayerNorm, then
the decoder.  Parameter names are the reference's.
"""

from __future__ import annotations

import torch
from torch import nn

from ..builders import (
    META_ARCHITECTURE,
    build_decoder,
    build_encoder,
    build_text_embedding,
    build_vision_embedding,
)
from .base import BatchTensors, GenerativeModel, init_xavier_law_
from .modules.ffn import LN_EPS, PositionWiseFeedForward


@META_ARCHITECTURE.register()
class IterativeMCAN(GenerativeModel):
    def __init__(self, config, vocab):
        super().__init__()
        self.vocab = vocab
        self.text_embedding = build_text_embedding(config.TEXT_EMBEDDING, vocab)
        self.vision_embedding = build_vision_embedding(config.VISION_EMBEDDING)
        self.self_encoder = build_encoder(config.SELF_ENCODER)
        self.guided_encoder = build_encoder(config.GUIDED_ENCODER)
        self.fusion = PositionWiseFeedForward(config.MULTIMODAL_FUSION)
        self.norm = nn.LayerNorm(config.D_MODEL, eps=LN_EPS)
        self.decoder = build_decoder(config.DECODER, vocab=vocab)

    def init_weights_(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers for this model (``init_xavier_law_``)."""
        init_xavier_law_(self, generator)

    def _vision(self, batch: BatchTensors, generator=None):
        return self.vision_embedding(batch["region_features"], generator)

    def encode(self, batch: BatchTensors, generator=None):
        vision_features, vision_bias = self._vision(batch, generator)
        text_features, (text_bias, _) = self.text_embedding(batch["question_tokens"], generator)
        text_features = self.self_encoder(text_features, text_bias, generator)
        vision_features = self.guided_encoder(
            vision_features, vision_bias, text_features, text_bias, generator
        )
        encoder_features = torch.cat([vision_features, text_features], dim=1)
        encoder_bias = torch.cat([vision_bias, text_bias], dim=-1)
        encoder_features = self.norm(self.fusion(encoder_features, generator))
        return encoder_features, encoder_bias

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        encoder_features, encoder_bias = self.encode(batch, generator)
        return self.decoder(batch["answer_tokens"], encoder_features, encoder_bias, generator)
