"""VanillaTransformer: one self-attention encoder over [regions | question],
attention-pooled, projected, normalised and classified.

Counterpart of ``openvivqa_tpu/models/vanilla_transformer.py``.  No reference
converter reads this model, so the names are the port's: ``vision_embedding``,
``text_embedding``, ``encoder``, ``attr_reduce``, ``proj``, ``layer_norm`` and
``classify``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..builders import (
    META_ARCHITECTURE,
    build_encoder,
    build_text_embedding,
    build_vision_embedding,
)
from .base import BatchTensors, ClassificationModel
from .common import AttentionReduceMLP, attention_pool, total_answers_of
from .modules.ffn import LN_EPS


@META_ARCHITECTURE.register()
class VanillaTransformer(ClassificationModel):
    def __init__(self, config, vocab):
        super().__init__()
        d_model = config.D_MODEL
        self.vision_embedding = build_vision_embedding(config.VISION_EMBEDDING)
        self.text_embedding = build_text_embedding(config.TEXT_EMBEDDING, vocab)
        self.encoder = build_encoder(config.ENCODER)
        self.attr_reduce = AttentionReduceMLP(config.ATTR_REDUCE, d_model)
        self.proj = nn.Linear(d_model, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.classify = nn.Linear(d_model, total_answers_of(vocab))

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        vision_features, vision_bias = self.vision_embedding(batch["region_features"], generator)
        text_features, (text_bias, _) = self.text_embedding(batch["question_tokens"], generator)
        fused = torch.cat([vision_features, text_features], dim=1)
        fused_bias = torch.cat([vision_bias, text_bias], dim=-1)
        fused = self.encoder(fused, fused_bias, generator)
        pooled = attention_pool(fused, self.attr_reduce(fused, generator))
        logits = self.classify(self.layer_norm(self.proj(pooled)))
        return torch.log_softmax(logits, dim=-1)
