"""ParallelAttentionTransformer: ViLBERT's co-attention encoder under the
dual-stream classification head.

Counterpart of ``openvivqa_tpu/models/parallel_attention_transformer.py``.  No
reference converter reads this model; the port names it like MCAN
(``vision_embedding``, ``text_embedding``, ``encoder`` and the head's
``vision_attr_reduce`` ... ``classify``).
"""

from __future__ import annotations

import torch

from ..builders import (
    META_ARCHITECTURE,
    build_encoder,
    build_text_embedding,
    build_vision_embedding,
)
from .base import BatchTensors, ClassificationModel
from .common import DualStreamClassifier, total_answers_of


@META_ARCHITECTURE.register()
class ParallelAttentionTransformer(DualStreamClassifier, ClassificationModel):
    def __init__(self, config, vocab):
        super().__init__()
        self.vision_embedding = build_vision_embedding(config.VISION_EMBEDDING)
        self.text_embedding = build_text_embedding(config.TEXT_EMBEDDING, vocab)
        self.encoder = build_encoder(config.ENCODER)
        self.build_classifier(config, total_answers_of(vocab))

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        vision_features, vision_bias = self.vision_embedding(batch["region_features"], generator)
        text_features, (text_bias, _) = self.text_embedding(batch["question_tokens"], generator)
        vision_features, text_features = self.encoder(
            vision_features, vision_bias, text_features, text_bias, generator)
        logits = self.classify_streams(vision_features, text_features, generator)
        return torch.log_softmax(logits, dim=-1)
