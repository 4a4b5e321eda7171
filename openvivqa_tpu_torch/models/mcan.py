"""MCAN, the Deep Modular Co-Attention Network with its classification head.

Counterpart of ``openvivqa_tpu/models/mcan.py``: the question through the
text embedding and the self-attention encoder, the regions through the
guided-attention encoder against it, both streams attention-pooled, projected,
summed and normalised, then the classifier and a log-softmax.  Parameter names
are the reference's, the ones ``torch_conversion.convert_mcan`` reads.
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
class MCAN(DualStreamClassifier, ClassificationModel):
    def __init__(self, config, vocab):
        super().__init__()
        self.vocab = vocab
        self.text_embedding = build_text_embedding(config.TEXT_EMBEDDING, vocab)
        self.vision_embedding = build_vision_embedding(config.VISION_EMBEDDING)
        self.self_encoder = build_encoder(config.SELF_ENCODER)
        self.guided_encoder = build_encoder(config.GUIDED_ENCODER)
        self.build_classifier(config, total_answers_of(vocab))

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        vision_features, vision_bias = self.vision_embedding(batch["region_features"], generator)
        text_features, (text_bias, _) = self.text_embedding(batch["question_tokens"], generator)
        text_features = self.self_encoder(text_features, text_bias, generator)
        vision_features = self.guided_encoder(
            vision_features, vision_bias, text_features, text_bias, generator
        )
        logits = self.classify_streams(vision_features, text_features, generator)
        return torch.log_softmax(logits, dim=-1)
