"""HierarchicalCoAttention: an n-gram convolution hierarchy over the word
embeddings, ViLBERT's co-attention encoder and the dual-stream head.

Counterpart of ``openvivqa_tpu/models/hierarchical_co_attention.py``, with its
own model-local ``HierarchicalFeaturesExtractor`` (not the registered text
embedding of that name): the unigram stream plus, for each level 1 .. max(n) - 1,
the level's windows summed over the ragged range [max(0, i - level), min(i,
L_level - 1)] at each unigram position i, as a difference of cumulative sums.
No reference converter reads this model; the port names it like MCAN, with
``hierarchical.convs.N`` for the convolutions.
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
from .common import DualStreamClassifier, total_answers_of
from .modules.text_embeddings import conv_windows


class HierarchicalFeaturesExtractor(nn.Module):
    def __init__(self, config, d_in: int):
        super().__init__()
        self.ngrams = [int(n) for n in config.N_GRAMS]
        self.convs = nn.ModuleList(nn.Conv1d(d_in, config.D_MODEL, n) for n in self.ngrams)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        length = features.shape[1]
        levels = [conv_windows(conv, features) for conv in self.convs]
        out = levels[0]
        idx = torch.arange(length, device=features.device)
        for level in range(1, min(max(self.ngrams), len(levels))):
            feats = levels[level]
            csum = torch.cat([torch.zeros_like(feats[:, :1]), feats.cumsum(dim=1)], dim=1)
            hi = torch.clamp(idx, max=feats.shape[1] - 1) + 1
            lo = torch.clamp(idx - level, min=0)
            out = out + (csum[:, hi] - csum[:, lo])
        return out


@META_ARCHITECTURE.register()
class HierarchicalCoAttention(DualStreamClassifier, ClassificationModel):
    def __init__(self, config, vocab):
        super().__init__()
        self.vision_embedding = build_vision_embedding(config.VISION_EMBEDDING)
        self.text_embedding = build_text_embedding(config.TEXT_EMBEDDING, vocab)
        self.hierarchical = HierarchicalFeaturesExtractor(config.HIERARCHICAL,
                                                          config.TEXT_EMBEDDING.D_MODEL)
        self.encoder = build_encoder(config.ENCODER)
        self.build_classifier(config, total_answers_of(vocab))

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        vision_features, vision_bias = self.vision_embedding(batch["region_features"], generator)
        text_features, (text_bias, _) = self.text_embedding(batch["question_tokens"], generator)
        text_features = self.hierarchical(text_features)
        # the unigram stream keeps the question's length, and its bias with it
        vision_features, text_features = self.encoder(
            vision_features, vision_bias, text_features, text_bias[..., : text_features.shape[1]],
            generator)
        logits = self.classify_streams(vision_features, text_features, generator)
        return torch.log_softmax(logits, dim=-1)
