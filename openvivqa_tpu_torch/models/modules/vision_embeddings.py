"""Vision embeddings.

Counterpart of ``FeatureEmbedding`` in
``openvivqa_tpu/models/modules/vision_embeddings.py`` (parameter ``proj``, the
reference's name).  The object + OCR embedding waits for the models that use it.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ...builders import META_VISION_EMBEDDING
from .bert import dropout
from .masks import padding_bias


@META_VISION_EMBEDDING.register()
class FeatureEmbedding(nn.Module):
    """Linear + exact-erf GELU + dropout over region or grid features; an
    all-zero feature row is padding.  Returns (features, padding_bias)."""

    def __init__(self, config):
        super().__init__()
        self.dropout = config.DROPOUT
        self.proj = nn.Linear(config.D_FEATURE, config.D_MODEL)

    def forward(self, features, generator=None):
        masks = padding_bias(features, padding_idx=0)
        out = dropout(F.gelu(self.proj(features)), self.dropout, generator)
        return out, masks
