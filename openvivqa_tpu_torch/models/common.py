"""The classification heads shared by the MCAN family: attention-reduce
pooling and the fused dual-stream classifier; and the region + box, grid + box
vision stream of the VLSP generators.

Counterpart of ``openvivqa_tpu/models/common.py``, under the reference's
parameter names (``fc1`` / ``fc2`` of each reduce MLP; ``vision_proj``,
``text_proj``, ``layer_norm`` and ``classify`` of the fused head).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .modules.bert import dropout
from .modules.ffn import LN_EPS


class AttentionReduceMLP(nn.Module):
    """Linear, ReLU, dropout, Linear(1): per-token pooling logits."""

    def __init__(self, config, d_in: int):
        super().__init__()
        self.dropout = config.DROPOUT
        self.fc1 = nn.Linear(d_in, config.D_MODEL)
        self.fc2 = nn.Linear(config.D_MODEL, 1)

    def forward(self, features: torch.Tensor, generator=None) -> torch.Tensor:
        return self.fc2(dropout(F.relu(self.fc1(features)), self.dropout, generator))


def attention_pool(features: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """softmax over the tokens of `logits` (bs, L, 1), then the weighted sum of
    `features` (bs, L, d).  No mask: padded tokens take part, as in the
    reference."""
    return (features * torch.softmax(logits, dim=1)).sum(dim=1)


def total_answers_of(vocab) -> int:
    """The classifier's width; a token vocab (no class table) gives its length."""
    return getattr(vocab, "total_answers", None) or len(vocab)


class DualStreamClassifier:
    """Mixin: each stream attention-pooled, both projected and summed,
    LayerNorm, then the classifier (logits, before the log-softmax).  Its
    modules sit on the model itself, under the reference MCAN's names."""

    def build_classifier(self, config, n_answers: int) -> None:
        d_model = config.D_MODEL
        self.vision_attr_reduce = AttentionReduceMLP(config.VISION_ATTR_REDUCE, d_model)
        self.text_attr_reduce = AttentionReduceMLP(config.TEXT_ATTR_REDUCE, d_model)
        self.vision_proj = nn.Linear(d_model, d_model)
        self.text_proj = nn.Linear(d_model, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.classify = nn.Linear(d_model, n_answers)

    def classify_streams(self, vision_features, text_features, generator=None) -> torch.Tensor:
        pooled_v = attention_pool(vision_features,
                                  self.vision_attr_reduce(vision_features, generator))
        pooled_t = attention_pool(text_features, self.text_attr_reduce(text_features, generator))
        return self.classify(self.layer_norm(self.vision_proj(pooled_v)
                                             + self.text_proj(pooled_t)))


# the input widths flax infers from the data, for the models that build
# REGION_EMBEDDING, GRID_EMBEDDING and BOX_EMBEDDING (``builders.build_model``)
REGION_GRID_BOX_INPUTS = {"REGION_EMBEDDING": ("region_features",),
                          "GRID_EMBEDDING": ("grid_features",),
                          "BOX_EMBEDDING": ("region_boxes",)}


def region_grid_stream(model, batch, generator=None):
    """[regions + their boxes | grids + their boxes] through the model's
    region, grid and box embeddings (one box embedding serves both), and the
    concatenated padding bias."""
    region, region_bias = model.region_embedding(batch["region_features"], generator)
    region = region + model.box_embedding(batch["region_boxes"], generator)[0]
    grid, grid_bias = model.grid_embedding(batch["grid_features"], generator)
    grid = grid + model.box_embedding(batch["grid_boxes"], generator)[0]
    return torch.cat([region, grid], dim=1), torch.cat([region_bias, grid_bias], dim=-1)
