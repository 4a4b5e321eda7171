"""SAAA, Show, Ask, Attend, and Answer, with its classification head.

Counterpart of ``openvivqa_tpu/models/saaa.py`` (CoAttention and SAAA), under
the reference's parameter names (``vision``, ``text``, ``attention.v_conv``,
``attention.q_lin``, ``attention.x_conv``, ``classifier.lin1``,
``classifier.lin2``; ``torch_conversion.convert_saaa`` reads them).  As in the
JAX package the question is pooled to its last unpadded step, and the regions
are l2-normalised over the region axis before the two glimpses.  No attention
core: the model runs on linears, an LSTM and softmaxes only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..builders import META_ARCHITECTURE, build_text_embedding, build_vision_embedding
from .base import BatchTensors, ClassificationModel
from .common import total_answers_of
from .modules.bert import dropout

CLASSIFIER_WIDTH = 1024
CLASSIFIER_DROPOUT = 0.5


class CoAttention(nn.Module):
    """The glimpse logits (bs, R, glimpses) of the regions under the question."""

    def __init__(self, config, d_vision: int, d_language: int):
        super().__init__()
        self.dropout = config.DROPOUT
        self.v_conv = nn.Linear(d_vision, config.D_MODEL, bias=False)
        self.q_lin = nn.Linear(d_language, config.D_MODEL)
        self.x_conv = nn.Linear(config.D_MODEL, config.GLIMPSES)

    def forward(self, v, q, generator=None) -> torch.Tensor:
        v_proj = self.v_conv(dropout(v, self.dropout, generator))
        q_proj = self.q_lin(dropout(q, self.dropout, generator))
        x = dropout(F.relu(v_proj + q_proj[:, None, :]), self.dropout, generator)
        return self.x_conv(x)


class Classifier(nn.Module):
    def __init__(self, d_in: int, n_answers: int):
        super().__init__()
        self.lin1 = nn.Linear(d_in, CLASSIFIER_WIDTH)
        self.lin2 = nn.Linear(CLASSIFIER_WIDTH, n_answers)

    def forward(self, x, generator=None) -> torch.Tensor:
        hidden = F.relu(self.lin1(dropout(x, CLASSIFIER_DROPOUT, generator)))
        return self.lin2(dropout(hidden, CLASSIFIER_DROPOUT, generator))


@META_ARCHITECTURE.register()
class SAAA(ClassificationModel):
    def __init__(self, config, vocab):
        super().__init__()
        self.padding_idx = vocab.padding_idx
        d_vision, d_language = config.VISION_PROCESSOR.D_MODEL, config.TEXT_PROCESSOR.D_MODEL
        self.vision = build_vision_embedding(config.VISION_PROCESSOR)
        self.text = build_text_embedding(config.TEXT_PROCESSOR, vocab)
        self.attention = CoAttention(config.ATTENTION, d_vision, d_language)
        glimpses = config.ATTENTION.GLIMPSES
        self.classifier = Classifier(glimpses * d_vision + d_language, total_answers_of(vocab))

    def _pool_question(self, q_seq: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Each row's state at its last unpadded token."""
        lengths = (tokens != self.padding_idx).sum(dim=-1)
        last = (lengths - 1).clamp(0, q_seq.shape[1] - 1)
        return q_seq[torch.arange(q_seq.shape[0], device=q_seq.device), last]

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        tokens = batch["question_tokens"]
        v, _ = self.vision(batch["region_features"], generator)
        q_seq, _ = self.text(tokens, generator)
        q = self._pool_question(q_seq, tokens)
        v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-8)
        weights = torch.softmax(self.attention(v, q, generator), dim=1)  # (bs, R, g)
        pooled = torch.einsum("brg,brd->bgd", weights, v).reshape(v.shape[0], -1)
        logits = self.classifier(torch.cat([pooled, q], dim=1), generator)
        return torch.log_softmax(logits, dim=-1)
