"""Text embeddings.

Counterpart of ``UsualEmbedding`` in
``openvivqa_tpu/models/modules/text_embeddings.py``, under the reference's
parameter names (``components.weight``, or ``components.1`` for the projection
of frozen pretrained vectors).  The LSTM, dynamic and OCR embeddings wait for
the models that use them.  Every embedding returns
``(features, (padding_bias, causal_bias))`` with additive 0 / MASK_VALUE biases.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...builders import META_TEXT_EMBEDDING
from .bert import dropout
from .masks import causal_bias, padding_bias


@META_TEXT_EMBEDDING.register()
class UsualEmbedding(nn.Module):
    """A learned table whose padding row reads as zero at every forward, or,
    with TEXT_EMBEDDING.WORD_EMBEDDING set, the vocab's frozen pretrained
    vectors under a learned projection and dropout."""

    def __init__(self, config, vocab):
        super().__init__()
        self.padding_idx = vocab.padding_idx
        self.dropout = config.DROPOUT
        self.pretrained = config.get("WORD_EMBEDDING") is not None
        if not self.pretrained:
            self.components = nn.Embedding(len(vocab), config.D_MODEL)
            return
        if vocab.word_embeddings is None:
            raise ValueError(
                "TEXT_EMBEDDING.WORD_EMBEDDING is set but the vocab has no word_embeddings "
                "loaded (a vocab cache pickled before WORD_EMBEDDING was configured? rebuild "
                "it, or align the vocab config's WORD_EMBEDDING)"
            )
        vectors = torch.as_tensor(vocab.word_embeddings, dtype=torch.float32)
        self.register_buffer("word_vectors", vectors, persistent=False)
        self.components = nn.ModuleDict({"1": nn.Linear(vectors.shape[1], config.D_MODEL)})

    def forward(self, tokens: torch.Tensor, generator=None):
        tokens = tokens.long()
        masks = (padding_bias(tokens, self.padding_idx),
                 causal_bias(tokens.shape[-1], tokens.device))
        if self.pretrained:
            features = self.components["1"](F.embedding(tokens, self.word_vectors))
            return dropout(features, self.dropout, generator), masks
        features = self.components(tokens) * (tokens != self.padding_idx)[..., None]
        return features, masks
