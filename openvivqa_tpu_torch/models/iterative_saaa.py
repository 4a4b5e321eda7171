"""IterativeSAAA: SAAA's encoder (an LSTM question state and glimpse attention
over the regions) under a transformer decoder.

Counterpart of ``openvivqa_tpu/models/iterative_saaa.py``.  ``TextProcessor``
embeds the question (the padding row of its table read as zero at every call),
applies dropout then tanh, runs a one-layer LSTM over the whole padded sequence
(not packed) and returns the final *cell* state.  The regions are
l2-normalised over the region axis (plus 1e-8); the glimpse logits of saaa's
``CoAttention`` are softmaxed over the regions and summed over the glimpses,
and scale each region.  [regions | question state] are fused by an FFN, the
padded positions zeroed, then a LayerNorm, and the decoder (one layer in
configs/iterative_saaa.yaml) generates.  The question state's padding bias is
``padding_bias`` of the cell state itself, as in the JAX package.  flax's LSTM
cell has one bias, ``bias_hh_l0`` here; ``bias_ih_l0`` is held out of training
(zero unless a checkpoint sets it).  Parameter names: ``vision.proj``,
``text.embedding``, ``text.lstm``, ``attention.{v_conv,q_lin,x_conv}``,
``fusion``, ``norm``, ``decoder``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..builders import META_ARCHITECTURE, build_decoder, build_vision_embedding
from .base import BatchTensors, GenerativeModel, init_xavier_law_
from .modules.bert import dropout
from .modules.ffn import LN_EPS, PositionWiseFeedForward
from .modules.masks import padding_bias
from .saaa import CoAttention


class TextProcessor(nn.Module):
    """Embed, dropout, tanh, LSTM; returns the final cell state (bs, D_MODEL)."""

    def __init__(self, config, vocab):
        super().__init__()
        self.padding_idx = vocab.padding_idx
        self.dropout = config.DROPOUT
        self.embedding = nn.Embedding(len(vocab), config.D_EMBEDDING)
        self.lstm = nn.LSTM(config.D_EMBEDDING, config.D_MODEL, batch_first=True)
        self.lstm.bias_ih_l0.requires_grad_(False)

    def forward(self, tokens: torch.Tensor, generator=None) -> torch.Tensor:
        tokens = tokens.long()
        embedded = self.embedding(tokens) * (tokens != self.padding_idx)[..., None]
        embedded = torch.tanh(dropout(embedded, self.dropout, generator))
        _, (_, cell) = self.lstm(embedded.contiguous())
        return cell[0]


@META_ARCHITECTURE.register()
class IterativeSAAA(GenerativeModel):
    FEATURE_INPUTS = {"VISION_PROCESSOR": ("region_features",)}

    def __init__(self, config, vocab):
        super().__init__()
        self.vocab = vocab
        self.vision = build_vision_embedding(config.VISION_PROCESSOR)
        self.text = TextProcessor(config.TEXT_PROCESSOR, vocab)
        self.attention = CoAttention(config.ATTENTION, config.VISION_PROCESSOR.D_MODEL,
                                     config.TEXT_PROCESSOR.D_MODEL)
        self.fusion = PositionWiseFeedForward(config.MULTIMODAL_FUSION)
        self.norm = nn.LayerNorm(config.D_MODEL, eps=LN_EPS)
        self.decoder = build_decoder(config.DECODER, vocab=vocab)

    def init_weights_(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers (``init_xavier_law_``), the question
        table Xavier-uniform as flax draws it."""
        init_xavier_law_(self, generator)
        table = self.text.embedding.weight
        bound = (6.0 / (table.shape[0] + table.shape[1])) ** 0.5
        with torch.no_grad():
            table.copy_((2.0 * torch.rand(table.shape, generator=generator) - 1.0) * bound)

    def encode(self, batch: BatchTensors, generator=None):
        v, v_bias = self.vision(batch["region_features"], generator)
        q = self.text(batch["question_tokens"], generator)
        q_bias = padding_bias(q[:, None, :], self.vocab.padding_idx)
        v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-8)
        glimpses = self.attention(v, q, generator)  # (bs, R, glimpses)
        v = v * torch.softmax(glimpses, dim=1).sum(dim=-1)[..., None]
        combined = self.fusion(torch.cat([v, q[:, None, :]], dim=1), generator)
        combined_bias = torch.cat([v_bias, q_bias], dim=-1)
        keep = (combined_bias[:, 0, 0, :] == 0)[..., None]
        return self.norm(combined * keep), combined_bias

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        encoder_features, encoder_bias = self.encode(batch, generator)
        return self.decoder(batch["answer_tokens"], encoder_features, encoder_bias, generator)
