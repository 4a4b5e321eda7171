"""ViT-backed generative models: a frozen ViT over the image and a frozen
pretrained text encoder over the question, fused, under a transformer decoder.

Counterpart of ``_vision_input``, ``_question_input``, ``ViTmBERTGeneration``
and ``ViTmT5`` in ``openvivqa_tpu/models/vit_models.py``.  ViTmT5 (configs/
vit_mt5.yaml) is ViT-base pixels + the mT5-small encoder, concatenated along
the sequence, through a plain Linear fusion (no GELU, no dropout) into the
decoder, whose cross-attention spans 197 + question-length keys.
ViTmBERTGeneration has a GELU and dropout after its fusion; its BERT-family
text wrappers, ``ViTmBERTClassification``, ``ExtendedMCAN`` and
``ReadableIterativeMCAN`` wait for their slice (ROADMAP).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..builders import (
    META_ARCHITECTURE,
    build_decoder,
    build_text_embedding,
    build_vision_embedding,
)
from .base import BatchTensors, GenerativeModel, init_xavier_law_
from .modules.bert import dropout

# the BERT-family text wrappers (pretrained_embeddings.py), not ported yet
_UNPORTED_TEXT = ("BertEmbedding", "RobertaEmbedding", "XLMRobertaEmbedding",
                  "AlbertEmbedding", "DebertaEmbedding")


def _vision_input(batch: BatchTensors) -> torch.Tensor:
    """Raw pixels when the batch has them, else grid features."""
    if "pixel_values" in batch:
        return batch["pixel_values"]
    return batch["grid_features"]


def _question_input(batch: BatchTensors, text_config):
    """(tokens, padding_idx or None, padding_mask or None): a pretrained
    tokenizer's ids and validity mask when the batch has them, else the vocab's
    ``question_tokens``."""
    if "question_backbone_tokens" in batch:
        pad = int(text_config.get("PRETRAINED_PAD_ID") or 0)
        return batch["question_backbone_tokens"], pad, batch.get("question_backbone_mask")
    return batch["question_tokens"], None, None


@META_ARCHITECTURE.register()
class ViTmBERTGeneration(GenerativeModel):
    """Vision embedding + pretrained text embedding, concatenated, fused by
    Linear + GELU + dropout, then the decoder."""

    def __init__(self, config, vocab):
        super().__init__()
        name = config.TEXT_EMBEDDING.ARCHITECTURE
        if name in _UNPORTED_TEXT:
            raise NotImplementedError(
                f"TEXT_EMBEDDING {name} is not ported yet (ROADMAP queue 1, slice 5)")
        self.vocab = vocab
        self.config = config
        self.dropout = config.DROPOUT
        self.vision_encoder = build_vision_embedding(config.VISION_EMBEDDING)
        self.text_embedding = build_text_embedding(config.TEXT_EMBEDDING, vocab)
        self.fusion = nn.Linear(config.D_MODEL, config.D_MODEL)
        self.decoder = build_decoder(config.DECODER, vocab=vocab)

    def init_weights_(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers, drawn from `generator`: the
        backbones' own laws first, then Xavier-uniform Linear weights, zero
        biases, N(0, 1) embedding tables and unit LayerNorms for the rest, in
        module order."""
        backbones = [m.backbone for m in (self.vision_encoder, self.text_embedding)
                     if hasattr(m, "backbone")]
        for backbone in backbones:
            backbone.init_weights_(generator)
        init_xavier_law_(self, generator, skip=backbones)

    def _text(self, batch: BatchTensors, generator=None):
        tokens, pad, mask = _question_input(batch, self.config.TEXT_EMBEDDING)
        features, masks = self.text_embedding(tokens, generator, padding_idx=pad,
                                              padding_mask=mask)
        return features, masks[0] if isinstance(masks, tuple) else masks

    def _fuse(self, fused, generator=None):
        return dropout(F.gelu(self.fusion(fused)), self.dropout, generator)

    def encode(self, batch: BatchTensors, generator=None):
        vision_features, vision_bias = self.vision_encoder(_vision_input(batch), generator)
        text_features, text_bias = self._text(batch, generator)
        fused = self._fuse(torch.cat([vision_features, text_features], dim=1), generator)
        return fused, torch.cat([vision_bias, text_bias], dim=-1)

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        encoder_features, encoder_bias = self.encode(batch, generator)
        return self.decoder(batch["answer_tokens"], encoder_features, encoder_bias, generator)


@META_ARCHITECTURE.register()
class ViTmT5(ViTmBERTGeneration):
    """The same skeleton with a T5 text embedding and a plain Linear fusion."""

    def _fuse(self, fused, generator=None):
        return self.fusion(fused)
