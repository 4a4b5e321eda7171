"""ViT-backed models: a frozen ViT over the image (or its pre-extracted
features) and a frozen pretrained text encoder over the question, fused, under
a classifier or a transformer decoder.

Counterpart of ``_vision_input``, ``_question_input``,
``ViTmBERTClassification``, ``ViTmBERTGeneration`` and ``ViTmT5`` in
``openvivqa_tpu/models/vit_models.py``.  ViTmBERTClassification
(configs/vit_mbert_classification.yaml) is ViT-base pixels + mBERT,
concatenated along the sequence, Linear(D_MODEL), dropout, a sum over every
token (padding included, as the JAX package sums), Linear(answers) and a
log-softmax.  ViTmBERTGeneration (configs/vit_mbert_generation.yaml) fuses ViT
grid features and mBERT by Linear + GELU + dropout into the decoder; ViTmT5
(configs/vit_mt5.yaml) is ViT-base pixels + the mT5-small encoder through a
plain Linear fusion (no GELU, no dropout), the decoder's cross-attention over
197 + question-length keys.  Any registered text embedding may stand in for
mBERT (``AlbertEmbedding``, ``DebertaEmbedding``, ...).

The module also holds the JAX file's two MCAN-family generators: ``ExtendedMCAN``
(region + box and grid + box streams through MCAN's guided encoder against the
self-encoded question, fused, under the decoder; extended_mcan_vlsp.yaml) and
``ReadableIterativeMCAN`` (IterativeMCAN whose vision stream is the object +
OCR ``VisionOcrEmbedding``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..builders import (
    META_ARCHITECTURE,
    build_decoder,
    build_encoder,
    build_text_embedding,
    build_vision_embedding,
)
from .base import BatchTensors, ClassificationModel, GenerativeModel, init_xavier_law_
from .common import REGION_GRID_BOX_INPUTS, region_grid_stream, total_answers_of
from .iterative_mcan import IterativeMCAN
from .modules.bert import dropout
from .modules.ffn import LN_EPS, PositionWiseFeedForward

def _init_with_backbones_(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisers, drawn from `generator`: the backbones'
    own laws first, then Xavier-uniform Linear weights, zero biases, N(0, 1)
    embedding tables and unit LayerNorms for the rest, in module order."""
    backbones = [m.backbone for m in (model.vision_encoder, model.text_embedding)
                 if hasattr(m, "backbone")]
    for backbone in backbones:
        backbone.init_weights_(generator)
    init_xavier_law_(model, generator, skip=backbones)


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


def _text_features(model, batch: BatchTensors, generator=None):
    """The text embedding over the batch's question ids: (features, bias)."""
    tokens, pad, mask = _question_input(batch, model.config.TEXT_EMBEDDING)
    features, masks = model.text_embedding(tokens, generator, padding_idx=pad,
                                            padding_mask=mask)
    return features, masks[0] if isinstance(masks, tuple) else masks


@META_ARCHITECTURE.register()
class ViTmBERTClassification(ClassificationModel):
    """ViT and pretrained text features concatenated along the sequence,
    Linear(D_MODEL), dropout, summed over every token, padding included (as
    the JAX package sums), Linear(answers), log-softmax."""

    def __init__(self, config, vocab):
        super().__init__()
        self.vocab = vocab
        self.config = config
        self.dropout = config.DROPOUT
        self.vision_encoder = build_vision_embedding(config.VISION_EMBEDDING)
        self.text_embedding = build_text_embedding(config.TEXT_EMBEDDING, vocab)
        self.fusion = nn.Linear(config.D_MODEL, config.D_MODEL)
        self.classify = nn.Linear(config.D_MODEL, total_answers_of(vocab))

    def init_weights_(self, generator: torch.Generator) -> None:
        _init_with_backbones_(self, generator)

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        vision_features, _ = self.vision_encoder(_vision_input(batch), generator)
        text_features, _ = _text_features(self, batch, generator)
        fused = self.fusion(torch.cat([vision_features, text_features], dim=1))
        pooled = dropout(fused, self.dropout, generator).sum(dim=1)
        return torch.log_softmax(self.classify(pooled), dim=-1)


@META_ARCHITECTURE.register()
class ViTmBERTGeneration(GenerativeModel):
    """Vision embedding + pretrained text embedding, concatenated, fused by
    Linear + GELU + dropout, then the decoder."""

    def __init__(self, config, vocab):
        super().__init__()
        self.vocab = vocab
        self.config = config
        self.dropout = config.DROPOUT
        self.vision_encoder = build_vision_embedding(config.VISION_EMBEDDING)
        self.text_embedding = build_text_embedding(config.TEXT_EMBEDDING, vocab)
        self.fusion = nn.Linear(config.D_MODEL, config.D_MODEL)
        self.decoder = build_decoder(config.DECODER, vocab=vocab)

    def init_weights_(self, generator: torch.Generator) -> None:
        _init_with_backbones_(self, generator)

    def _fuse(self, fused, generator=None):
        return dropout(F.gelu(self.fusion(fused)), self.dropout, generator)

    def encode(self, batch: BatchTensors, generator=None):
        vision_features, vision_bias = self.vision_encoder(_vision_input(batch), generator)
        text_features, text_bias = _text_features(self, batch, generator)
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


@META_ARCHITECTURE.register()
class ExtendedMCAN(GenerativeModel):
    """Region + box and grid + box streams, the question through SELF_ENCODER,
    the vision stream through GUIDED_ENCODER against it, both concatenated,
    fused by an FFN and a LayerNorm, then the decoder.  The width falls back to
    MULTIMODAL_FUSION.D_MODEL: extended_mcan_vlsp.yaml has no top-level
    D_MODEL."""

    FEATURE_INPUTS = REGION_GRID_BOX_INPUTS

    def __init__(self, config, vocab):
        super().__init__()
        self.vocab = vocab
        self.d_model = config.get("D_MODEL") or config.MULTIMODAL_FUSION.D_MODEL
        self.region_embedding = build_vision_embedding(config.REGION_EMBEDDING)
        self.grid_embedding = build_vision_embedding(config.GRID_EMBEDDING)
        self.box_embedding = build_vision_embedding(config.BOX_EMBEDDING)
        self.text_embedding = build_text_embedding(config.TEXT_EMBEDDING, vocab)
        self.self_encoder = build_encoder(config.SELF_ENCODER)
        self.guided_encoder = build_encoder(config.GUIDED_ENCODER)
        self.fusion = PositionWiseFeedForward(config.MULTIMODAL_FUSION)
        self.norm = nn.LayerNorm(self.d_model, eps=LN_EPS)
        self.decoder = build_decoder(config.DECODER, vocab=vocab)

    def init_weights_(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers for this model (``init_xavier_law_``)."""
        init_xavier_law_(self, generator)

    def encode(self, batch: BatchTensors, generator=None):
        vision, vision_bias = region_grid_stream(self, batch, generator)
        text, (text_bias, _) = self.text_embedding(batch["question_tokens"], generator)
        text = self.self_encoder(text, text_bias, generator)
        vision = self.guided_encoder(vision, vision_bias, text, text_bias, generator)
        fused = self.norm(self.fusion(torch.cat([vision, text], dim=1), generator))
        return fused, torch.cat([vision_bias, text_bias], dim=-1)

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        encoder_features, encoder_bias = self.encode(batch, generator)
        return self.decoder(batch["answer_tokens"], encoder_features, encoder_bias, generator)


@META_ARCHITECTURE.register()
class ReadableIterativeMCAN(IterativeMCAN):
    """IterativeMCAN whose vision stream is ``VisionOcrEmbedding``'s objects
    and OCR tokens.  Its decoder's table and outputs cover the fixed vocab
    only: an OcrVocab copy id in the answers (len(vocab) + OCR slot) reads as
    <unk> (the task's loss counts such a target as <unk> too).  The JAX
    package looks such an id up out of range, which gives NaN."""

    FEATURE_INPUTS = {"VISION_EMBEDDING": {
        "D_OBJ_FEATURE": ("region_features",),
        "D_OCR_FEATURE": ("ocr_det_features", "ocr_rec_features", "ocr_fasttext_features")}}

    def _vision(self, batch: BatchTensors, generator=None):
        return self.vision_embedding(
            batch["region_features"], batch["region_boxes"], batch["ocr_det_features"],
            batch["ocr_rec_features"], batch["ocr_fasttext_features"], batch["ocr_boxes"],
            generator)

    def _in_vocab(self, tokens: torch.Tensor) -> torch.Tensor:
        return torch.where(tokens < len(self.vocab), tokens, self.vocab.unk_idx)

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        return super().forward({**batch, "answer_tokens": self._in_vocab(batch["answer_tokens"])},
                               generator)

    def decode_teacher_forced(self, tokens, encoder_features, encoder_attention_bias,
                              generator=None) -> torch.Tensor:
        return super().decode_teacher_forced(self._in_vocab(tokens), encoder_features,
                                             encoder_attention_bias, generator)
