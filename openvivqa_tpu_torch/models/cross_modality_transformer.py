"""CrossModalityTransformer (LXMERT-style) and VisiolinguisticTransformer
(ViLBERT-style), each in the mode its config asks for.

Counterpart of ``openvivqa_tpu/models/cross_modality_transformer.py``.  Without
a DECODER section the model is a classifier (configs/cross_modality_transformer.yaml
and visiolinguistic_transformer.yaml under ClassificationTask): the region
stream and the question through the dual-stream encoder, then the dual-stream
head and a log-softmax.  With one it is a generator (the VLSP configs under
VlspEvjVqaTask): region + box and grid + box streams against the question
through the encoder, both streams concatenated, fused by an FFN (4 x d_model
wide when MULTIMODAL_FUSION is absent) and a LayerNorm, then the decoder.  The
classifier builds no grid, box, fusion or norm module, the generator no head.
The encoder is the config's: ``CrossModalityEncoder`` or ``CoAttentionEncoder``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..builders import (
    META_ARCHITECTURE,
    build_decoder,
    build_encoder,
    build_text_embedding,
    build_vision_embedding,
)
from ..config import ConfigNode
from .base import BatchTensors, GenerativeModel, init_xavier_law_
from .common import (
    REGION_GRID_BOX_INPUTS,
    DualStreamClassifier,
    region_grid_stream,
    total_answers_of,
)
from .modules.ffn import LN_EPS, PositionWiseFeedForward


class _DualStreamVQAModel(DualStreamClassifier, GenerativeModel):
    FEATURE_INPUTS = REGION_GRID_BOX_INPUTS  # the classifier builds the region embedding only

    def __init__(self, config, vocab):
        super().__init__()
        self.vocab = vocab
        self.d_model = config.get("D_MODEL", 512)
        self.generative = config.get("DECODER") is not None
        self.text_embedding = build_text_embedding(config.TEXT_EMBEDDING, vocab)
        self.encoder = build_encoder(config.ENCODER)
        self.region_embedding = build_vision_embedding(config.REGION_EMBEDDING)
        if not self.generative:
            self.build_classifier(config, total_answers_of(vocab))
            return
        self.grid_embedding = build_vision_embedding(config.GRID_EMBEDDING)
        self.box_embedding = build_vision_embedding(config.BOX_EMBEDDING)
        fusion = config.get("MULTIMODAL_FUSION") or ConfigNode(
            {"D_MODEL": self.d_model, "D_FF": 4 * self.d_model, "DROPOUT": 0.1})
        self.fusion = PositionWiseFeedForward(fusion)
        self.norm = nn.LayerNorm(self.d_model, eps=LN_EPS)
        self.decoder = build_decoder(config.DECODER, vocab=vocab)

    def init_weights_(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers for this model (``init_xavier_law_``)."""
        init_xavier_law_(self, generator)

    def _streams(self, batch: BatchTensors, generator=None):
        """The encoded (vision, language) streams and their padding biases."""
        if self.generative:
            vision, vision_bias = region_grid_stream(self, batch, generator)
        else:
            vision, vision_bias = self.region_embedding(batch["region_features"], generator)
        text, (text_bias, _) = self.text_embedding(batch["question_tokens"], generator)
        vision, text = self.encoder(vision, vision_bias, text, text_bias, generator)
        return vision, vision_bias, text, text_bias

    def encode(self, batch: BatchTensors, generator=None):
        vision, vision_bias, text, text_bias = self._streams(batch, generator)
        fused = self.norm(self.fusion(torch.cat([vision, text], dim=1), generator))
        return fused, torch.cat([vision_bias, text_bias], dim=-1)

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        if self.generative:
            encoder_features, encoder_bias = self.encode(batch, generator)
            return self.decoder(batch["answer_tokens"], encoder_features, encoder_bias,
                                generator)
        vision, _, text, _ = self._streams(batch, generator)
        return torch.log_softmax(self.classify_streams(vision, text, generator), dim=-1)


@META_ARCHITECTURE.register()
class CrossModalityTransformer(_DualStreamVQAModel):
    pass


@META_ARCHITECTURE.register()
class VisiolinguisticTransformer(_DualStreamVQAModel):
    pass
