"""JointTransformer: region, region-box, grid, grid-box and question streams in
one self-attention encoder, under the transformer decoder.

Counterpart of ``openvivqa_tpu/models/joint_transformer.py``.  Each stream is
embedded and tagged with the text embedding of its modality's special token
(``<feat>`` for features, ``<box>`` for boxes, ``<question>`` for the question);
the streams and their padding biases are concatenated in that order, the
``Encoder`` runs over the joint stream and the ``Decoder`` generates the
answer.  Parameter names are the reference's (``region_embedding.proj``,
``grid_embedding.proj``, ``box_embedding.proj``, ``text_embedding.components``,
``encoder.layers.N``, ``decoder``), so ``torch_conversion.convert_joint_transformer``
reads the port's state dict.
"""

from __future__ import annotations

import torch

from ..builders import (
    META_ARCHITECTURE,
    build_decoder,
    build_encoder,
    build_text_embedding,
    build_vision_embedding,
)
from .base import BatchTensors, GenerativeModel, init_xavier_law_


class ModalityStreams:
    """The five tagged modality streams, as a mixin whose embeddings sit at
    the top of the model's parameter names (the box embedding serves both box
    streams)."""

    def _build_streams(self, config, vocab) -> None:
        self.region_embedding = build_vision_embedding(config.REGION_EMBEDDING)
        self.grid_embedding = build_vision_embedding(config.GRID_EMBEDDING)
        self.box_embedding = build_vision_embedding(config.BOX_EMBEDDING)
        self.text_embedding = build_text_embedding(config.TEXT_EMBEDDING, vocab)

    def _tag(self, features: torch.Tensor, token_idx: int, generator) -> torch.Tensor:
        tokens = torch.full(features.shape[:2], token_idx, dtype=torch.long,
                            device=features.device)
        tag, _ = self.text_embedding(tokens, generator)
        return features + tag

    def streams(self, batch: BatchTensors, generator=None):
        """(joint features (bs, L, d_model), joint padding bias (bs, 1, 1, L))."""
        v = self.vocab
        parts = []
        for embedding, key, token in (
            (self.region_embedding, "region_features", v.feat_idx),
            (self.box_embedding, "region_boxes", v.box_idx),
            (self.grid_embedding, "grid_features", v.feat_idx),
            (self.box_embedding, "grid_boxes", v.box_idx),
        ):
            features, bias = embedding(batch[key], generator)
            parts.append((self._tag(features, token, generator), bias))
        question, (question_bias, _) = self.text_embedding(batch["question_tokens"], generator)
        parts.append((self._tag(question, v.question_idx, generator), question_bias))
        return (torch.cat([features for features, _ in parts], dim=1),
                torch.cat([bias for _, bias in parts], dim=-1))


@META_ARCHITECTURE.register()
class JointTransformer(ModalityStreams, GenerativeModel):
    def __init__(self, config, vocab):
        super().__init__()
        self.vocab = vocab
        self._build_streams(config, vocab)
        self.encoder = build_encoder(config.ENCODER)
        self.decoder = build_decoder(config.DECODER, vocab=vocab)

    def init_weights_(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers for this model (``init_xavier_law_``)."""
        init_xavier_law_(self, generator)

    def encode(self, batch: BatchTensors, generator=None):
        joint, joint_bias = self.streams(batch, generator)
        return self.encoder(joint, joint_bias, generator), joint_bias

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        encoder_features, encoder_bias = self.encode(batch, generator)
        return self.decoder(batch["answer_tokens"], encoder_features, encoder_bias, generator)
