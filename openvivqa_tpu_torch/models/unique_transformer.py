"""UniqueTransformer: a single-stream prefix LM over the tagged modality streams,
the question and the answer, read off the answer positions.

Counterpart of ``openvivqa_tpu/models/unique_transformer.py``.  The streams are
JointTransformer's (``ModalityStreams``), whose text embedding also embeds the
answers.  Training runs ``[joint | answers]`` through one ``MultiModalEncoder``
under ``prefix_lm_bias`` (every row attends each column by its padding, the
answer block is causal and padded), then ``fc`` (no bias) on the answer rows.
The config's DECODER section is not built.  Decoding keeps the generated tokens
in a (rows, max_len) buffer in the decode cache, which beam search reorders, and
re-runs the whole encoder over ``[prefix | buffer]`` at every step with the
columns not yet generated masked, reading row ``joint_len + step``; the step
index is a Python int.  Parameter names: the streams' embeddings at the top
(``region_embedding.proj`` ..., ``text_embedding.components``), ``encoder``,
``fc``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..builders import META_ARCHITECTURE, build_encoder
from .base import BatchTensors, GenerativeModel, init_xavier_law_
from .common import REGION_GRID_BOX_INPUTS
from .joint_transformer import ModalityStreams
from .modules.masks import MASK_VALUE, causal_bias, combine_biases, padding_bias, prefix_lm_bias


@META_ARCHITECTURE.register()
class UniqueTransformer(ModalityStreams, GenerativeModel):
    FEATURE_INPUTS = REGION_GRID_BOX_INPUTS

    def __init__(self, config, vocab):
        super().__init__()
        self.vocab = vocab
        self._build_streams(config, vocab)
        self.encoder = build_encoder(config.ENCODER)
        self.fc = nn.Linear(config.D_MODEL, len(vocab), bias=False)

    def init_weights_(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers for this model (``init_xavier_law_``)."""
        init_xavier_law_(self, generator)

    def _answer_logprobs(self, prefix, prefix_bias, answer_features, answer_col, answer_block,
                         generator=None) -> torch.Tensor:
        """The encoder over [prefix | answers] under the prefix-LM bias; the
        log-probs of every answer row."""
        out = self.encoder(torch.cat([prefix, answer_features], dim=1),
                           prefix_lm_bias(prefix_bias, answer_col, answer_block), generator)
        return torch.log_softmax(self.fc(out[:, prefix.shape[1]:]), dim=-1)

    def decode_teacher_forced(self, tokens, encoder_features, encoder_attention_bias,
                              generator=None) -> torch.Tensor:
        """Log-probs of given answer tokens after an ``encode()`` prefix: the
        training layout with answer_tokens := tokens."""
        answer_features, (answer_pad, _) = self.text_embedding(tokens, generator)
        answer_block = combine_biases(answer_pad, causal_bias(tokens.shape[1], tokens.device))
        return self._answer_logprobs(encoder_features, encoder_attention_bias, answer_features,
                                     answer_pad, answer_block, generator)

    def encode(self, batch: BatchTensors, generator=None):
        """The joint prefix before the encoder, and its padding bias."""
        return self.streams(batch, generator)

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        joint, joint_bias = self.streams(batch, generator)
        return self.decode_teacher_forced(batch["answer_tokens"], joint, joint_bias, generator)

    # -- the decode interface ----------------------------------------------------------
    def prepare_decode(self, encoder_features, encoder_attention_bias) -> Dict:
        return {"joint": encoder_features, "bias": encoder_attention_bias}

    def init_decode_cache(self, rows: int, device) -> Dict:
        return {"tokens": torch.zeros((rows, self.max_generation_length), dtype=torch.long,
                                      device=device),
                "step": 0}

    def decode_step(self, token: torch.Tensor, cache: Dict, prep: Dict) -> torch.Tensor:
        """Log-probs (rows, 1, V) of the next token after `token` (rows, 1);
        writes `cache` in place."""
        i = cache["step"]
        buffer = cache["tokens"]
        buffer[:, i] = token[:, 0]
        cache["step"] = i + 1
        max_len = buffer.shape[1]
        answer_features, _ = self.text_embedding(buffer)
        positions = torch.arange(max_len, device=buffer.device)
        generated = torch.where(positions <= i, 0.0, MASK_VALUE)[None, None, None, :]
        answer_col = combine_biases(padding_bias(buffer, self.vocab.padding_idx), generated)
        answer_block = combine_biases(answer_col, causal_bias(max_len, buffer.device))
        logprobs = self._answer_logprobs(prep["joint"], prep["bias"], answer_features,
                                         answer_col, answer_block)
        return logprobs[:, i:i + 1]
