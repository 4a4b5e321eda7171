"""Model base classes.

Counterpart of ``openvivqa_tpu/models/base.py``.  Models are ``nn.Module``s
taking a dict of batch tensors; a `generator` selects the training route, whose
dropout draws from it.  Decode state is explicit: ``training/decode.py`` carries
the cache through its loop and the invariants of ``prepare_decode`` beside it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

BatchTensors = Dict[str, torch.Tensor]


class ClassificationModel(nn.Module):
    """Answer-classification models: forward -> (bs, n_answers) log-probs."""

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        raise NotImplementedError


class GenerativeModel(nn.Module):
    """Encoder-decoder generative models, beam-searched at eval.

    forward        : teacher-forced log-probs (bs, L, V)
    encode         : (encoder_features, encoder_attention_bias)
    prepare_decode : what no decode step changes, once per generate
    init_decode_cache / decode_step : the single-token decode and its state
    """

    def forward(self, batch: BatchTensors, generator=None) -> torch.Tensor:
        raise NotImplementedError

    def encode(self, batch: BatchTensors,
               generator=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        raise NotImplementedError

    # the defaults delegate to a `decoder` submodule
    def prepare_decode(self, encoder_features, encoder_attention_bias) -> Dict:
        return self.decoder.prepare_decode(encoder_features, encoder_attention_bias)

    def init_decode_cache(self, rows: int, device) -> Dict:
        return self.decoder.init_cache(rows, device)

    def decode_step(self, token: torch.Tensor, cache: Dict, prep: Dict) -> torch.Tensor:
        return self.decoder.step(token, cache, prep)

    def decode_teacher_forced(self, tokens, encoder_features, encoder_attention_bias,
                              generator=None) -> torch.Tensor:
        """Full-sequence decode over given tokens."""
        return self.decoder(tokens, encoder_features, encoder_attention_bias, generator)

    @property
    def max_generation_length(self) -> int:
        return self.vocab.max_answer_length
