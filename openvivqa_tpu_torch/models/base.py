"""Model base classes.

Counterpart of ``openvivqa_tpu/models/base.py``.  Models are ``nn.Module``s
taking a dict of batch tensors; a `generator` selects the training route, whose
dropout draws from it.  Decode state is explicit: ``training/decode.py`` carries
the cache through its loop and the invariants of ``prepare_decode`` beside it.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

BatchTensors = Dict[str, torch.Tensor]


def init_xavier_law_(model: nn.Module, generator: torch.Generator,
                     skip: Iterable[nn.Module] = ()) -> None:
    """The JAX package's initialisers of the MCAN-family models, drawn from
    `generator` in module order: Xavier-uniform Linear and Conv1d weights (a
    convolution's fans count its window) with zero biases, N(0, 1) embedding
    tables, LayerNorm scale 1 and bias 0, and flax's LSTM laws (truncated
    LeCun-normal input kernels, orthogonal recurrent kernels, zero biases).
    A submodule with initialisers of its own (``init_weights_``: a pretrained
    backbone, e.g. the frozen language model's) draws them at its turn.  The
    modules in `skip`, and everything under them, are left as they are."""
    skipped = {id(p) for module in skip for p in module.parameters()}
    with torch.no_grad():
        for sub in model.modules():
            if sub is not model and hasattr(sub, "init_weights_") and not any(
                    id(p) in skipped for p in sub.parameters()):
                sub.init_weights_(generator)
                skipped.update(id(p) for p in sub.parameters())
                continue
            if isinstance(sub, nn.LSTM):
                if id(sub.weight_ih_l0) not in skipped:
                    _init_lstm_(sub, generator)
                continue
            if id(getattr(sub, "weight", None)) in skipped:
                continue
            if isinstance(sub, (nn.Linear, nn.Conv1d)):
                window = sub.weight[0, 0].numel() if sub.weight.ndim == 3 else 1
                fans = (sub.weight.shape[0] + sub.weight.shape[1]) * window
                bound = (6.0 / fans) ** 0.5
                uniform = torch.rand(sub.weight.shape, generator=generator)
                sub.weight.copy_((2.0 * uniform - 1.0) * bound)
                if sub.bias is not None:
                    sub.bias.zero_()
            elif isinstance(sub, nn.Embedding):
                sub.weight.copy_(torch.randn(sub.weight.shape, generator=generator))
            elif isinstance(sub, nn.LayerNorm):
                sub.weight.fill_(1.0)
                sub.bias.zero_()


def _init_lstm_(lstm: nn.LSTM, generator: torch.Generator) -> None:
    """flax OptimizedLSTMCell's laws for each gate's kernels (rows i, f, g, o):
    the input kernel LeCun-normal truncated at two standard deviations, the
    recurrent kernel orthogonal; both biases zero."""
    hidden, d_in = lstm.hidden_size, lstm.input_size
    std = (1.0 / d_in) ** 0.5 / 0.87962566103423978  # the truncated normal's unit variance
    for gate in range(4):
        rows = slice(gate * hidden, (gate + 1) * hidden)
        normal = torch.randn((hidden, d_in), generator=generator)
        while bool((normal.abs() > 2.0).any()):
            redraw = torch.randn(normal.shape, generator=generator)
            normal = torch.where(normal.abs() > 2.0, redraw, normal)
        lstm.weight_ih_l0[rows] = normal * std
        q, r = torch.linalg.qr(torch.randn((hidden, hidden), generator=generator))
        lstm.weight_hh_l0[rows] = (q * torch.sign(torch.diagonal(r))).t()
    lstm.bias_ih_l0.zero_()
    lstm.bias_hh_l0.zero_()


class ClassificationModel(nn.Module):
    """Answer-classification models: forward -> (bs, n_answers) log-probs."""

    def init_weights_(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers of the classification models
        (``init_xavier_law_``)."""
        init_xavier_law_(self, generator)

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
