"""Additive attention biases: 0 attends, MASK_VALUE (-1e5) masks.

Counterpart of the bias helpers in ``openvivqa_tpu/models/modules/masks.py``.
Biases stay float32: -1e5 overflows float16.
"""

from __future__ import annotations

import torch

# the reference writes -10e4 (i.e. -1e5); the kernels use the same constant
MASK_VALUE = -10e4


def padding_bias(sequences: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """(bs, 1, 1, L) float32 bias.  `sequences` is (bs, L) tokens or (bs, L, D)
    features; a position is padding when its sum over the trailing dim equals
    padding_idx * D (for features: an all-zero row when padding_idx is 0)."""
    seq3 = sequences[..., None] if sequences.ndim == 2 else sequences
    is_pad = seq3.sum(dim=-1) == padding_idx * seq3.shape[-1]
    return (is_pad.to(torch.float32) * MASK_VALUE)[:, None, None, :]


def causal_bias(seq_len: int, device=None) -> torch.Tensor:
    """(1, 1, L, L) float32 bias: future positions get MASK_VALUE."""
    upper = torch.triu(torch.ones((seq_len, seq_len), dtype=torch.float32, device=device), 1)
    return (upper * MASK_VALUE)[None, None]
