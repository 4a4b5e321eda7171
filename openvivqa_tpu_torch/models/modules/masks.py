"""Additive attention biases (0 attends, MASK_VALUE (-1e5) masks) and the
interleaved sinusoid table.

Counterpart of the bias helpers (``prefix_lm_bias`` included) and
``sinusoid_encoding_table`` in
``openvivqa_tpu/models/modules/masks.py``.  Biases stay float32: -1e5 overflows
float16.  The box-geometry embeddings wait for the models that use them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
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


def validity_to_bias(validity_mask: torch.Tensor) -> torch.Tensor:
    """(bs, L) 1-valid / 0-pad mask -> additive (bs, 1, 1, L) float32 bias."""
    return ((1.0 - validity_mask.to(torch.float32)) * MASK_VALUE)[:, None, None, :]


def combine_biases(*biases: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Logical-or of additive biases: a position is masked if any input masks
    it; the output is 0 / MASK_VALUE.  None inputs are skipped."""
    present = [b for b in biases if b is not None]
    if not present:
        return None
    masked = present[0] != 0
    for bias in present[1:]:
        masked = masked | (bias != 0)
    return masked.to(torch.float32) * MASK_VALUE


def prefix_lm_bias(prefix_bias: torch.Tensor, answer_col_bias: torch.Tensor,
                   answer_block_bias: torch.Tensor, context_blind: bool = False) -> torch.Tensor:
    """(bs, 1, L, L) bias of a single-stream prefix LM: every row sees each
    column's padding bias ([prefix_bias | answer_col_bias]), and the answer x
    answer block is answer_block_bias (causal and padding).  `context_blind`
    also hides the answer columns from the prefix rows, the masking under
    which an incremental decode equals the quadratic one."""
    cols = torch.cat([prefix_bias, answer_col_bias], dim=-1)
    total, ans_len = cols.shape[-1], answer_col_bias.shape[-1]
    full = cols.expand(cols.shape[0], cols.shape[1], total, total).clone()
    full[:, :, -ans_len:, -ans_len:] = answer_block_bias
    if context_blind:
        full[:, :, : total - ans_len, -ans_len:] = MASK_VALUE
    return full


def sinusoid_encoding_table(max_len: int, d_model: int,
                            padding_idx: Optional[int] = None) -> np.ndarray:
    """(max_len, d_model) float32 table: row p has sin(p / 10000^(2i/d)) at even
    columns and cos at odd columns; row `padding_idx`, when given, is zero."""
    positions = np.arange(max_len, dtype=np.float32)[:, None]
    dims = np.arange(d_model // 2, dtype=np.float32)[None, :]
    angle = positions / np.power(10000.0, 2 * dims / d_model)
    table = np.zeros((max_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    if padding_idx is not None:
        table[padding_idx] = 0.0
    return table
