"""Additive attention biases (0 attends, MASK_VALUE (-1e5) masks) and the
interleaved sinusoid table.

Counterpart of the bias helpers (``prefix_lm_bias`` included),
``sinusoid_encoding_table`` and ``box_relational_embedding`` in
``openvivqa_tpu/models/modules/masks.py``.  Biases stay float32: -1e5 overflows
float16.
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


def box_relational_embedding(boxes: torch.Tensor, dim_g: int = 64, wave_len: float = 1000.0,
                             trignometric_embedding: bool = True) -> torch.Tensor:
    """Pairwise box geometry of (bs, n, 4) boxes (x_min, y_min, x_max, y_max):
    (bs, n, n, 4) log-scaled displacements, or with `trignometric_embedding`
    their sines and cosines at dim_g / 8 frequencies, (bs, n, n, dim_g)."""
    x_min, y_min, x_max, y_max = boxes.float().split(1, dim=-1)  # (bs, n, 1) each
    cx, cy = (x_min + x_max) * 0.5, (y_min + y_max) * 0.5
    w, h = (x_max - x_min) + 1.0, (y_max - y_min) + 1.0

    def t(x):
        return x.transpose(1, 2)

    position = torch.stack([
        torch.log(torch.clamp(torch.abs((cx - t(cx)) / w), min=1e-3)),
        torch.log(torch.clamp(torch.abs((cy - t(cy)) / h), min=1e-3)),
        torch.log(w / t(w)),
        torch.log(h / t(h)),
    ], dim=-1)
    if not trignometric_embedding:
        return position
    bs, n = position.shape[:2]
    feat_range = torch.arange(dim_g / 8, dtype=torch.float32, device=boxes.device)
    dim_mat = 1.0 / torch.pow(torch.tensor(wave_len, dtype=torch.float32), feat_range / (dim_g / 8))
    angles = ((100.0 * position)[..., None] * dim_mat.to(boxes.device)).reshape(bs, n, n, -1)
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
