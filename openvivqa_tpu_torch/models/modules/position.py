"""Positional embeddings: the DETR-style 1-D sinusoid the encoders add.

Counterpart of ``SinusoidPositionalEmbedding`` in
``openvivqa_tpu/models/modules/position.py`` (no parameters).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class SinusoidPositionalEmbedding(nn.Module):
    """Position p = running count of unmasked slots; dim t is scaled by
    temperature^(2 * (t // 2) / num_pos_feats); sin on even dims and cos on odd
    dims, interleaved."""

    def __init__(self, num_pos_feats: int = 64, temperature: float = 10000.0,
                 normalize: bool = False, scale: Optional[float] = None):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.temperature = temperature
        self.normalize = normalize
        self.scale = scale

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(bs, L, num_pos_feats) for x (bs, L, ...); `mask` (bs, L) is True at
        masked slots."""
        bs, length = x.shape[0], x.shape[1]
        if mask is None:
            not_mask = torch.ones((bs, length), dtype=torch.float32, device=x.device)
        else:
            not_mask = (~mask).to(torch.float32)
        embed = not_mask.cumsum(dim=1)
        if self.normalize:
            scale = self.scale if self.scale is not None else 2 * math.pi
            embed = embed / (embed[:, -1:] + 1e-6) * scale
        return self.encode_positions(embed)

    def encode_positions(self, values: torch.Tensor) -> torch.Tensor:
        """The same formula for explicit (bs, L) position values (1-based)."""
        bs, length = values.shape
        dim_t = torch.arange(self.num_pos_feats, dtype=torch.float32, device=values.device)
        dim_t = self.temperature ** (
            2 * torch.div(dim_t, 2, rounding_mode="floor") / self.num_pos_feats)
        pos = values.to(torch.float32)[:, :, None] / dim_t
        pos = torch.stack([pos[:, :, 0::2].sin(), pos[:, :, 1::2].cos()], dim=-1)
        return pos.reshape(bs, length, -1)
