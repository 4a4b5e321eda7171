"""Batched row lookups with the JAX package's out-of-range rule.

Counterpart of ``openvivqa_tpu/ops/gather.py``: an id below 0 or at least the
table's row count returns an all-zero row, so lookups split across a shared
answer table and a per-sample OCR table can be summed.  Plain PyTorch: the
TPU's one-hot matmul trick has no reason to exist on the card.
"""

from __future__ import annotations

import torch


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (bs, N, d), ids (bs, L) int -> (bs, L, d)."""
    n = table.shape[1]
    ids = ids.long()
    valid = (ids >= 0) & (ids < n)
    index = ids.clamp(0, max(n - 1, 0))[..., None].expand(-1, -1, table.shape[2])
    rows = torch.gather(table, 1, index)
    return torch.where(valid[..., None], rows, torch.zeros((), dtype=table.dtype, device=table.device))


def take_rows_shared(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (N, d) shared across the batch, ids (bs, L) int -> (bs, L, d)."""
    n = table.shape[0]
    ids = ids.long()
    valid = (ids >= 0) & (ids < n)
    rows = table[ids.clamp(0, max(n - 1, 0))]
    return torch.where(valid[..., None], rows, torch.zeros((), dtype=table.dtype, device=table.device))
