"""Loss functions, the port's counterpart of ``openvivqa_tpu/training/train_state.py``
(the train state itself is the model plus its optimizer, held by the task)."""

from __future__ import annotations

from typing import Optional

import torch


def nll_loss(logprobs: torch.Tensor, targets: torch.Tensor, ignore_index: int,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NLLLoss(ignore_index, reduction='mean') over log-probabilities: the mean
    of -logp[target] over the elements whose target is not `ignore_index`.
    logprobs (N, V), targets (N,); optional per-element `weights` (such as
    sample_valid broadcast over tokens) also zero out batch-padding rows."""
    gathered = logprobs.gather(-1, targets.long()[..., None])[..., 0]
    valid = (targets != ignore_index).to(logprobs.dtype)
    if weights is not None:
        valid = valid * weights.to(logprobs.dtype)
    return -(gathered * valid).sum() / valid.sum().clamp(min=1.0)


def bce_with_logits_loss(scores: torch.Tensor, targets: torch.Tensor,
                         weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BCEWithLogitsLoss(reduction='mean') of scores (N, C) against the one-hot
    rows of class ids targets (N,).  With per-row `weights` (sample_valid),
    batch-padding rows count in neither the sum nor the denominator."""
    one_hot = torch.nn.functional.one_hot(targets.long(), scores.shape[-1]).to(scores.dtype)
    losses = scores.clamp(min=0) - scores * one_hot + torch.log1p(torch.exp(-scores.abs()))
    if weights is None:
        return losses.mean()
    weights = weights.to(scores.dtype)[:, None]
    return (losses * weights).sum() / (weights.sum() * scores.shape[-1]).clamp(min=1.0)
