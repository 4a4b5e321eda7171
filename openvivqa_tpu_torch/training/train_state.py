"""Loss functions, the port's counterpart of ``openvivqa_tpu/training/train_state.py``
(the train state itself is the model plus its optimizer, held by the task).

Under a process group each loss is the masked mean over the GLOBAL batch, as
the JAX step over a data mesh is one step over the global batch: the
denominator is summed over every process, and each process's share is scaled
so that the mean of the processes' gradients (DDP's and FSDP's reduction) is
the gradient of the global mean.  The value returned is the global loss.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.multihost import process_count


def masked_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """total / max(count, 1) over the whole batch: with one process the local
    quotient; under a process group `count` (and, for the value, `total`) is
    summed over the processes in one all-reduce of detached values, and the
    gradient is that of world * total / global count, which the gradient
    reduction averages into the global mean's."""
    world = process_count()
    if world == 1:
        return total / count.clamp(min=1.0)
    sums = torch.stack([total.detach(), count.detach().to(total.dtype)])
    dist.all_reduce(sums)
    global_count = sums[1].clamp(min=1.0)
    scaled = total * (world / global_count)
    return scaled + (sums[0] / global_count - scaled).detach()


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
    return masked_mean(-(gathered * valid).sum(), valid.sum())


def bce_with_logits_loss(scores: torch.Tensor, targets: torch.Tensor,
                         weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BCEWithLogitsLoss(reduction='mean') of scores (N, C) against the one-hot
    rows of class ids targets (N,).  With per-row `weights` (sample_valid),
    batch-padding rows count in neither the sum nor the denominator."""
    one_hot = torch.nn.functional.one_hot(targets.long(), scores.shape[-1]).to(scores.dtype)
    losses = scores.clamp(min=0) - scores * one_hot + torch.log1p(torch.exp(-scores.abs()))
    if weights is None:
        if process_count() == 1:
            return losses.mean()
        return masked_mean(losses.sum(), torch.tensor(float(losses.numel()), device=losses.device))
    weights = weights.to(scores.dtype)[:, None]
    return masked_mean((losses * weights).sum(), weights.sum() * scores.shape[-1])
