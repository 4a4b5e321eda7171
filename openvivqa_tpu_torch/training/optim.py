"""Optimizer and learning-rate schedules, the port's counterpart of
``openvivqa_tpu/training/optim.py``: Adam with betas (0.9, 0.98) and eps 1e-8,
under a ``LambdaLR`` whose lambda is either the Noam warmup or the constant.

``LambdaLR`` multiplies the optimizer's base rate (TRAINING.LEARNING_RATE) by
the lambda, as the reference's tasks do, so
  * Noam: lr = base * d_model^-0.5 * min(s^-0.5, s * warmup^-1.5), s = step + 1;
  * constant: the lambda returns LEARNING_RATE, so the effective rate is
    LEARNING_RATE ** 2 (the reference's quirk, kept).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
from torch.optim.lr_scheduler import LambdaLR


def noam_lambda(d_model: int, warmup: int) -> Callable[[int], float]:
    def factor(step: int) -> float:
        s = step + 1.0
        return d_model**-0.5 * min(s**-0.5, s * warmup**-1.5)

    return factor


def constant_lambda(base_lr: float) -> Callable[[int], float]:
    return lambda step: base_lr


def make_optimizer(params: Iterable[torch.nn.Parameter], base_lr: float,
                   factor: Callable[[int], float], foreach: Optional[bool] = None):
    """(Adam, LambdaLR): call the schedule's step() after each optimizer step.
    `foreach` is Adam's (None: torch's default for the device)."""
    optimizer = torch.optim.Adam(params, lr=base_lr, betas=(0.9, 0.98), eps=1e-8,
                                 foreach=foreach)
    return optimizer, LambdaLR(optimizer, factor)
