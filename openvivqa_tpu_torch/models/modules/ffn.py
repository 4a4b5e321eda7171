"""Position-wise feed-forward with a post-LN residual.

Counterpart of ``openvivqa_tpu/models/modules/ffn.py``: Linear, exact-erf GELU,
dropout, Linear, dropout, LayerNorm(x + out) with the JAX package's eps of
1e-6.  Parameter names are the reference's (``fc1``, ``fc2``, ``layer_norm``).
Outside decode it is plain ``nn.Linear``, as the JAX package leaves it to its
compiler; a single decode token takes kernel C (``ops/decode_step.fused_ffn_step``)
on the staged decode route, through `fused_weights`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import _cuda
from ...ops import decode_step as _ds
from ...parallel.mesh import whole
from .bert import dropout, vector

LN_EPS = 1e-6  # flax nn.LayerNorm's default, which the JAX package keeps


def matrix(linear: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """A Linear's weight, whole, as the (in, out) matrix the kernels read."""
    return whole(linear.weight).detach().t().to(dtype).contiguous()


class PositionWiseFeedForward(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.dropout = config.DROPOUT
        self.fc1 = nn.Linear(config.D_MODEL, config.D_FF)
        self.fc2 = nn.Linear(config.D_FF, config.D_MODEL)
        self.layer_norm = nn.LayerNorm(config.D_MODEL, eps=LN_EPS)

    @torch.no_grad()
    def fused_weights(self, dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
        """Kernel C's operands: the matrices as (in, out) in `dtype` (bf16 on
        the card unless told otherwise), the vectors float32."""
        dtype = dtype or _cuda.kernel_dtype(self.fc1.weight.device)
        return {
            "w1": matrix(self.fc1, dtype), "b1": vector(self.fc1.bias),
            "w2": matrix(self.fc2, dtype), "b2": vector(self.fc2.bias),
            "ln_scale": vector(self.layer_norm.weight),
            "ln_bias": vector(self.layer_norm.bias),
        }

    def decode_step(self, rows: torch.Tensor, weights: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One decode token per row, (rows, d_model), through kernel C."""
        f = weights
        return _ds.fused_ffn_step(
            rows, f["w1"], f["b1"], f["w2"], f["b2"], f["ln_scale"], f["ln_bias"], eps=LN_EPS
        )

    def forward(self, inputs: torch.Tensor, generator: Optional[torch.Generator] = None):
        hidden = dropout(F.gelu(self.fc1(inputs)), self.dropout, generator)
        out = dropout(self.fc2(hidden), self.dropout, generator)
        return self.layer_norm(inputs + out)
