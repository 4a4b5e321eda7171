"""The pre-LN ViT backbone, under Hugging Face's parameter names.

Counterpart of ``openvivqa_tpu/models/modules/vit.py`` and of the raw-pixel
front of its ``ViTEmbedding``: a patch convolution, a class token and learned
positions, then layers of LayerNorm -> self-attention -> residual and LayerNorm
-> MLP (exact GELU) -> residual, and a final LayerNorm (what HF's
``last_hidden_state`` returns).  LayerNorm eps 1e-12 (``ViTConfig``'s default).

Parameter names are HF ``ViTModel``'s (``embeddings.patch_embeddings.projection``,
``embeddings.cls_token``, ``embeddings.position_embeddings``,
``encoder.layer.N.attention.attention.query``, ``...attention.output.dense``,
``...intermediate.dense``, ``...output.dense``, ``...layernorm_before``,
``...layernorm_after``, ``layernorm``), so a local HF checkpoint loads with
``load_state_dict`` (its pooler aside) and ``hf_conversion.convert_vit_weights``
reads the state dict.

Self-attention takes ``ops/fused_attention.fused_attention_packed`` with no bias
on the packed projections.  The backbone runs frozen and in eval, so it has no
dropout.  Pixels arrive as (b, H, W, 3), the JAX package's layout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import fused_attention as _attn
from ...parallel.mesh import whole

LN_EPS = 1e-12  # ViTConfig.layer_norm_eps


class _Dense(nn.Module):
    """HF's one-Linear holder (``ViTIntermediate``, ``ViTOutput``,
    ``ViTSelfOutput``): the weights live at ``<name>.dense``."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)

    def forward(self, x):
        return self.dense(x)


class _SelfAttention(nn.Module):
    def __init__(self, hidden_size: int):
        super().__init__()
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)


class ViTAttention(nn.Module):
    """softmax(Q K^T / sqrt(d)) V over every token, then the out projection."""

    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = 1.0 / math.sqrt(hidden_size // num_heads)
        self.attention = _SelfAttention(hidden_size)
        self.output = _Dense(hidden_size, hidden_size)

    def forward(self, x):
        p = self.attention
        context = _attn.fused_attention_packed(p.query(x), p.key(x), p.value(x), None,
                                               self.scale, self.num_heads)
        return self.output(context)


class ViTLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: Optional[int] = None):
        super().__init__()
        intermediate_size = intermediate_size or 4 * hidden_size
        self.layernorm_before = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.attention = ViTAttention(hidden_size, num_heads)
        self.layernorm_after = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.intermediate = _Dense(hidden_size, intermediate_size)
        self.output = _Dense(intermediate_size, hidden_size)

    def forward(self, x):
        x = x + self.attention(self.layernorm_before(x))
        return x + self.output(F.gelu(self.intermediate(self.layernorm_after(x))))


class ViTEncoder(nn.Module):
    """The layer stack (HF's ``encoder``; the final LayerNorm is the backbone's)."""

    def __init__(self, hidden_size: int, num_layers: int, num_heads: int,
                 intermediate_size: Optional[int] = None):
        super().__init__()
        self.layer = nn.ModuleList(
            ViTLayer(hidden_size, num_heads, intermediate_size) for _ in range(num_layers))

    def forward(self, x):
        for layer in self.layer:
            x = layer(x)
        return x


class _PatchEmbeddings(nn.Module):
    """The patch convolution (HF's ``projection``, a stride-p Conv2d), computed
    as one product of the (b, patches, 3 p p) patch rows with the kernel: a
    float32 product, where a cuDNN convolution would default to TF32."""

    def __init__(self, hidden_size: int, patch: int):
        super().__init__()
        self.patch = patch
        self.projection = nn.Conv2d(3, hidden_size, kernel_size=patch, stride=patch)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(b, H, W, 3) -> (b, (H / p) (W / p), hidden), patches in row-major order."""
        b, height, width, _ = pixel_values.shape
        p = self.patch
        rows = pixel_values[:, :height // p * p, :width // p * p].reshape(
            b, height // p, p, width // p, p, 3).permute(0, 1, 3, 5, 2, 4)
        weight = whole(self.projection.weight)
        return F.linear(rows.reshape(b, -1, 3 * p * p), weight.reshape(weight.shape[0], -1),
                        whole(self.projection.bias))


class _Embeddings(nn.Module):
    def __init__(self, hidden_size: int, patch: int, image_size: int):
        super().__init__()
        self.num_patches = (image_size // patch) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(1, self.num_patches + 1, hidden_size))
        self.patch_embeddings = _PatchEmbeddings(hidden_size, patch)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(b, H, W, 3) pixels -> (b, 1 + patches, hidden) tokens."""
        tokens = self.patch_embeddings(pixel_values)
        if tokens.shape[1] != self.num_patches:
            raise ValueError(
                f"{tokens.shape[1]} patches from pixels {tuple(pixel_values.shape)}: the "
                f"backbone was built for {self.num_patches} (set VISION_EMBEDDING.IMAGE_SIZE)"
            )
        cls = self.cls_token.expand(tokens.shape[0], -1, -1)
        return torch.cat([cls, tokens], dim=1) + self.position_embeddings


class ViTBackbone(nn.Module):
    """(b, H, W, 3) pixels -> (b, 1 + patches, hidden), HF ``ViTModel``'s
    ``last_hidden_state`` under the same weights."""

    def __init__(self, hidden_size: int = 768, num_layers: int = 12, num_heads: int = 12,
                 intermediate_size: Optional[int] = None, patch: int = 16,
                 image_size: int = 224):
        super().__init__()
        self.embeddings = _Embeddings(hidden_size, patch, image_size)
        self.encoder = ViTEncoder(hidden_size, num_layers, num_heads, intermediate_size)
        self.layernorm = nn.LayerNorm(hidden_size, eps=LN_EPS)

    def init_weights_(self, generator: torch.Generator) -> None:
        """Random weights, drawn from `generator` in parameter order: the JAX
        package's ViT initialisers (normal(0.02) kernels, class token and
        positions; zero Linear biases; unit LayerNorm scales), except that the
        LayerNorm biases are drawn from normal(0.02) too, as a trained
        checkpoint's are.  With zero biases every token's final features would
        sum to zero up to rounding, and ViTEmbedding's ``padding_bias(features,
        0)`` would mask tokens at random."""
        with torch.no_grad():
            for name, param in self.named_parameters():
                if "layernorm" in name and name.endswith("weight"):
                    param.fill_(1.0)
                elif name.endswith("bias") and "layernorm" not in name:
                    param.zero_()
                else:
                    param.copy_(torch.randn(param.shape, generator=generator) * 0.02)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.layernorm(self.encoder(self.embeddings(pixel_values)))
