"""SpatialCirclePosition (SCP) and TextSemanticSeparate (TSS).

Counterpart of ``openvivqa_tpu/models/modules/scp_tss.py``, plain torch as the
JAX package calls no kernel there:

* ``quantise_to_patch_grid``: box centroids onto the centres of an 11 x 11 grid;
* ``SpatialCirclePosition`` (registered as an attention): OCR self-attention
  whose logits gain a learned per-head bias of the bucketed distance between
  two tokens' grid cells; returns (output, attention weights);
* ``TextSemanticSeparate``: OCR embeddings interleaved with a learned context
  slot, the object, box and OCR streams summed into both positions.
"""

from __future__ import annotations

import torch
from torch import nn

from ...builders import META_ATTENTION
from .attentions import ScaledDotProductAttention, _merge_heads, _split_heads


def quantise_to_patch_grid(boxes: torch.Tensor, n_cells: int = 11) -> torch.Tensor:
    """(bs, n, 4) relative boxes -> (bs, n, 2) centres of their centroid's cell."""
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    cell_w = 1.0 / n_cells
    ix = torch.clamp(torch.floor(cx / cell_w), 0, n_cells - 1)
    iy = torch.clamp(torch.floor(cy / cell_w), 0, n_cells - 1)
    return torch.stack([ix * cell_w + cell_w / 2, iy * cell_w + cell_w / 2], dim=-1)


@META_ATTENTION.register()
class SpatialCirclePosition(ScaledDotProductAttention):
    """OCR self-attention + a learned bias of NUM_DISTANCE distance buckets
    (``dist_embedding``, one value per head)."""

    def __init__(self, config):
        super().__init__(config)
        self.num_distance = int(config.get("NUM_DISTANCE", 16))
        self.dist_embedding = nn.Embedding(self.num_distance, self.h)

    def forward(self, ocr_features, ocr_boxes, ocr_padding_bias, **_):
        patches = quantise_to_patch_grid(ocr_boxes)
        delta = patches[:, :, None, :] - patches[:, None, :, :]
        dist = torch.sqrt(torch.sum(delta ** 2, dim=-1))  # (bs, n, n), 0 .. sqrt(2)
        buckets = torch.clamp((dist * self.num_distance).to(torch.int64), 0,
                              self.num_distance - 1)
        dist_bias = self.dist_embedding(buckets).permute(0, 3, 1, 2)  # (bs, h, n, n)
        q = _split_heads(self.fc_q(ocr_features), self.h)
        k = _split_heads(self.fc_k(ocr_features), self.h)
        v = _split_heads(self.fc_v(ocr_features), self.h)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * self.scale + ocr_padding_bias
        weights = torch.softmax(logits + dist_bias, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
        return self.fc_o(_merge_heads(out)), weights


class TextSemanticSeparate(nn.Module):
    """Even positions: each OCR token + the summed streams; odd positions: the
    learned ``context_embedding`` + the same sum.  (bs, n, d) x 4 -> (bs, 2n, d)."""

    def __init__(self, config):
        super().__init__()
        self.context_embedding = nn.Parameter(torch.empty(1, 1, config.D_MODEL))
        self.init_weights_(torch.default_generator)

    def init_weights_(self, generator: torch.Generator) -> None:
        """flax's Xavier-uniform on (1, 1, d) (fan in 1, fan out d), drawn from
        `generator`."""
        bound = (6.0 / (1 + self.context_embedding.shape[-1])) ** 0.5
        with torch.no_grad():
            uniform = torch.rand(self.context_embedding.shape, generator=generator)
            self.context_embedding.copy_((2.0 * uniform - 1.0) * bound)

    def forward(self, obj_emb, obj_box_emb, ocr_emb, ocr_box_emb):
        bs, n, d = ocr_emb.shape
        combined = obj_emb + obj_box_emb + ocr_emb + ocr_box_emb
        interleaved = torch.stack(
            [ocr_emb + combined, self.context_embedding.expand(bs, n, d) + combined], dim=2)
        return interleaved.reshape(bs, 2 * n, d)
