"""Vision embeddings.

Counterpart of ``FeatureEmbedding`` (parameter ``proj``, the reference's name)
and ``VisionOcrEmbedding`` in ``openvivqa_tpu/models/modules/vision_embeddings.py``;
the latter's linears and LayerNorms carry M4C's names
(``linear_obj_feat_to_mmt_in``, ``obj_feat_layer_norm`` ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...builders import META_VISION_EMBEDDING
from .bert import dropout
from .ffn import LN_EPS
from .masks import padding_bias


@META_VISION_EMBEDDING.register()
class FeatureEmbedding(nn.Module):
    """Linear + exact-erf GELU + dropout over region or grid features; an
    all-zero feature row is padding.  Returns (features, padding_bias)."""

    def __init__(self, config):
        super().__init__()
        self.dropout = config.DROPOUT
        self.proj = nn.Linear(config.D_FEATURE, config.D_MODEL)

    def forward(self, features, generator=None):
        masks = padding_bias(features, padding_idx=0)
        out = dropout(F.gelu(self.proj(features)), self.dropout, generator)
        return out, masks


@META_VISION_EMBEDDING.register()
class VisionOcrEmbedding(nn.Module):
    """Object and OCR streams, each LN(W feat) + LN(W box), exact-erf GELU and
    dropout, concatenated along the tokens.  The OCR features are [det | rec |
    fasttext]; an object row is padding when its features are all zero, an
    OCR row when its det features are.  The feature widths are the config's
    D_OBJ_FEATURE and D_OCR_FEATURE (the three OCR parts summed); boxes are
    4 wide.  Returns (features, padding_bias)."""

    def __init__(self, config):
        super().__init__()
        d, self.dropout = config.D_MODEL, config.DROPOUT
        for stream, d_feat in (("obj", config.D_OBJ_FEATURE), ("ocr", config.D_OCR_FEATURE)):
            for part, width in (("feat", d_feat), ("bbox", 4)):
                setattr(self, f"linear_{stream}_{part}_to_mmt_in", nn.Linear(width, d))
                setattr(self, f"{stream}_{part}_layer_norm", nn.LayerNorm(d, eps=LN_EPS))

    def _stream(self, stream: str, features, boxes, generator):
        def part(name, x):
            linear = getattr(self, f"linear_{stream}_{name}_to_mmt_in")
            return getattr(self, f"{stream}_{name}_layer_norm")(linear(x))

        return dropout(F.gelu(part("feat", features) + part("bbox", boxes)), self.dropout,
                       generator)

    def forward(self, obj_features, obj_boxes, ocr_det_features, ocr_rec_features,
                ocr_fasttext, ocr_boxes, generator=None):
        ocr_features = torch.cat([ocr_det_features, ocr_rec_features, ocr_fasttext], dim=-1)
        masks = torch.cat([padding_bias(obj_features, 0), padding_bias(ocr_det_features, 0)],
                          dim=-1)
        features = torch.cat([self._stream("obj", obj_features, obj_boxes, generator),
                              self._stream("ocr", ocr_features, ocr_boxes, generator)], dim=1)
        return features, masks
