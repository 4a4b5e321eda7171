"""The LoRRA family: MMF_LoRRA (classification over the answers and the OCR
slots) and MMF_IterativeLoRRA (its three branches as the streams of an MMF_M4C
MMT with the pointer network and the M4C greedy decodes).

Counterpart of ``openvivqa_tpu/models/mmf_lorra.py``, under the reference's
torch names (``txt_embedding``, ``txt_norm``, ``linear_obj_feat_to_mmt_in``,
``obj_feat_layer_norm``, ``linear_ocr_feat_to_mmt_in``, ``ocr_feat_layer_norm``,
``self_attn`` / ``spatial_attn`` / ``context_attn`` with ``fc_q`` ... ``fc_o``,
``classifier``), the names ``torch_conversion.convert_mmf_lorra`` reads.

The three branches are the reference's registry ScaledDotProductAttention as
LoRRA builds it (``_RegistryAttention``: HEAD 1, D_KEY 64 under D_MODEL 512 in
the configs), returning its weights beside its output.  It stays plain
PyTorch, as it is plain XLA in the JAX package: its weights are an output, and
no kernel computes it.  MMF_LoRRA keeps only the spatial and context
branches' weights, which scale the question features: their ``fc_v`` and
``fc_o`` take no part in the scores and get no gradient.  The object stream is
feature-only and the OCR stream FastText-only (L2-normalised), each LayerNorm
at eps 1e-5.  MMF_IterativeLoRRA's MMT is MMF_M4C's, on the kernels.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from ..builders import META_ARCHITECTURE, build_text_embedding
from ..config import ConfigNode
from .common import total_answers_of
from .m4c_common import MMT, OcrPtrNet, l2_normalize
from .mmf_m4c import _TORCH_LN_EPS, MMF_M4C, resolve_decoding_mode
from .modules.bert import dropout
from .modules.masks import padding_bias


class _RegistryAttention(nn.Module):
    """softmax(q k^T / sqrt(d_k) + bias) v over h heads of fc_q / fc_k (h * d_k
    wide) and fc_v (h * d_v), then fc_o back to D_MODEL; returns (out,
    weights (bs, h, nq, nk))."""

    def __init__(self, config, d_query: int, d_kv: int):
        super().__init__()
        self.h, self.d_k, self.d_v = config.HEAD, config.D_KEY, config.D_VALUE
        self.fc_q = nn.Linear(d_query, self.h * self.d_k)
        self.fc_k = nn.Linear(d_kv, self.h * self.d_k)
        self.fc_v = nn.Linear(d_kv, self.h * self.d_v)
        self.fc_o = nn.Linear(self.h * self.d_v, config.D_MODEL)

    def forward(self, queries, keys, values, attention_bias=None):
        b, nq, nk = queries.shape[0], queries.shape[1], keys.shape[1]
        q = self.fc_q(queries).reshape(b, nq, self.h, self.d_k).transpose(1, 2)
        k = self.fc_k(keys).reshape(b, nk, self.h, self.d_k).transpose(1, 2)
        v = self.fc_v(values).reshape(b, nk, self.h, self.d_v).transpose(1, 2)
        logits = q @ k.transpose(-1, -2) / math.sqrt(float(self.d_k))
        if attention_bias is not None:
            logits = logits + attention_bias
        weights = torch.softmax(logits, dim=-1)
        out = (weights @ v).transpose(1, 2).reshape(b, nq, self.h * self.d_v)
        return self.fc_o(out), weights


def _attn_node(config, key: str, d_model: int):
    """The branch's config node; single-head defaults where a hand-written
    config omits it (the reference configs always carry it)."""
    node = config.get(key)
    if node is not None:
        return node
    return ConfigNode({"HEAD": 1, "D_KEY": d_model, "D_VALUE": d_model, "D_MODEL": d_model})


class _LoRRABranches:
    """The stream projections and the three registry-attention branches,
    shared by both models (they differ in how the branches are consumed)."""

    # as MMF_M4C's: a feature-only object stream, a fasttext-only OCR stream
    FEATURE_INPUTS = {"OBJECT_EMBEDDING": ("region_features",),
                      "OCR_EMBEDDING": ("ocr_fasttext_features",)}

    def _build_lorra_modules(self, config, vocab, d_model: int) -> int:
        """Builds the modules; returns the width of the question branch's output."""
        self.txt_embedding = build_text_embedding(config.TEXT_EMBEDDING, vocab)
        d_text = config.TEXT_EMBEDDING.D_MODEL
        self.txt_norm = nn.LayerNorm(d_text, eps=_TORCH_LN_EPS)
        self.linear_obj_feat_to_mmt_in = nn.Linear(config.OBJECT_EMBEDDING.D_FEATURE, d_model)
        self.obj_feat_layer_norm = nn.LayerNorm(d_model, eps=_TORCH_LN_EPS)
        self.obj_dropout = config.OBJECT_EMBEDDING.DROPOUT
        self.linear_ocr_feat_to_mmt_in = nn.Linear(config.OCR_EMBEDDING.D_FEATURE, d_model)
        self.ocr_feat_layer_norm = nn.LayerNorm(d_model, eps=_TORCH_LN_EPS)
        self.ocr_dropout = config.OCR_EMBEDDING.DROPOUT
        d_self = _attn_node(config, "SELF_ATTENTION", d_model).D_MODEL
        self.self_attn = _RegistryAttention(_attn_node(config, "SELF_ATTENTION", d_model),
                                            d_text, d_text)
        self.spatial_attn = _RegistryAttention(_attn_node(config, "SPATIAL_ATTENTION", d_model),
                                               d_model, d_self)
        self.context_attn = _RegistryAttention(_attn_node(config, "CONTEXT_ATTENTION", d_model),
                                               d_model, d_self)
        return d_self

    def _lorra_streams(self, batch, generator=None):
        """(txt_emb, txt_bias, obj, obj_bias, ocr, ocr_bias)."""
        txt_emb, (txt_bias, _) = self.txt_embedding(batch["question_tokens"], generator)
        txt_emb = self.txt_norm(txt_emb)
        obj = self.obj_feat_layer_norm(self.linear_obj_feat_to_mmt_in(batch["region_features"]))
        obj = dropout(obj, self.obj_dropout, generator)
        ocr = self.ocr_feat_layer_norm(
            self.linear_ocr_feat_to_mmt_in(l2_normalize(batch["ocr_fasttext_features"])))
        ocr = dropout(ocr, self.ocr_dropout, generator)
        return (txt_emb, txt_bias, obj, padding_bias(batch["region_features"], 0),
                ocr, padding_bias(batch["ocr_fasttext_features"], 0))


@META_ARCHITECTURE.register()
class MMF_LoRRA(_LoRRABranches, nn.Module):
    """Scores (bs, total_answers + MAX_SCENE_TEXT): the question's
    self-attention features, scaled by the spatial and context branches'
    weights summed over their streams, summed over the tokens, classified."""

    def __init__(self, config, vocab):
        super().__init__()
        d_out = self._build_lorra_modules(config, vocab, config.D_MODEL)
        self.num_choices = total_answers_of(vocab) + config.get("MAX_SCENE_TEXT", 0)
        self.classifier = nn.Linear(d_out, self.num_choices)

    def _pooled(self, batch, generator=None):
        txt_emb, txt_bias, obj, _, ocr, _ = self._lorra_streams(batch, generator)
        self_feat, _ = self.self_attn(txt_emb, txt_emb, txt_emb, txt_bias)
        _, spatial_w = self.spatial_attn(obj, self_feat, self_feat, txt_bias)
        _, context_w = self.context_attn(ocr, self_feat, self_feat, txt_bias)
        # (bs, 1, n, L) single-head weights, summed over the stream axis
        scale = spatial_w[:, 0].sum(dim=1) + context_w[:, 0].sum(dim=1)  # (bs, L)
        return (scale[..., None] * self_feat).sum(dim=1)

    def forward(self, batch, generator=None) -> Dict:
        return {"scores": self.classifier(self._pooled(batch, generator))}


@META_ARCHITECTURE.register()
class MMF_IterativeLoRRA(_LoRRABranches, MMF_M4C):
    """The branches' outputs as the [question, object, OCR] streams of
    MMF_M4C's MMT, with its classifier (over the fixed vocab only), pointer
    network and both greedy decodes."""

    def __init__(self, config, vocab):
        nn.Module.__init__(self)
        mmt = config.MMT
        self.hidden_size = mmt.get("HIDDEN_SIZE", config.D_MODEL)
        self.num_heads = mmt.get("NUM_ATTENTION_HEADS", 8)
        self.max_iter = vocab.max_answer_length
        self.bos_idx = vocab.bos_idx
        self.padding_idx = vocab.padding_idx
        self.decoding_mode, self.context_blind = resolve_decoding_mode(config)
        self._build_lorra_modules(config, vocab, self.hidden_size)
        self.mmt = MMT(self.hidden_size, mmt.get("NUM_HIDDEN_LAYERS", 4), self.num_heads,
                       mmt.get("INTERMEDIATE_SIZE"))
        self.classifier = nn.Linear(self.hidden_size, len(vocab))
        ptr = config.get("OCR_PTR_NET")
        self.ocr_ptr_net = OcrPtrNet(ptr.HIDDEN_SIZE if ptr else self.hidden_size,
                                     ptr.get("QUERY_KEY_SIZE") if ptr else None)

    def kernel_weights(self) -> Dict:
        return {"mmt": self.mmt.encoder.kernel_weights(self.classifier.weight.device)}

    def _mmt_streams(self, batch, weights, generator=None) -> Dict:
        txt_emb, txt_bias, obj, obj_bias, ocr, ocr_bias = self._lorra_streams(batch, generator)
        self_feat, _ = self.self_attn(txt_emb, txt_emb, txt_emb, txt_bias)
        spatial_feat, _ = self.spatial_attn(obj, self_feat, self_feat, txt_bias)
        context_feat, _ = self.context_attn(ocr, self_feat, self_feat, txt_bias)
        return {"txt": (self_feat, txt_bias), "obj": (spatial_feat, obj_bias),
                "ocr": (context_feat, ocr_bias), "pre_ocr": (), "extra": ()}
