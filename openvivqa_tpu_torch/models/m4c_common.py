"""Shared components of the M4C family.

Counterpart of ``openvivqa_tpu/models/m4c_common.py``: TextBert, the
object/OCR feature-box encodings, OcrPtrNet, PrevPredEmbeddings, the MMT joint
encoder with its incremental-decode entry points, and the OCR feature helpers.
Parameter names follow the reference's torch modules (``mmf_m4c.py``).  A
``generator`` argument selects the training route: dropout drawn from it
(``modules/bert.py``); without one every module is in eval.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops.gather import take_rows, take_rows_shared
from .modules.bert import LN_EPS, BertEmbeddings, BertEncoderStack, dropout
from .modules.masks import MASK_VALUE, causal_bias, padding_bias


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


class TextBert(nn.Module):
    """Question encoder: BertEmbeddings + BertEncoderStack over vocab ids."""

    def __init__(self, config, num_heads: int, vocab_size: int):
        super().__init__()
        hidden = config.HIDDEN_SIZE
        self.embeddings = BertEmbeddings(max(vocab_size, 30522), hidden)
        self.encoder = BertEncoderStack(
            hidden, config.NUM_HIDDEN_LAYERS, num_heads, config.get("INTERMEDIATE_SIZE")
        )

    def forward(self, token_ids, attention_bias, weights=None, generator=None):
        return self.encoder(self.embeddings(token_ids, generator), attention_bias,
                            weights=weights, generator=generator)


def feature_box_encoding(features, boxes, feat_linear, feat_ln, bbox_linear, bbox_ln,
                         rate: float = 0.0, generator=None):
    """dropout(LN(W feat) + LN(W bbox)): the FeatureBoxEncoding of the JAX
    package over the reference's flat modules (``linear_obj_feat_to_mmt_in``,
    ``obj_feat_layer_norm``, ...).  These LayerNorms have eps 1e-5."""
    return dropout(feat_ln(feat_linear(features)) + bbox_ln(bbox_linear(boxes)), rate, generator)


class OcrPtrNet(nn.Module):
    """Pointer scores q k^T / sqrt(d) + the additive OCR mask."""

    def __init__(self, hidden_size: int, query_key_size: Optional[int] = None):
        super().__init__()
        self.qk = query_key_size or hidden_size
        self.query = nn.Linear(hidden_size, self.qk)
        self.key = nn.Linear(hidden_size, self.qk)

    def project_keys(self, key_inputs):
        """(bs, K, qk) key projections: once per sequence, not per decode step."""
        return self.key(key_inputs)

    def score(self, query_inputs, keys, attention_bias):
        scores = self.query(query_inputs) @ keys.transpose(1, 2) / float(self.qk) ** 0.5
        return scores + attention_bias[:, 0]

    def forward(self, query_inputs, key_inputs, attention_bias):
        return self.score(query_inputs, self.project_keys(key_inputs), attention_bias)


class PrevPredEmbeddings(nn.Module):
    """Decode embeddings: rows of [LN(fixed answer emb) | LN(OCR emb)] plus
    dropout(LN(position + token type))."""

    def __init__(self, hidden_size: int, max_dec_length: int = 100, max_type_num: int = 5,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.ans_layer_norm = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.ocr_layer_norm = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.position_embeddings = nn.Embedding(max_dec_length, hidden_size)
        self.token_type_embeddings = nn.Embedding(max_type_num, hidden_size)
        self.emb_layer_norm = nn.LayerNorm(hidden_size, eps=LN_EPS)

    def build_table(self, ans_emb, ocr_emb):
        """The split LayerNormed lookup tables: shared (V, h) answers and
        per-sample (bs, K, h) OCR tokens; once per sequence when decoding."""
        return self.ans_layer_norm(ans_emb), self.ocr_layer_norm(ocr_emb)

    def embed_from_table(self, table, ans_num: int, prev_inds, position_offset: int = 0,
                         generator=None):
        ans_table, ocr_table = table
        prev_inds = prev_inds.long()
        # an id outside a table gives a zero row there, so the two lookups sum
        raw = take_rows_shared(ans_table, prev_inds) + take_rows(ocr_table, prev_inds - ans_num)
        positions = torch.arange(prev_inds.shape[1], device=prev_inds.device)[None] + position_offset
        types = (prev_inds >= ans_num).long()
        extra = self.emb_layer_norm(
            self.position_embeddings(positions) + self.token_type_embeddings(types)
        )
        return raw + dropout(extra, self.dropout, generator)

    def forward(self, ans_emb, ocr_emb, prev_inds, position_offset: int = 0, generator=None):
        table = self.build_table(ans_emb, ocr_emb)
        return self.embed_from_table(table, ans_emb.shape[0], prev_inds, position_offset,
                                     generator)


def _join(streams):
    """(emb, bias) pairs -> the joint (bs, L, h) input and (bs, 1, 1, L) bias."""
    return (torch.cat([emb for emb, _ in streams], dim=1),
            torch.cat([bias for _, bias in streams], dim=-1))


def _ocr_begin(txt_emb, obj_emb, pre_ocr_streams) -> int:
    return txt_emb.shape[1] + obj_emb.shape[1] + sum(emb.shape[1] for emb, _ in pre_ocr_streams)


class MMT(nn.Module):
    """Joint transformer over [txt, obj, ocr, dec] with the prefix-LM mask and a
    causal decoder block."""

    def __init__(self, hidden_size: int, num_layers: int, num_heads: int,
                 intermediate_size: Optional[int] = None):
        super().__init__()
        self.prev_pred_embeddings = PrevPredEmbeddings(hidden_size)
        self.encoder = BertEncoderStack(hidden_size, num_layers, num_heads, intermediate_size)

    def forward(self, txt_emb, txt_bias, obj_emb, obj_bias, ocr_emb, ocr_bias,
                fixed_ans_emb, prev_inds, context_blind: bool = False, weights=None,
                generator=None, pre_ocr_streams=(), extra_streams=()):
        """`pre_ocr_streams` and `extra_streams` are (emb, bias) pairs joined
        between obj and ocr and between ocr and dec (MMF_REGIONAL_M4C's grid
        stream, MMF_SAL's OCR word stream)."""
        dec_emb = self.prev_pred_embeddings(fixed_ans_emb, ocr_emb, prev_inds, generator=generator)
        bs, dec_len = dec_emb.shape[:2]
        dec_bias = torch.zeros((bs, 1, 1, dec_len), dtype=torch.float32, device=dec_emb.device)
        inputs, col_bias = _join([(txt_emb, txt_bias), (obj_emb, obj_bias), *pre_ocr_streams,
                                  (ocr_emb, ocr_bias), *extra_streams, (dec_emb, dec_bias)])
        total = inputs.shape[1]
        extended = col_bias.expand(bs, 1, total, total).clone()
        extended[:, :, -dec_len:, -dec_len:] = causal_bias(dec_len, dec_emb.device)
        if context_blind:
            # context rows cannot see decoder slots (upstream MMF semantics;
            # what makes the incremental decode exact)
            extended[:, :, : total - dec_len, -dec_len:] = MASK_VALUE
        encoded = self.encoder(inputs, extended, weights=weights, generator=generator)
        ocr_begin = _ocr_begin(txt_emb, obj_emb, pre_ocr_streams)
        return {
            "mmt_seq_output": encoded,
            "mmt_txt_output": encoded[:, : txt_emb.shape[1]],
            "mmt_ocr_output": encoded[:, ocr_begin : ocr_begin + ocr_emb.shape[1]],
            "mmt_dec_output": encoded[:, -dec_len:],
        }

    # -- incremental decoding -------------------------------------------------
    def encode_context(self, txt_emb, txt_bias, obj_emb, obj_bias, ocr_emb, ocr_bias,
                       weights=None, pre_ocr_streams=(), extra_streams=()) -> Dict:
        inputs, col_bias = _join([(txt_emb, txt_bias), (obj_emb, obj_bias), *pre_ocr_streams,
                                  (ocr_emb, ocr_bias), *extra_streams])
        ctx_out, layer_inputs = self.encoder(
            inputs, col_bias, return_layer_inputs=True, weights=weights
        )
        ocr_begin = _ocr_begin(txt_emb, obj_emb, pre_ocr_streams)
        return {
            "ctx_out": ctx_out,
            "context_kv": self.encoder.project_context(layer_inputs),
            "col_bias": col_bias,
            "ctx_len": inputs.shape[1],
            "ocr_begin": ocr_begin,
            "ocr_end": ocr_begin + ocr_emb.shape[1],
        }

    def init_fused_decode(self, context, dec_len: int, weights=None):
        return self.encoder.init_fused_decode_state(
            context["context_kv"], context["col_bias"], dec_len, weights
        )

    def build_dec_table(self, fixed_ans_emb, ocr_emb):
        return self.prev_pred_embeddings.build_table(fixed_ans_emb, ocr_emb)

    def embed_step(self, table, ans_num: int, prev_token, step: int):
        """(bs,) previous token -> (bs, 1, h) embedding at position `step`."""
        return self.prev_pred_embeddings.embed_from_table(
            table, ans_num, prev_token[:, None], position_offset=step
        )

    def fused_decode_step(self, dec_emb, state, step: int):
        return self.encoder.fused_decode_step(dec_emb, state, step)


def ocr_joint_features(batch, normalize: bool = True) -> torch.Tensor:
    """[fasttext, rec, det] OCR features, each L2-normalised."""
    parts = [batch["ocr_fasttext_features"], batch["ocr_rec_features"], batch["ocr_det_features"]]
    if normalize:
        parts = [l2_normalize(p) for p in parts]
    return torch.cat(parts, dim=-1)


def ocr_padding_bias(batch) -> torch.Tensor:
    """Padding bias of the concatenated (unnormalised) OCR features."""
    return padding_bias(ocr_joint_features(batch, normalize=False), padding_idx=0)

