"""The reference's standalone M4C: a BERT question encoder, then one BERT
encoder over [objects, OCR tokens, question, answer], with a vocab projection
and a pointer network over the encoded OCR tokens.

Counterpart of ``openvivqa_tpu/models/standalone_m4c.py``, under the
reference's torch names (``question_embedding``, ``question_encoder``,
``encoder``, ``vocab_proj``, ``dynamic_network``, the flat object / OCR
linears and LayerNorms), the names ``torch_conversion.convert_standalone_m4c``
reads.  What it keeps of the reference, as the JAX package does:

* the swapped box projections: object boxes go through
  ``linear_ocr_bbox_to_mmt_in``, OCR boxes through ``linear_obj_bbox_to_mmt_in``;
* OCR features in the order [det, rec, fasttext], each L2-normalised, with the
  padding bias of the det features alone;
* LayerNorm eps 1e-5 on the object and OCR encodings (BERT's is 1e-12);
* a question table of max(len(vocab), 30522) rows and the heads of
  ``MMT.NUM_ATTENTION_HEADS``; both stacks at BertConfig's default
  intermediate size of 3072 unless ``INTERMEDIATE_SIZE`` says otherwise;
* the answer stream is ``FixedVocabDynamicEmbedding`` over the rows of
  ``vocab_proj.weight`` and the OCR embeddings, with no position;
* in the joint bias every row sees each column's padding bias, except the
  answer block, which holds the causal mask alone.

The masks are additive 0 / MASK_VALUE, the sign the reference plainly
intends (it rescales its already-scaled masks a second time, which flips
them).  Eval routes: the question stack through kernels F and C, the joint
encode (a full (b, 1, L, L) bias) through the packed attention and kernel C;
the incremental greedy (``DECODING_MODE: incremental``, context-blind) one
context encode and then kernels D and C per token and layer.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..builders import META_ARCHITECTURE, build_text_embedding
from ..parallel.mesh import whole
from .m4c_common import OcrPtrNet, l2_normalize
from .mmf_m4c import _TORCH_LN_EPS, resolve_decoding_mode
from .modules.bert import BertEmbeddings, BertEncoderStack, dropout
from .modules.masks import causal_bias, padding_bias, prefix_lm_bias

# BertConfig's default, which the reference never overrides
_BERT_DEFAULT_INTERMEDIATE = 3072


@META_ARCHITECTURE.register()
class M4C(nn.Module):
    FEATURE_INPUTS = {  # as MMF_M4C's
        "OBJECT_EMBEDDING": ("region_features",),
        "OCR_EMBEDDING": ("ocr_det_features", "ocr_rec_features", "ocr_fasttext_features"),
    }

    def __init__(self, config, vocab):
        super().__init__()
        d_model = config.D_MODEL
        self.max_iter = vocab.max_answer_length
        self.bos_idx = vocab.bos_idx
        self.padding_idx = vocab.padding_idx
        self.decoding_mode, self.context_blind = resolve_decoding_mode(config)

        self.linear_obj_feat_to_mmt_in = nn.Linear(config.OBJECT_EMBEDDING.D_FEATURE, d_model)
        self.linear_obj_bbox_to_mmt_in = nn.Linear(4, d_model)
        self.linear_ocr_feat_to_mmt_in = nn.Linear(config.OCR_EMBEDDING.D_FEATURE, d_model)
        self.linear_ocr_bbox_to_mmt_in = nn.Linear(4, d_model)
        self.obj_feat_layer_norm = nn.LayerNorm(d_model, eps=_TORCH_LN_EPS)
        self.obj_bbox_layer_norm = nn.LayerNorm(d_model, eps=_TORCH_LN_EPS)
        self.ocr_feat_layer_norm = nn.LayerNorm(d_model, eps=_TORCH_LN_EPS)
        self.ocr_bbox_layer_norm = nn.LayerNorm(d_model, eps=_TORCH_LN_EPS)
        self.obj_dropout = config.OBJECT_EMBEDDING.DROPOUT
        self.ocr_dropout = config.OCR_EMBEDDING.DROPOUT

        text = config.TEXT_BERT
        self.num_heads = config.MMT.NUM_ATTENTION_HEADS
        self.question_embedding = BertEmbeddings(max(len(vocab), 30522), text.HIDDEN_SIZE)
        self.question_encoder = BertEncoderStack(
            text.HIDDEN_SIZE, text.NUM_HIDDEN_LAYERS, self.num_heads,
            text.get("INTERMEDIATE_SIZE") or _BERT_DEFAULT_INTERMEDIATE,
        )
        self.dynamic_embedding = build_text_embedding(config.DYNAMIC_EMBEDDING, vocab)
        enc = config.ENCODER
        self.encoder = BertEncoderStack(
            enc.SELF_ATTENTION.D_MODEL, enc.LAYERS, enc.SELF_ATTENTION.HEAD,
            enc.get("INTERMEDIATE_SIZE") or _BERT_DEFAULT_INTERMEDIATE,
        )
        # its weight rows double as the answer stream's fixed embeddings
        self.vocab_proj = nn.Linear(d_model, len(vocab))
        self.dynamic_network = OcrPtrNet(d_model)

    def kernel_weights(self) -> Dict:
        device = self.vocab_proj.weight.device
        return {"question": self.question_encoder.kernel_weights(device),
                "encoder": self.encoder.kernel_weights(device)}

    # -- streams ---------------------------------------------------------------------
    def _obj(self, batch, generator=None):
        # the reference's swap: object boxes through the OCR box projection
        emb = (self.obj_feat_layer_norm(self.linear_obj_feat_to_mmt_in(batch["region_features"]))
               + self.obj_bbox_layer_norm(self.linear_ocr_bbox_to_mmt_in(batch["region_boxes"])))
        return (dropout(emb, self.obj_dropout, generator),
                padding_bias(batch["region_features"], 0))

    def _ocr(self, batch, generator=None):
        joint = torch.cat([l2_normalize(batch[key]) for key in (
            "ocr_det_features", "ocr_rec_features", "ocr_fasttext_features")], dim=-1)
        # ...and OCR boxes through the object box projection
        emb = (self.ocr_feat_layer_norm(self.linear_ocr_feat_to_mmt_in(joint))
               + self.ocr_bbox_layer_norm(self.linear_obj_bbox_to_mmt_in(batch["ocr_boxes"])))
        return (dropout(emb, self.ocr_dropout, generator),
                padding_bias(batch["ocr_det_features"], 0))

    def _question(self, batch, weights, generator=None):
        bias = padding_bias(batch["question_tokens"], self.padding_idx)
        emb = self.question_embedding(batch["question_tokens"], generator)
        return self.question_encoder(emb, bias, weights=weights, generator=generator), bias

    def _streams(self, batch, weights, generator=None):
        """The streams no decode step changes: objects, OCR tokens, question."""
        return (self._obj(batch, generator), self._ocr(batch, generator),
                self._question(batch, None if weights is None else weights["question"],
                               generator))

    def _outputs(self, dec_out, ocr_out, ocr_bias):
        return torch.cat([self.vocab_proj(dec_out), self.dynamic_network(dec_out, ocr_out,
                                                                         ocr_bias)], dim=-1)

    def _scores_from_streams(self, streams, prev_inds, weights, generator=None):
        (obj_emb, obj_bias), (ocr_emb, ocr_bias), (q_emb, q_bias) = streams
        ans_emb, (ans_bias, _) = self.dynamic_embedding(prev_inds, ocr_emb,
                                                        whole(self.vocab_proj.weight))
        joint = torch.cat([obj_emb, ocr_emb, q_emb, ans_emb], dim=1)
        ans_len = ans_emb.shape[1]
        # the answer block holds the causal mask alone (answer padding dropped there)
        extended = prefix_lm_bias(torch.cat([obj_bias, ocr_bias, q_bias], dim=-1), ans_bias,
                                  causal_bias(ans_len, joint.device), self.context_blind)
        encoded = self.encoder(joint, extended,
                               weights=None if weights is None else weights["encoder"],
                               generator=generator)
        obj_len, ocr_len = obj_emb.shape[1], ocr_emb.shape[1]
        return self._outputs(encoded[:, -ans_len:], encoded[:, obj_len:obj_len + ocr_len],
                             ocr_bias)

    @torch.no_grad()
    def compute_scores(self, batch, prev_inds):
        weights = self.kernel_weights()
        return self._scores_from_streams(self._streams(batch, weights), prev_inds, weights)

    def forward(self, batch, generator=None) -> Dict:
        """Teacher-forced scores (bs, T, V + K) on batch["answer_tokens"]: the
        eval route without a `generator`, the training route with one."""
        if generator is None:
            return {"scores": self.compute_scores(batch, batch["answer_tokens"])}
        streams = self._streams(batch, None, generator)
        return {"scores": self._scores_from_streams(streams, batch["answer_tokens"], None,
                                                    generator)}

    # -- greedy decoding ---------------------------------------------------------------
    @torch.no_grad()
    def greedy_decode(self, batch) -> Dict:
        """max_iter joint re-encodes from a prefix of padding after <bos>; with
        DECODING_MODE incremental, the KV-cached decode instead."""
        if self.decoding_mode == "incremental":
            return self.incremental_greedy_decode(batch)
        weights = self.kernel_weights()
        streams = self._streams(batch, weights)
        bs = batch["question_tokens"].shape[0]
        prev_inds = torch.full((bs, self.max_iter), self.padding_idx, dtype=torch.long,
                               device=batch["question_tokens"].device)
        prev_inds[:, 0] = self.bos_idx
        for _ in range(self.max_iter):
            scores = self._scores_from_streams(streams, prev_inds, weights)
            prev_inds = torch.cat([prev_inds[:, :1], scores.argmax(dim=-1)[:, :-1]], dim=1)
        return {"scores": scores, "prev_inds": prev_inds}

    @torch.no_grad()
    def incremental_greedy_decode(self, batch) -> Dict:
        """Encode [objects, OCR, question] once, then one token per step
        through kernels D and C against the frozen context K/V and the slot
        caches; equal to the quadratic greedy under CONTEXT_BLIND."""
        weights = self.kernel_weights()
        (obj_emb, obj_bias), (ocr_emb, ocr_bias), (q_emb, q_bias) = self._streams(batch, weights)
        ctx = torch.cat([obj_emb, ocr_emb, q_emb], dim=1)
        col_bias = torch.cat([obj_bias, ocr_bias, q_bias], dim=-1)
        ctx_out, layer_inputs = self.encoder(ctx, col_bias, return_layer_inputs=True,
                                             weights=weights["encoder"])
        obj_len, ocr_len = obj_emb.shape[1], ocr_emb.shape[1]
        ptr_keys = self.dynamic_network.project_keys(ctx_out[:, obj_len:obj_len + ocr_len])
        state = self.encoder.init_fused_decode_state(
            self.encoder.project_context(layer_inputs), col_bias, self.max_iter,
            weights["encoder"])

        bs = batch["question_tokens"].shape[0]
        bos = torch.full((bs,), self.bos_idx, dtype=torch.long, device=ctx.device)
        token, all_scores = bos, []
        fixed_rows = whole(self.vocab_proj.weight)
        for step in range(self.max_iter):
            dec_emb, _ = self.dynamic_embedding(token[:, None], ocr_emb, fixed_rows)
            out = self.encoder.fused_decode_step(dec_emb, state, step)
            scores = torch.cat([self.vocab_proj(out),
                                self.dynamic_network.score(out, ptr_keys, ocr_bias)],
                               dim=-1)[:, 0]
            token = scores.argmax(dim=-1)
            all_scores.append(scores)
        scores = torch.stack(all_scores, dim=1)
        prev_inds = torch.cat([bos[:, None], scores[:, :-1].argmax(dim=-1)], dim=1)
        return {"scores": scores, "prev_inds": prev_inds}
