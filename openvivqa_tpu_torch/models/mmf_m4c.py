"""MMF_M4C: TextBert + the MMT joint encoder + classifier and pointer heads,
with the teacher-forced forward (eval, or training with dropout drawn from a
generator) and both greedy decodes.

Counterpart of ``openvivqa_tpu/models/mmf_m4c.py``, with its
MMF_ImprovedDecodingM4C and experimental_MMF_M4C.  The decode loops are
Python loops over ``max_answer_length`` steps with static shapes:
  * ``greedy_decode`` (the quadratic greedy): T full MMT re-encodes under the
    prefix-LM bias, the MMT attention through the packed kernel;
  * ``incremental_greedy_decode`` (``MODEL.DECODING_MODE: incremental``): one
    context encode, then T single-token steps through kernels D and C.
Both argmax with torch.argmax, which, like jnp.argmax, takes the first maximum.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..builders import META_ARCHITECTURE
from ..parallel.mesh import whole
from .m4c_common import (
    MMT,
    OcrPtrNet,
    TextBert,
    feature_box_encoding,
    ocr_joint_features,
    ocr_padding_bias,
)
from .modules.bert import BertEncoderStack
from .modules.masks import padding_bias

_TORCH_LN_EPS = 1e-5  # the reference's plain nn.LayerNorm on the feature encodings


def resolve_decoding_mode(config):
    """(decoding_mode, context_blind) from the MODEL config node.  DECODING_MODE
    "incremental" implies CONTEXT_BLIND; unset keeps the reference's mask."""
    mode = config.get("DECODING_MODE")
    if mode not in (None, "incremental"):
        raise ValueError(f"MODEL.DECODING_MODE must be 'incremental' or unset, got {mode!r}")
    return mode, bool(config.get("CONTEXT_BLIND") or mode == "incremental")


@META_ARCHITECTURE.register()
class MMF_M4C(nn.Module):
    # the data fields whose summed widths are each stream's input width
    # (``builders.build_model``): flax infers them, a config may misstate them
    FEATURE_INPUTS = {
        "OBJECT_EMBEDDING": ("region_features",),
        "OCR_EMBEDDING": ("ocr_fasttext_features", "ocr_rec_features", "ocr_det_features"),
    }

    def __init__(self, config, vocab):
        super().__init__()
        mmt = config.get("MMT") or config.get("ENCODER")
        self.hidden_size = mmt.get("HIDDEN_SIZE", mmt.get("D_MODEL", config.D_MODEL))
        self.num_heads = mmt.get("NUM_ATTENTION_HEADS", mmt.get("HEAD", 8))
        mmt_layers = mmt.get("NUM_HIDDEN_LAYERS", mmt.get("LAYERS", 4))
        self.max_iter = vocab.max_answer_length
        self.bos_idx = vocab.bos_idx
        self.padding_idx = vocab.padding_idx
        self.decoding_mode, self.context_blind = resolve_decoding_mode(config)
        hidden = self.hidden_size

        self._build_text(config, vocab)
        self.obj_dropout = config.OBJECT_EMBEDDING.DROPOUT
        self.ocr_dropout = config.OCR_EMBEDDING.DROPOUT
        self.linear_obj_feat_to_mmt_in = nn.Linear(config.OBJECT_EMBEDDING.D_FEATURE, hidden)
        self.linear_obj_bbox_to_mmt_in = nn.Linear(4, hidden)
        self.obj_feat_layer_norm = nn.LayerNorm(hidden, eps=_TORCH_LN_EPS)
        self.obj_bbox_layer_norm = nn.LayerNorm(hidden, eps=_TORCH_LN_EPS)
        self.linear_ocr_feat_to_mmt_in = nn.Linear(config.OCR_EMBEDDING.D_FEATURE, hidden)
        self.linear_ocr_bbox_to_mmt_in = nn.Linear(4, hidden)
        self.ocr_feat_layer_norm = nn.LayerNorm(hidden, eps=_TORCH_LN_EPS)
        self.ocr_bbox_layer_norm = nn.LayerNorm(hidden, eps=_TORCH_LN_EPS)
        self._build_joint(config, mmt_layers, mmt.get("INTERMEDIATE_SIZE"))
        # the classifier weight (V, h) doubles as the fixed answer embedding
        self.classifier = nn.Linear(hidden, len(vocab))
        ptr = config.get("OCR_PTR_NET")
        self.ocr_ptr_net = OcrPtrNet(
            ptr.HIDDEN_SIZE if ptr else hidden, ptr.get("QUERY_KEY_SIZE") if ptr else None
        )

    # -- construction hooks (the variants' modules) ----------------------------
    def _build_text(self, config, vocab):
        """The question encoder: TextBert, and its projection where
        `_projects_text` says so."""
        text_hidden = config.TEXT_BERT.HIDDEN_SIZE
        self.text_bert = TextBert(config.TEXT_BERT, self.num_heads, len(vocab))
        self.uses_text_proj = self._projects_text(text_hidden)
        if self.uses_text_proj:
            self.text_bert_out_linear = nn.Linear(text_hidden, self.hidden_size)

    def _projects_text(self, text_hidden: int) -> bool:
        # the reference's rule: a projection exists iff the MMT is not 768 wide;
        # also where the text width differs from the MMT's
        return self.hidden_size != 768 or text_hidden != self.hidden_size

    def _build_joint(self, config, num_layers: int, intermediate_size):
        self.mmt = MMT(self.hidden_size, num_layers, self.num_heads, intermediate_size)

    # -- encodings -------------------------------------------------------------
    def kernel_weights(self) -> Dict:
        """Kernel weight bundles of both stacks, built once per forward or decode."""
        device = self.classifier.weight.device
        return {
            "text": self.text_bert.encoder.kernel_weights(device),
            "mmt": self.mmt.encoder.kernel_weights(device),
        }

    def _txt(self, batch, weights, generator=None):
        """(txt_emb, txt_bias) of the question stream."""
        txt_bias = padding_bias(batch["question_tokens"], self.padding_idx)
        txt_emb = self.text_bert(batch["question_tokens"], txt_bias,
                                 None if weights is None else weights["text"], generator)
        if self.uses_text_proj:
            txt_emb = self.text_bert_out_linear(txt_emb)
        return txt_emb, txt_bias

    def _obj(self, batch, generator=None):
        """(obj_emb, obj_bias) of the object stream."""
        obj_emb = feature_box_encoding(
            batch["region_features"], batch["region_boxes"],
            self.linear_obj_feat_to_mmt_in, self.obj_feat_layer_norm,
            self.linear_obj_bbox_to_mmt_in, self.obj_bbox_layer_norm,
            self.obj_dropout, generator,
        )
        return obj_emb, padding_bias(batch["region_features"], 0)

    def _ocr(self, batch, generator=None):
        """(ocr_emb, ocr_bias) of the OCR stream."""
        ocr_emb = feature_box_encoding(
            ocr_joint_features(batch), batch["ocr_boxes"],
            self.linear_ocr_feat_to_mmt_in, self.ocr_feat_layer_norm,
            self.linear_ocr_bbox_to_mmt_in, self.ocr_bbox_layer_norm,
            self.ocr_dropout, generator,
        )
        return ocr_emb, ocr_padding_bias(batch)

    def _mmt_streams(self, batch, weights, generator=None) -> Dict:
        """The MMT's input streams; `weights` are the kernel bundles of an
        eval call (None with a training `generator`).  Variants add
        ``pre_ocr`` / ``extra`` (emb, bias) streams (MMF_REGIONAL_M4C, MMF_SAL)
        or change the question stream (MMF_LanguageAdaptiveM4C,
        experimental_MMF_M4C)."""
        return {
            "txt": self._txt(batch, weights, generator),
            "obj": self._obj(batch, generator),
            "ocr": self._ocr(batch, generator),
            "pre_ocr": (),
            "extra": (),
        }

    def _greedy_invariants(self, batch, weights, generator=None):
        """Everything independent of prev_inds, computed once per forward or
        greedy decode; `_scores_from_streams` consumes it."""
        return self._mmt_streams(batch, weights, generator)

    def _scores_from_streams(self, streams, prev_inds, weights, generator=None):
        results = self.mmt(
            *streams["txt"], *streams["obj"], *streams["ocr"],
            fixed_ans_emb=whole(self.classifier.weight), prev_inds=prev_inds,
            context_blind=self.context_blind,
            weights=None if weights is None else weights["mmt"], generator=generator,
            pre_ocr_streams=streams["pre_ocr"], extra_streams=streams["extra"],
        )
        fixed = self.classifier(results["mmt_dec_output"])
        dynamic = self.ocr_ptr_net(
            results["mmt_dec_output"], results["mmt_ocr_output"], streams["ocr"][1]
        )
        return torch.cat([fixed, dynamic], dim=-1)

    @torch.no_grad()
    def compute_scores(self, batch, prev_inds):
        weights = self.kernel_weights()
        return self._scores_from_streams(self._greedy_invariants(batch, weights), prev_inds,
                                         weights)

    def forward(self, batch, generator=None) -> Dict:
        """Teacher-forced scores (bs, T, V + K) on batch["answer_tokens"]: the
        eval route without a `generator`; with one, the training route, whose
        dropout draws from it, building a graph for autograd."""
        if generator is None:
            return {"scores": self.compute_scores(batch, batch["answer_tokens"])}
        streams = self._greedy_invariants(batch, None, generator)
        return {"scores": self._scores_from_streams(streams, batch["answer_tokens"], None,
                                                    generator)}

    # -- greedy decoding ---------------------------------------------------------
    @torch.no_grad()
    def greedy_decode(self, batch) -> Dict:
        """Quadratic greedy: max_iter full re-encodes; with DECODING_MODE
        incremental, the KV-cached decode instead."""
        if self.decoding_mode == "incremental":
            return self.incremental_greedy_decode(batch)
        weights = self.kernel_weights()
        streams = self._greedy_invariants(batch, weights)
        bs = batch["question_tokens"].shape[0]
        device = batch["question_tokens"].device
        prev_inds = torch.zeros((bs, self.max_iter), dtype=torch.long, device=device)
        prev_inds[:, 0] = self.bos_idx
        for step in range(self.max_iter):
            scores = self._scores_from_streams(streams, prev_inds, weights)
            prev_inds = self._update_prev_inds(prev_inds, scores, step)
        return {"scores": scores, "prev_inds": prev_inds}

    def _update_prev_inds(self, prev_inds, scores, step: int):
        """The quadratic greedy's next prefix: position i + 1 takes the argmax
        at position i."""
        prev_inds = prev_inds.clone()
        prev_inds[:, 1:] = scores.argmax(dim=-1)[:, :-1]
        return prev_inds

    @torch.no_grad()
    def incremental_greedy_decode(self, batch) -> Dict:
        """Encode [txt, obj, ocr] once, then one single-token step per position
        (kernels D and C) against read-only context K/V and in-place slot caches.
        Equal to the quadratic greedy under CONTEXT_BLIND."""
        weights = self.kernel_weights()
        streams = self._mmt_streams(batch, weights)
        ocr_emb, ocr_bias = streams["ocr"]
        context = self.mmt.encode_context(
            *streams["txt"], *streams["obj"], *streams["ocr"], weights=weights["mmt"],
            pre_ocr_streams=streams["pre_ocr"], extra_streams=streams["extra"],
        )
        ctx_ocr = context["ctx_out"][:, context["ocr_begin"]:context["ocr_end"]]
        state = self.mmt.init_fused_decode(context, self.max_iter, weights["mmt"])
        fixed_ans_emb = whole(self.classifier.weight)
        dec_table = self.mmt.build_dec_table(fixed_ans_emb, ocr_emb)
        ans_num = fixed_ans_emb.shape[0]
        ptr_keys = self.ocr_ptr_net.project_keys(ctx_ocr)

        bs = batch["question_tokens"].shape[0]
        bos = torch.full((bs,), self.bos_idx, dtype=torch.long, device=ptr_keys.device)
        token, all_scores = bos, []
        for step in range(self.max_iter):
            dec_emb = self.mmt.embed_step(dec_table, ans_num, token, step)
            out = self.mmt.fused_decode_step(dec_emb, state, step)
            fixed = self.classifier(out)
            dynamic = self.ocr_ptr_net.score(out, ptr_keys, ocr_bias)
            scores = torch.cat([fixed, dynamic], dim=-1)[:, 0]
            token = scores.argmax(dim=-1)
            all_scores.append(scores)
        scores = torch.stack(all_scores, dim=1)
        prev_inds = torch.cat([bos[:, None], scores[:, :-1].argmax(dim=-1)], dim=1)
        return {"scores": scores, "prev_inds": prev_inds}


@META_ARCHITECTURE.register()
class MMF_ImprovedDecodingM4C(MMF_M4C):
    """The quadratic greedy resets the prefix past step + 1 to 0 after each
    step, so that no position is conditioned on a stale prediction.  The
    incremental decode has no such prefix and keeps MMF_M4C's."""

    def _update_prev_inds(self, prev_inds, scores, step: int):
        updated = super()._update_prev_inds(prev_inds, scores, step)
        positions = torch.arange(updated.shape[1], device=updated.device)[None, :]
        return torch.where(positions <= step + 1, updated, torch.zeros_like(updated))


@META_ARCHITECTURE.register()
class experimental_MMF_M4C(MMF_M4C):  # noqa: N801 (the reference's name)
    """The question stream re-encoded by one cross-attention BERT layer over
    the object stream before it enters the MMT (``txt_context_encoder``: its
    self-attention through kernel F, its cross-attention through the packed
    attention, its FFN through kernel C).  The object stream is encoded twice
    per forward, here and as the MMT's own stream, so in training its dropout
    is drawn twice, as in the JAX package."""

    def __init__(self, config, vocab):
        super().__init__(config, vocab)
        self.txt_context_encoder = BertEncoderStack(self.hidden_size, 1, self.num_heads,
                                                    cross_attention=True)

    def kernel_weights(self) -> Dict:
        return {**super().kernel_weights(),
                "txt_context": self.txt_context_encoder.kernel_weights(
                    self.classifier.weight.device)}

    def _txt(self, batch, weights, generator=None):
        txt_emb, txt_bias = super()._txt(batch, weights, generator)
        obj_emb, obj_bias = self._obj(batch, generator)
        txt_emb = self.txt_context_encoder(
            txt_emb, txt_bias, weights=None if weights is None else weights["txt_context"],
            generator=generator, encoder_states=obj_emb, encoder_bias=obj_bias,
        )
        return txt_emb, txt_bias
