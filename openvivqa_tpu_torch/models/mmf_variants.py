"""The MMF_M4C variants: an extra MMT stream (MMF_REGIONAL_M4C, MMF_SAL), a
frozen pretrained question backbone (MMF_LanguageAdaptiveM4C), and the
encoder/decoder split of the Iterative M4C family (MMF_IterativeM4C,
MMF_Iterative_Multilevel_M4C).

Counterpart of ``openvivqa_tpu/models/mmf_variants.py``.  Parameter names are
the reference's torch names, the ones ``torch_conversion.convert_mmf_regional_m4c``,
``convert_mmf_iterative_m4c`` and ``convert_mmf_language_adaptive`` read
(MMF_SAL has no reference checkpoints; ``models/convert.py`` bridges it by hand).

The Iterative family: TextBert, then a joint BERT encoder over [question,
objects, OCR tokens] (eval: kernels F and C), then a BERT decoder of
cross-attention layers over the answer prefix with a causal bias, whose layer i
cross-attends the encoder's output, or, in the multilevel variant, the encoder's
layer i.  The joint encoder never sees the decoder, so the incremental greedy
(``DECODING_MODE: incremental``) is exact: one encode, then one token per step
through every decoder layer with kernel A (self-attention over a bf16 ring on
the card), kernel E (cross-attention over the frozen encoder K/V, projected once
per sequence) and kernel C, all at the BertLayer eps of 1e-12, when 'layer' is
among ``decode_kernel_parts()``; otherwise through the modules' plain decode
route (per-layer float32 K/V caches and the packed attention).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..builders import META_ARCHITECTURE
from ..ops import _cuda
from ..ops import decode_step as _ds
from ..parallel.mesh import whole
from ..utils import tracing
from .m4c_common import PrevPredEmbeddings, feature_box_encoding, l2_normalize
from .mmf_m4c import _TORCH_LN_EPS, MMF_M4C
from .modules.bert import LN_EPS, BertEmbeddings, BertEncoderStack
from .modules.masks import MASK_VALUE, causal_bias, padding_bias, validity_to_bias
from .modules.pretrained_embeddings import backbone_table_rows

_FASTTEXT_DIM = 300  # the OCR tokens' FastText vectors, as the data layer emits them


@META_ARCHITECTURE.register()
class MMF_REGIONAL_M4C(MMF_M4C):
    """A grid ("region") stream between the objects and the OCR tokens, encoded
    as the objects are (``linear_region_*``, ``region_*_layer_norm``)."""

    def __init__(self, config, vocab):
        super().__init__(config, vocab)
        region = config.REGION_EMBEDDING
        hidden = self.hidden_size
        self.region_dropout = region.DROPOUT
        self.linear_region_feat_to_mmt_in = nn.Linear(region.D_FEATURE, hidden)
        self.linear_region_bbox_to_mmt_in = nn.Linear(4, hidden)
        self.region_feat_layer_norm = nn.LayerNorm(hidden, eps=_TORCH_LN_EPS)
        self.region_bbox_layer_norm = nn.LayerNorm(hidden, eps=_TORCH_LN_EPS)

    def _mmt_streams(self, batch, weights, generator=None) -> Dict:
        streams = super()._mmt_streams(batch, weights, generator)
        region_emb = feature_box_encoding(
            batch["grid_features"], batch["grid_boxes"],
            self.linear_region_feat_to_mmt_in, self.region_feat_layer_norm,
            self.linear_region_bbox_to_mmt_in, self.region_bbox_layer_norm,
            self.region_dropout, generator,
        )
        region_bias = padding_bias(batch["grid_features"], 0)
        return {**streams, "pre_ocr": ((region_emb, region_bias),)}


@META_ARCHITECTURE.register()
class MMF_SAL(MMF_M4C):
    """An extra MMT stream after the OCR tokens: LN(W l2norm(OCR FastText
    vectors)) under the OCR padding bias."""

    def __init__(self, config, vocab):
        super().__init__(config, vocab)
        self.ocr_word_proj = nn.Linear(_FASTTEXT_DIM, self.hidden_size)
        self.ocr_word_norm = nn.LayerNorm(self.hidden_size, eps=LN_EPS)

    def _mmt_streams(self, batch, weights, generator=None) -> Dict:
        streams = super()._mmt_streams(batch, weights, generator)
        word_emb = self.ocr_word_norm(
            self.ocr_word_proj(l2_normalize(batch["ocr_fasttext_features"]))
        )
        return {**streams, "extra": ((word_emb, streams["ocr"][1]),)}


class _Backbone(nn.Module):
    """A BERT-layout pretrained model: ``embeddings`` and ``encoder``."""

    def __init__(self, vocab_size: int, hidden: int, layers: int, heads: int, d_ff):
        super().__init__()
        self.embeddings = BertEmbeddings(vocab_size, hidden)
        self.encoder = BertEncoderStack(hidden, layers, heads, d_ff)


class AdaptiveTextBert(nn.Module):
    """The reference's PretrainedAdaptiveTextBert: the frozen backbone
    (``embedding``), a projection to the MMT width when the widths differ
    (``text_bert_out_linear``), and a trainable BERT encoder (``encoder``)."""

    def __init__(self, config, num_heads: int, hidden: int, vocab_len: int):
        super().__init__()
        d_language = int(config.get("D_LANGUAGE") or 768)
        self.embedding = _Backbone(
            backbone_table_rows(config, vocab_len), d_language,
            int(config.get("PRETRAINED_LAYERS") or 12),
            int(config.get("PRETRAINED_HEADS") or max(1, d_language // 64)),
            config.get("PRETRAINED_INTERMEDIATE_SIZE"),
        )
        self.embedding.requires_grad_(False)  # frozen, as the reference freezes it
        self.text_bert_out_linear = (
            nn.Linear(d_language, hidden) if d_language != hidden else None
        )
        self.encoder = BertEncoderStack(hidden, config.NUM_HIDDEN_LAYERS, num_heads,
                                        config.get("INTERMEDIATE_SIZE"))


@META_ARCHITECTURE.register()
class MMF_LanguageAdaptiveM4C(MMF_M4C):
    """The question stream of a frozen multilingual backbone (e.g.
    vinai/phobert-base, 12 layers at D_LANGUAGE 768; random weights unless a
    checkpoint is loaded), projected to the MMT width and fine-tuned by a
    trainable BERT encoder.  The backbone always runs the eval route under
    ``torch.no_grad()``: no dropout and no gradient, as the JAX package's
    ``stop_gradient``.  Question ids are ``question_backbone_tokens`` (with
    ``question_backbone_mask``, or padding id PRETRAINED_PAD_ID) when the batch
    has them, else the vocab's ``question_tokens``."""

    def _build_text(self, config, vocab):
        self.uses_text_proj = False
        self.text_bert = AdaptiveTextBert(config.TEXT_BERT, self.num_heads, self.hidden_size,
                                          len(vocab))
        self.pretrained_pad_id = int(config.TEXT_BERT.get("PRETRAINED_PAD_ID") or 0)

    def kernel_weights(self) -> Dict:
        device = self.classifier.weight.device
        return {
            "backbone": self.text_bert.embedding.encoder.kernel_weights(device),
            "text": self.text_bert.encoder.kernel_weights(device),
            "mmt": self.mmt.encoder.kernel_weights(device),
        }

    def _txt(self, batch, weights, generator=None):
        if "question_backbone_tokens" in batch:
            tokens = batch["question_backbone_tokens"]
            if "question_backbone_mask" in batch:
                txt_bias = validity_to_bias(batch["question_backbone_mask"])
            else:
                txt_bias = padding_bias(tokens, self.pretrained_pad_id)
        else:
            tokens = batch["question_tokens"]
            txt_bias = padding_bias(tokens, self.padding_idx)
        text = self.text_bert
        with torch.no_grad():
            encoded = text.embedding.encoder(
                text.embedding.embeddings(tokens), txt_bias,
                weights=None if weights is None else weights["backbone"],
            )
        if text.text_bert_out_linear is not None:
            encoded = text.text_bert_out_linear(encoded)
        encoded = text.encoder(encoded, txt_bias,
                               weights=None if weights is None else weights["text"],
                               generator=generator)
        return encoded, txt_bias


class _IterativeM4CBase(MMF_M4C):
    """TextBert + joint encoder + cross-attention decoder; no MMT."""

    multilevel = False

    def _projects_text(self, text_hidden: int) -> bool:
        # only where the widths differ (the reference's iterative file has no
        # projection at all and would fail there)
        return text_hidden != self.hidden_size

    def _build_joint(self, config, num_layers: int, intermediate_size):
        enc = config.get("ENCODER") or config.MMT
        dec = config.get("DECODER") or config.MMT
        hidden, heads = self.hidden_size, self.num_heads
        self.encoder = BertEncoderStack(
            hidden, int(enc.get("LAYERS", enc.get("NUM_HIDDEN_LAYERS"))), heads,
            enc.get("INTERMEDIATE_SIZE"),
        )
        self.prev_pred_embeddings = PrevPredEmbeddings(hidden)
        self.decoder = BertEncoderStack(
            hidden, int(dec.get("LAYERS", dec.get("NUM_HIDDEN_LAYERS"))), heads,
            dec.get("INTERMEDIATE_SIZE"), cross_attention=True,
        )
        if self.multilevel and len(self.decoder.layer) > len(self.encoder.layer):
            raise ValueError("the multilevel decoder needs an encoder layer for each of its "
                             f"{len(self.decoder.layer)} layers, got {len(self.encoder.layer)}")

    def kernel_weights(self) -> Dict:
        device = self.classifier.weight.device
        return {
            "text": self.text_bert.encoder.kernel_weights(device),
            "encoder": self.encoder.kernel_weights(device),
            "decoder": self.decoder.kernel_weights(device),
        }

    def _encode_joint(self, batch, weights, generator=None) -> Dict:
        streams = self._mmt_streams(batch, weights, generator)
        (txt_emb, txt_bias), (obj_emb, obj_bias), (ocr_emb, ocr_bias) = (
            streams["txt"], streams["obj"], streams["ocr"])
        enc_bias = torch.cat([txt_bias, obj_bias, ocr_bias], dim=-1)
        encoded = self.encoder(
            torch.cat([txt_emb, obj_emb, ocr_emb], dim=1), enc_bias,
            weights=None if weights is None else weights["encoder"], generator=generator,
            return_all=self.multilevel,
        )
        all_states = None
        if self.multilevel:
            encoded, all_states = encoded
        ocr_begin = txt_emb.shape[1] + obj_emb.shape[1]
        return {
            "encoded": encoded, "all_states": all_states, "enc_bias": enc_bias,
            "ocr_emb": ocr_emb, "ocr_bias": ocr_bias,
            "ocr_begin": ocr_begin, "ocr_end": ocr_begin + ocr_emb.shape[1],
        }

    def _greedy_invariants(self, batch, weights, generator=None):
        # the whole joint encode is independent of the answer prefix
        return self._encode_joint(batch, weights, generator)

    def _cross_states(self, enc, i: int):
        return enc["all_states"][i] if self.multilevel else enc["encoded"]

    def _scores_from_streams(self, enc, prev_inds, weights, generator=None):
        dec = self.prev_pred_embeddings(whole(self.classifier.weight), enc["ocr_emb"], prev_inds,
                                        generator=generator)
        dec_bias = causal_bias(dec.shape[1], dec.device)
        layer_weights = [None] * len(self.decoder.layer) if weights is None else weights["decoder"]
        for i, (layer, w) in enumerate(zip(self.decoder.layer, layer_weights)):
            dec = layer(dec, dec_bias, w, generator, self._cross_states(enc, i), enc["enc_bias"])
        fixed = self.classifier(dec)
        dynamic = self.ocr_ptr_net(
            dec, enc["encoded"][:, enc["ocr_begin"]:enc["ocr_end"]], enc["ocr_bias"]
        )
        return torch.cat([fixed, dynamic], dim=-1)

    # -- the incremental decode --------------------------------------------------
    def _init_dec_state(self, enc, layer_weights) -> Dict:
        """Once per sequence: each decoder layer's cross-attention K/V of its
        encoder states, and zeroed self-attention caches.  The fused route
        (kernels A, E, C) keeps both in the kernel dtype (bf16 on the card), the
        rings with a float32 bias ring, and the (bs, S) encoder bias; the plain
        route keeps float32 caches."""
        encoded = enc["encoded"]
        bs, enc_len, hd = encoded.shape
        fused = "layer" in _ds.decode_kernel_parts()
        dtype = _cuda.kernel_dtype(encoded.device) if fused else torch.float32

        def zeros(*shape, dtype=dtype):
            return torch.zeros(shape, dtype=dtype, device=encoded.device)

        cross_kvs = tuple(
            tuple(x.to(dtype).contiguous() for x in layer.project_cross_kv(self._cross_states(enc, i)))
            for i, layer in enumerate(self.decoder.layer)
        )
        state = {"fused": fused, "weights": layer_weights, "cross_kvs": cross_kvs}
        if fused:
            state["enc_bias"] = enc["enc_bias"][:, 0, 0, :].expand(bs, enc_len).float().contiguous()
            state["step_bias"] = zeros(bs, dtype=torch.float32)
            state["rings"] = tuple(
                (zeros(bs, self.max_iter, hd), zeros(bs, self.max_iter, hd),
                 zeros(bs, self.max_iter, dtype=torch.float32))
                for _ in self.decoder.layer
            )
        else:
            state["enc_bias"] = enc["enc_bias"]
            state["caches"] = tuple((zeros(bs, self.max_iter, hd), zeros(bs, self.max_iter, hd))
                                    for _ in self.decoder.layer)
        return state

    def _dec_step(self, state, dec, step: int):
        """One (bs, 1, hd) token through every decoder layer; writes the
        caches in `state` in place."""
        if not state["fused"]:
            positions = torch.arange(self.max_iter, device=dec.device)
            step_bias = torch.where(positions <= step, 0.0, MASK_VALUE)[None, None, None, :]
            for layer, (k_cache, v_cache), cross_kv in zip(
                    self.decoder.layer, state["caches"], state["cross_kvs"]):
                k_new, v_new = layer.project_kv(dec)
                k_cache[:, step] = k_new[:, 0]
                v_cache[:, step] = v_new[:, 0]
                dec = layer.decode_step(dec, k_cache, v_cache, step_bias, cross_kv,
                                        state["enc_bias"])
            return dec
        scale = 1.0 / float(self.hidden_size // self.num_heads) ** 0.5
        heads = self.num_heads
        x = dec[:, 0, :].float().contiguous()
        for w, ring, cross_kv in zip(state["weights"], state["rings"], state["cross_kvs"]):
            x, _, _, _ = _ds.fused_self_attention_step(
                x, w["attention"], state["step_bias"], step, *ring, scale, heads, LN_EPS
            )
            x = _ds.fused_cross_attention_streamed(
                x, w["crossattention"], cross_kv, state["enc_bias"], scale, heads, LN_EPS
            )
            f = w["ffn"]
            x = _ds.fused_ffn_step(
                x, f["w1"], f["b1"], f["w2"], f["b2"], f["ln_scale"], f["ln_bias"], eps=LN_EPS
            )
        return x[:, None, :]

    @torch.no_grad()
    def incremental_greedy_decode(self, batch) -> Dict:
        """One joint encode, then one token per step through the decoder
        layers against the frozen encoder K/V and the growing self-attention
        caches: equal to the quadratic greedy."""
        with tracing.span("decode.encode"):
            weights = self.kernel_weights()
            enc = self._encode_joint(batch, weights)
            state = self._init_dec_state(enc, weights["decoder"])
            fixed_ans_emb = whole(self.classifier.weight)
            table = self.prev_pred_embeddings.build_table(fixed_ans_emb, enc["ocr_emb"])
            ans_num = fixed_ans_emb.shape[0]
            ptr_keys = self.ocr_ptr_net.project_keys(
                enc["encoded"][:, enc["ocr_begin"]:enc["ocr_end"]])

        bs = batch["question_tokens"].shape[0]
        bos = torch.full((bs,), self.bos_idx, dtype=torch.long, device=ptr_keys.device)
        token, all_scores = bos, []
        for step in range(self.max_iter):
            with tracing.span("decode.step"):
                dec = self.prev_pred_embeddings.embed_from_table(
                    table, ans_num, token[:, None], position_offset=step)
                out = self._dec_step(state, dec, step)
                scores = torch.cat([self.classifier(out),
                                    self.ocr_ptr_net.score(out, ptr_keys, enc["ocr_bias"])],
                                   dim=-1)[:, 0]
                token = scores.argmax(dim=-1)
                all_scores.append(scores)
        scores = torch.stack(all_scores, dim=1)
        prev_inds = torch.cat([bos[:, None], scores[:, :-1].argmax(dim=-1)], dim=1)
        return {"scores": scores, "prev_inds": prev_inds}


@META_ARCHITECTURE.register()
class MMF_IterativeM4C(_IterativeM4CBase):
    multilevel = False


@META_ARCHITECTURE.register()
class MMF_Iterative_Multilevel_M4C(_IterativeM4CBase):
    """Decoder layer i cross-attends the joint encoder's layer i."""

    multilevel = True
