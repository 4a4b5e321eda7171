"""Weight bridge from the JAX package's flax parameter tree to the port's
``state_dict`` (numpy only).

The port's parameter names are the reference's torch names, the ones
``openvivqa_tpu.models.modules.torch_conversion``'s converters read
(``convert_mmf_m4c``, ``convert_mmf_regional_m4c``, ``convert_mmf_iterative_m4c``,
``convert_mmf_language_adaptive``, ``convert_standalone_m4c``, ``convert_mmf_lorra``,
``convert_iterative_mcan``, ``convert_joint_transformer``, ``convert_mcan``,
``convert_saaa``), so those
converters are this bridge's inverses and the port also loads the reference's own
checkpoints; the ViT, T5, ALBERT and DeBERTa backbones carry HF's names, which
``hf_conversion.convert_vit_weights``, ``convert_t5_encoder_weights``,
``convert_albert_weights`` and ``convert_deberta_v2_weights`` read (this bridge
is their inverse, and ``backbone_state`` maps one backbone's converted tree for
the pretrained-weights policy).
VanillaTransformer, ParallelAttentionTransformer, HierarchicalCoAttention,
IterativeM4C, UniqueTransformer, ExtendedMCAN, IterativeSAAA, the two dual-stream
models, the two ViTmBERT models and the hierarchical text embedding have no
reference converter (the
one the JAX package lists for ReadableIterativeMCAN, ``convert_iterative_mcan``,
reads IterativeMCAN's one-linear vision embedding, not ``VisionOcrEmbedding``), and
the JAX converters refuse experimental_MMF_M4C and MMF_IterativeLoRRA: their flax trees
(and those of the AdaptiveDecoder with its frozen language model, the geometry,
memory and adaptive attention cores, the AoA gates, the GeometricEncoder,
SpatialCirclePosition)
(``@nn.compact`` auto-names such as ``Encoder_0``, ``Dense_0``, ``Conv_0``) map
to the port's names here.  Flax Dense kernels are (in, out) and torch Linear
weights (out, in); flax Conv kernels (n, in, out) and Conv1d weights (out, in,
n); LayerNorm scale/bias become weight/bias; flax's LSTM cell keeps one bias,
on its hidden kernels, which becomes ``bias_hh_l0`` beside a zero ``bias_ih_l0``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

StateDict = Dict[str, np.ndarray]


def _arr(x) -> np.ndarray:
    return np.array(x, dtype=np.float32)  # a writable copy


def _linear(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = np.ascontiguousarray(_arr(tree["kernel"]).T)
    out[f"{name}.bias"] = _arr(tree["bias"])


def _layer_norm(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = _arr(tree["scale"])
    out[f"{name}.bias"] = _arr(tree["bias"])


def _embedding(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = _arr(tree["embedding"])


def _bert_attention(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    for flax_name, torch_name in (
        ("Dense_0", "self.query"),
        ("Dense_1", "self.key"),
        ("Dense_2", "self.value"),
        ("Dense_3", "output.dense"),
    ):
        _linear(out, f"{name}.{torch_name}", tree[flax_name])
    _layer_norm(out, f"{name}.output.LayerNorm", tree["LayerNorm_0"])


def _bert_layer(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """A BertLayer; its BertSelfAttention_1, where present, is the HF decoder's
    ``crossattention``."""
    _bert_attention(out, f"{name}.attention", tree["BertSelfAttention_0"])
    if "BertSelfAttention_1" in tree:
        _bert_attention(out, f"{name}.crossattention", tree["BertSelfAttention_1"])
    _linear(out, f"{name}.intermediate.dense", tree["Dense_0"])
    _linear(out, f"{name}.output.dense", tree["Dense_1"])
    _layer_norm(out, f"{name}.output.LayerNorm", tree["LayerNorm_0"])


def _bert_encoder(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    n_layers = sum(1 for key in tree if key.startswith("layer_"))
    for i in range(n_layers):
        _bert_layer(out, f"{name}.layer.{i}", tree[f"layer_{i}"])


def _feature_box(out: StateDict, prefix: str, tree: Mapping[str, Any]) -> None:
    _linear(out, f"linear_{prefix}_feat_to_mmt_in", tree["Dense_0"])
    _linear(out, f"linear_{prefix}_bbox_to_mmt_in", tree["Dense_1"])
    _layer_norm(out, f"{prefix}_feat_layer_norm", tree["LayerNorm_0"])
    _layer_norm(out, f"{prefix}_bbox_layer_norm", tree["LayerNorm_1"])


def _bert_embeddings(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    _embedding(out, f"{name}.word_embeddings", tree["Embed_0"])
    _embedding(out, f"{name}.position_embeddings", tree["Embed_1"])
    _embedding(out, f"{name}.token_type_embeddings", tree["Embed_2"])
    _layer_norm(out, f"{name}.LayerNorm", tree["LayerNorm_0"])


def _prev_pred_embeddings(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    _layer_norm(out, f"{name}.ans_layer_norm", tree["LayerNorm_0"])
    _layer_norm(out, f"{name}.ocr_layer_norm", tree["LayerNorm_1"])
    _layer_norm(out, f"{name}.emb_layer_norm", tree["LayerNorm_2"])
    _embedding(out, f"{name}.position_embeddings", tree["Embed_0"])
    _embedding(out, f"{name}.token_type_embeddings", tree["Embed_1"])


def _m4c_heads(out: StateDict, tree: Mapping[str, Any]) -> None:
    """The object and OCR encodings, the classifier and the pointer net."""
    _feature_box(out, "obj", tree["obj_encoding"])
    _feature_box(out, "ocr", tree["ocr_encoding"])
    out["classifier.weight"] = np.ascontiguousarray(_arr(tree["classifier_kernel"]).T)
    out["classifier.bias"] = _arr(tree["classifier_bias"])
    _linear(out, "ocr_ptr_net.query", tree["ocr_ptr_net"]["Dense_0"])
    _linear(out, "ocr_ptr_net.key", tree["ocr_ptr_net"]["Dense_1"])


def _text_bert(out: StateDict, tree: Mapping[str, Any]) -> None:
    text = tree["text_bert"]
    _bert_embeddings(out, "text_bert.embeddings", text["BertEmbeddings_0"])
    _bert_encoder(out, "text_bert.encoder", text["BertEncoderStack_0"])
    if "text_bert_out_linear" in tree:
        _linear(out, "text_bert_out_linear", tree["text_bert_out_linear"])


def _mmt(out: StateDict, tree: Mapping[str, Any]) -> None:
    _prev_pred_embeddings(out, "mmt.prev_pred_embeddings", tree["mmt"]["prev_pred_embeddings"])
    _bert_encoder(out, "mmt.encoder", tree["mmt"]["encoder"])


def _mmf_m4c(tree: Mapping[str, Any]) -> StateDict:
    """MMF_M4C, and MMF_REGIONAL_M4C and MMF_SAL by their extra modules.  The
    SAL stream has no reference checkpoint and no JAX converter: its names
    (``ocr_word_proj``, ``ocr_word_norm``) are the port's."""
    out: StateDict = {}
    _text_bert(out, tree)
    _mmt(out, tree)
    _m4c_heads(out, tree)
    if "region_encoding" in tree:
        _feature_box(out, "region", tree["region_encoding"])
    if "ocr_word_proj" in tree:
        _linear(out, "ocr_word_proj", tree["ocr_word_proj"])
        _layer_norm(out, "ocr_word_norm", tree["ocr_word_norm"])
    return out


def _mmf_language_adaptive(tree: Mapping[str, Any]) -> StateDict:
    """The frozen backbone under ``text_bert.embedding`` (an HF model's
    ``embeddings`` and ``encoder``), its projection and the fine-tuning encoder
    (``text_bert.encoder``), then MMF_M4C's MMT and heads."""
    out: StateDict = {}
    _bert_embeddings(out, "text_bert.embedding.embeddings", tree["language_embeddings"])
    _bert_encoder(out, "text_bert.embedding.encoder", tree["language_backbone"])
    if "language_proj" in tree:
        _linear(out, "text_bert.text_bert_out_linear", tree["language_proj"])
    _bert_encoder(out, "text_bert.encoder", tree["finetune_encoder"])
    _mmt(out, tree)
    _m4c_heads(out, tree)
    return out


def _mmf_iterative_m4c(tree: Mapping[str, Any]) -> StateDict:
    """MMF_IterativeM4C and its multilevel variant: TextBert, the joint
    ``encoder``, ``prev_pred_embeddings`` and the cross-attention ``decoder``."""
    out: StateDict = {}
    _text_bert(out, tree)
    _bert_encoder(out, "encoder", tree["joint_encoder"])
    _prev_pred_embeddings(out, "prev_pred_embeddings", tree["dec_embeddings"])
    n_layers = sum(1 for key in tree if key.startswith("dec_layer_"))
    for i in range(n_layers):
        _bert_layer(out, f"decoder.layer.{i}", tree[f"dec_layer_{i}"])
    _m4c_heads(out, tree)
    return out


def _experimental_mmf_m4c(tree: Mapping[str, Any]) -> StateDict:
    """experimental_MMF_M4C: MMF_M4C and its ``txt_context_encoder``, one
    cross-attention BertLayer.  Its JAX converter refuses it (the reference
    cannot build it): this bridge is written by hand."""
    out = _mmf_m4c(tree)
    _bert_encoder(out, "txt_context_encoder", tree["txt_context_encoder"])
    return out


def _standalone_m4c(tree: Mapping[str, Any]) -> StateDict:
    """The standalone M4C (the inverse of ``convert_standalone_m4c``): the flat
    object / OCR linears and LayerNorms, the question BERT, the joint encoder,
    ``vocab_proj`` (a kept (in, out) kernel) and the pointer network."""
    out: StateDict = {}
    for stream in ("obj", "ocr"):
        for part in ("feat", "bbox"):
            _linear(out, f"linear_{stream}_{part}_to_mmt_in", tree[f"linear_{stream}_{part}_to_mmt_in"])
            _layer_norm(out, f"{stream}_{part}_layer_norm", tree[f"{stream}_{part}_layer_norm"])
    _bert_embeddings(out, "question_embedding", tree["question_embedding"])
    _bert_encoder(out, "question_encoder", tree["question_encoder"])
    _bert_encoder(out, "encoder", tree["encoder"])
    out["vocab_proj.weight"] = np.ascontiguousarray(_arr(tree["vocab_proj_kernel"]).T)
    out["vocab_proj.bias"] = _arr(tree["vocab_proj_bias"])
    _linear(out, "dynamic_network.query", tree["dynamic_network"]["Dense_0"])
    _linear(out, "dynamic_network.key", tree["dynamic_network"]["Dense_1"])
    return out


def _iterative_m4c(tree: Mapping[str, Any]) -> StateDict:
    """IterativeM4C (no reference converter): its flax auto-names to the
    port's names."""
    out: StateDict = {}
    for name in ("region_embedding", "grid_embedding", "box_embedding", "ocr_det_embedding",
                 "ocr_rec_embedding", "ocr_embedding"):
        _linear(out, f"{name}.proj", tree[name]["Dense_0"])
    _text_embedding(out, "text_embedding", tree["text_embedding"])
    out["dynamic_embedding.fixed_weights"] = _arr(tree["dynamic_embedding"]["fixed_weights"])
    _encoder(out, "encoder", tree["encoder"])
    _linear(out, "vocab_proj", tree["vocab_proj"])
    _linear(out, "dynamic_network.query", tree["dynamic_network"]["Dense_0"])
    _linear(out, "dynamic_network.key", tree["dynamic_network"]["Dense_1"])
    return out


def _lorra_branches(out: StateDict, tree: Mapping[str, Any]) -> None:
    _text_embedding(out, "txt_embedding", tree["txt_embedding"])
    for name in ("txt_norm", "obj_feat_layer_norm", "ocr_feat_layer_norm"):
        _layer_norm(out, name, tree[name])
    for name in ("linear_obj_feat_to_mmt_in", "linear_ocr_feat_to_mmt_in"):
        _linear(out, name, tree[name])
    for branch in ("self_attn", "spatial_attn", "context_attn"):
        for projection in ("fc_q", "fc_k", "fc_v", "fc_o"):
            _linear(out, f"{branch}.{projection}", tree[branch][projection])


def _mmf_lorra(tree: Mapping[str, Any]) -> StateDict:
    """MMF_LoRRA (the inverse of ``convert_mmf_lorra``)."""
    out: StateDict = {}
    _lorra_branches(out, tree)
    _linear(out, "classifier", tree["classifier"])
    return out


def _mmf_iterative_lorra(tree: Mapping[str, Any]) -> StateDict:
    """MMF_IterativeLoRRA: the LoRRA branches, then MMF_M4C's MMT, classifier
    and pointer net.  Its JAX converter refuses it (the reference cannot build
    it): this bridge is written by hand."""
    out: StateDict = {}
    _lorra_branches(out, tree)
    _mmt(out, tree)
    out["classifier.weight"] = np.ascontiguousarray(_arr(tree["classifier_kernel"]).T)
    out["classifier.bias"] = _arr(tree["classifier_bias"])
    _linear(out, "ocr_ptr_net.query", tree["ocr_ptr_net"]["Dense_0"])
    _linear(out, "ocr_ptr_net.key", tree["ocr_ptr_net"]["Dense_1"])
    return out


def _attention_core(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """Any registered core: its Dense projections (``fc_q`` ... ``fc_o``, the
    geometry core's ``fc_g``, the adaptive core's ``fc_s``), the memory core's
    ``m_k`` / ``m_v`` slots and SpatialCirclePosition's ``dist_embedding``."""
    for key, value in tree.items():
        if key == "dist_embedding":
            _embedding(out, f"{name}.{key}", value)
        elif isinstance(value, Mapping):
            _linear(out, f"{name}.{key}", value)
        else:
            out[f"{name}.{key}"] = _arr(value)


def _multi_head_attention(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    _attention_core(out, f"{name}.attention", tree["attention"])
    _layer_norm(out, f"{name}.layer_norm", tree["layer_norm"])
    for gate in ("informative_attention", "gated_attention"):  # the AoA gates
        if gate in tree:
            _linear(out, f"{name}.{gate}", tree[gate])


def _positionwise_ffn(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    _linear(out, f"{name}.fc1", tree["Dense_0"])
    _linear(out, f"{name}.fc2", tree["Dense_1"])
    _layer_norm(out, f"{name}.layer_norm", tree["LayerNorm_0"])


def _text_embedding(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """UsualEmbedding: the learned table, or the projection of the vocab's
    frozen vectors (which are no parameter on either side)."""
    if "embedding" in tree:
        out[f"{name}.components.weight"] = _arr(tree["embedding"])
    else:
        _linear(out, f"{name}.components.1", tree["Dense_0"])


def _conv(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = np.ascontiguousarray(_arr(tree["kernel"]).transpose(2, 1, 0))
    out[f"{name}.bias"] = _arr(tree["bias"])


def _lstm(out: StateDict, name: str, cell: Mapping[str, Any]) -> None:
    """flax OptimizedLSTMCell (gates i, f, g, o; input kernels ``i*`` without
    bias, hidden kernels ``h*`` with the one bias) -> a one-layer nn.LSTM."""
    gates = "ifgo"
    out[f"{name}.weight_ih_l0"] = np.concatenate([_arr(cell[f"i{g}"]["kernel"]).T for g in gates])
    out[f"{name}.weight_hh_l0"] = np.concatenate([_arr(cell[f"h{g}"]["kernel"]).T for g in gates])
    out[f"{name}.bias_hh_l0"] = np.concatenate([_arr(cell[f"h{g}"]["bias"]) for g in gates])
    out[f"{name}.bias_ih_l0"] = np.zeros_like(out[f"{name}.bias_hh_l0"])


def _any_text_embedding(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """UsualEmbedding, LSTMTextEmbedding or the registered
    HierarchicalFeaturesExtractor, told apart by their subtrees."""
    if "_LSTM_0" in tree:
        if "embedding" in tree:
            out[f"{name}.embedding.weight"] = _arr(tree["embedding"])
        _linear(out, f"{name}.proj", tree["Dense_0"])
        _lstm(out, f"{name}.lstm", tree["_LSTM_0"]["OptimizedLSTMCell_0"])
    elif "UsualEmbedding_0" in tree:
        _text_embedding(out, f"{name}.embedding", tree["UsualEmbedding_0"])
        for i in range(sum(1 for key in tree if key.startswith("Conv_"))):
            _conv(out, f"{name}.convs.{i}", tree[f"Conv_{i}"])
    else:
        _text_embedding(out, name, tree)


def _layers(tree: Mapping[str, Any]):
    """(index, subtree) of a stack's ``layer_{i}`` entries, in order."""
    count = sum(1 for key in tree if key[6:].isdigit() and key.startswith("layer_"))
    return ((i, tree[f"layer_{i}"]) for i in range(count))


def _encoder(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """The self-attention ``Encoder``: its LayerNorm and layers."""
    _layer_norm(out, f"{name}.layer_norm", tree["layer_norm"])
    for i, layer in _layers(tree):
        _multi_head_attention(out, f"{name}.layers.{i}.mhatt", layer["mhatt"])
        _positionwise_ffn(out, f"{name}.layers.{i}.pwff", layer["pwff"])


def _guided_encoder(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """MCAN's ``GuidedAttentionEncoder``: its LayerNorm and guided layers."""
    _layer_norm(out, f"{name}.layer_norm", tree["layer_norm"])
    for i, layer in _layers(tree):
        prefix = f"{name}.guided_attn_layers.{i}"
        _multi_head_attention(out, f"{prefix}.self_mhatt", layer["self_mhatt"])
        _multi_head_attention(out, f"{prefix}.guided_mhatt", layer["guided_mhatt"])
        _positionwise_ffn(out, f"{prefix}.pwff", layer["pwff"])


def _co_attention_encoder(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """``CoAttentionEncoder``: the two stream LayerNorms and the ``vl_i``,
    ``lv_i``, ``vs_i``, ``ls_i`` layers."""
    _layer_norm(out, f"{name}.vision_layer_norm", tree["vision_layer_norm"])
    _layer_norm(out, f"{name}.language_layer_norm", tree["language_layer_norm"])
    for flax_name, torch_name in (("vl", "vision_language"), ("lv", "language_vision"),
                                  ("vs", "vision_self"), ("ls", "language_self")):
        count = sum(1 for key in tree if key.startswith(f"{flax_name}_"))
        for i in range(count):
            layer, prefix = tree[f"{flax_name}_{i}"], f"{name}.{torch_name}_attn_layers.{i}"
            _multi_head_attention(out, f"{prefix}.mhatt", layer["mhatt"])
            _positionwise_ffn(out, f"{prefix}.pwff", layer["pwff"])


def _attr_reduce(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    _linear(out, f"{name}.fc1", tree["Dense_0"])
    _linear(out, f"{name}.fc2", tree["Dense_1"])


def _dual_stream_head(out: StateDict, tree: Mapping[str, Any]) -> None:
    """``DualStreamClassifier``'s tree -> the head's names on the model."""
    _attr_reduce(out, "vision_attr_reduce", tree["AttentionReduceMLP_0"])
    _attr_reduce(out, "text_attr_reduce", tree["AttentionReduceMLP_1"])
    _linear(out, "vision_proj", tree["Dense_0"])
    _linear(out, "text_proj", tree["Dense_1"])
    _layer_norm(out, "layer_norm", tree["LayerNorm_0"])
    _linear(out, "classify", tree["Dense_2"])


_TEXT_EMBEDDINGS = ("LSTMTextEmbedding_0", "UsualEmbedding_0", "HierarchicalFeaturesExtractor_0")


def _compact_text_embedding(tree: Mapping[str, Any], candidates=_TEXT_EMBEDDINGS):
    """The text embedding's subtree in a ``@nn.compact`` model's tree."""
    return next(tree[key] for key in candidates if key in tree)


def _mcan(tree: Mapping[str, Any]) -> StateDict:
    """MCAN (the inverse of ``convert_mcan``, plus the hierarchical text
    embedding's convolutions)."""
    out: StateDict = {}
    _linear(out, "vision_embedding.proj", tree["vision_embedding"]["Dense_0"])
    _any_text_embedding(out, "text_embedding", tree["text_embedding"])
    _encoder(out, "self_encoder", tree["self_encoder"])
    _guided_encoder(out, "guided_encoder", tree["guided_encoder"])
    _attr_reduce(out, "vision_attr_reduce", tree["vision_attr_reduce"])
    _attr_reduce(out, "text_attr_reduce", tree["text_attr_reduce"])
    for name in ("vision_proj", "text_proj", "classify"):
        _linear(out, name, tree[name])
    _layer_norm(out, "layer_norm", tree["layer_norm"])
    return out


def _saaa(tree: Mapping[str, Any]) -> StateDict:
    """SAAA (the inverse of ``convert_saaa`` for its LSTM text processor; the
    Usual and hierarchical processors too)."""
    out: StateDict = {}
    _linear(out, "vision.proj", tree["FeatureEmbedding_0"]["Dense_0"])
    _any_text_embedding(out, "text", _compact_text_embedding(tree))
    attention = tree["CoAttention_0"]
    _kernel(out, "attention.v_conv", attention["Dense_0"])
    _linear(out, "attention.q_lin", attention["Dense_1"])
    _linear(out, "attention.x_conv", attention["Dense_2"])
    _linear(out, "classifier.lin1", tree["Dense_0"])
    _linear(out, "classifier.lin2", tree["Dense_1"])
    return out


def _vanilla_transformer(tree: Mapping[str, Any]) -> StateDict:
    out: StateDict = {}
    _linear(out, "vision_embedding.proj", tree["FeatureEmbedding_0"]["Dense_0"])
    _any_text_embedding(out, "text_embedding", _compact_text_embedding(tree))
    _encoder(out, "encoder", tree["Encoder_0"])
    _attr_reduce(out, "attr_reduce", tree["AttentionReduceMLP_0"])
    _linear(out, "proj", tree["Dense_0"])
    _layer_norm(out, "layer_norm", tree["LayerNorm_0"])
    _linear(out, "classify", tree["Dense_1"])
    return out


def _co_attention_model(tree: Mapping[str, Any]) -> StateDict:
    """ParallelAttentionTransformer, and HierarchicalCoAttention with its
    model-local extractor (``hierarchical.convs.N``)."""
    out: StateDict = {}
    _linear(out, "vision_embedding.proj", tree["FeatureEmbedding_0"]["Dense_0"])
    extractor = tree.get("HierarchicalFeaturesExtractor_0")
    if extractor is not None and "UsualEmbedding_0" not in extractor:  # the model-local one
        for i in range(sum(1 for key in extractor if key.startswith("Conv_"))):
            _conv(out, f"hierarchical.convs.{i}", extractor[f"Conv_{i}"])
        text = _compact_text_embedding(tree, _TEXT_EMBEDDINGS[:2])
    else:
        text = _compact_text_embedding(tree)
    _any_text_embedding(out, "text_embedding", text)
    _co_attention_encoder(out, "encoder", tree["CoAttentionEncoder_0"])
    _dual_stream_head(out, tree["DualStreamClassifier_0"])
    return out


def _cross_modality_encoder(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """``CrossModalityEncoder``: the two stream LayerNorms and ``layer_{i}``'s
    four attentions and two FFNs under their own names."""
    _layer_norm(out, f"{name}.vision_layer_norm", tree["vision_layer_norm"])
    _layer_norm(out, f"{name}.language_layer_norm", tree["language_layer_norm"])
    for i, layer in _layers(tree):
        for attention in ("vision_language_mhattn", "language_vision_mhattn", "vision_mhattn",
                          "language_mhattn"):
            _multi_head_attention(out, f"{name}.layers.{i}.{attention}", layer[attention])
        for ffn in ("vision_pff", "language_pff"):
            _positionwise_ffn(out, f"{name}.layers.{i}.{ffn}", layer[ffn])


def _vision_ocr_embedding(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """``VisionOcrEmbedding``: Dense_{0..3} and LayerNorm_{0..3} are the object
    features, object boxes, OCR features and OCR boxes, in that order."""
    for i, (stream, part) in enumerate((("obj", "feat"), ("obj", "bbox"), ("ocr", "feat"),
                                        ("ocr", "bbox"))):
        _linear(out, f"{name}.linear_{stream}_{part}_to_mmt_in", tree[f"Dense_{i}"])
        _layer_norm(out, f"{name}.{stream}_{part}_layer_norm", tree[f"LayerNorm_{i}"])


def _region_grid_box(out: StateDict, tree: Mapping[str, Any]) -> None:
    for name in ("region_embedding", "grid_embedding", "box_embedding"):
        if name in tree:
            _linear(out, f"{name}.proj", tree[name]["Dense_0"])


def _dual_stream_model(tree: Mapping[str, Any]) -> StateDict:
    """CrossModalityTransformer and VisiolinguisticTransformer in either mode:
    the classifier's head (``classifier``) onto the model's top, or the
    generator's streams, fusion, norm and decoder."""
    out: StateDict = {}
    _region_grid_box(out, tree)
    _text_embedding(out, "text_embedding", tree["text_embedding"])
    if "vl_0" in tree["encoder"]:
        _co_attention_encoder(out, "encoder", tree["encoder"])
    else:
        _cross_modality_encoder(out, "encoder", tree["encoder"])
    if "classifier" in tree:
        _dual_stream_head(out, tree["classifier"])
        return out
    _positionwise_ffn(out, "fusion", tree["fusion"])
    _layer_norm(out, "norm", tree["norm"])
    _decoder(out, tree["decoder"])
    return out


def _extended_mcan(tree: Mapping[str, Any]) -> StateDict:
    out: StateDict = {}
    _region_grid_box(out, tree)
    _text_embedding(out, "text_embedding", tree["text_embedding"])
    _encoder(out, "self_encoder", tree["self_encoder"])
    _guided_encoder(out, "guided_encoder", tree["guided_encoder"])
    _positionwise_ffn(out, "fusion", tree["fusion"])
    _layer_norm(out, "norm", tree["norm"])
    _decoder(out, tree["decoder"])
    return out


def _unique_transformer(tree: Mapping[str, Any]) -> StateDict:
    """UniqueTransformer: flax's ``streams/*`` embeddings at the top of the
    port's names beside the shared ``text_embedding``, the encoder and the
    bias-free ``fc``."""
    out: StateDict = {}
    _region_grid_box(out, tree["streams"])
    _text_embedding(out, "text_embedding", tree["text_embedding"])
    _encoder(out, "encoder", tree["encoder"])
    _kernel(out, "fc", tree["fc"])
    return out


def _iterative_saaa(tree: Mapping[str, Any]) -> StateDict:
    out: StateDict = {}
    _linear(out, "vision.proj", tree["vision"]["Dense_0"])
    out["text.embedding.weight"] = _arr(tree["text"]["embedding"])
    _lstm(out, "text.lstm", tree["text"]["OptimizedLSTMCell_0"])
    attention = tree["attention"]
    _kernel(out, "attention.v_conv", attention["Dense_0"])
    _linear(out, "attention.q_lin", attention["Dense_1"])
    _linear(out, "attention.x_conv", attention["Dense_2"])
    _positionwise_ffn(out, "fusion", tree["fusion"])
    _layer_norm(out, "norm", tree["norm"])
    _decoder(out, tree["decoder"])
    return out


def _iterative_mcan(tree: Mapping[str, Any]) -> StateDict:
    """IterativeMCAN, and ReadableIterativeMCAN by its ``VisionOcrEmbedding``."""
    out: StateDict = {}
    vision = tree["vision_embedding"]
    if "LayerNorm_0" in vision:
        _vision_ocr_embedding(out, "vision_embedding", vision)
    else:
        _linear(out, "vision_embedding.proj", vision["Dense_0"])
    _text_embedding(out, "text_embedding", tree["text_embedding"])
    _encoder(out, "self_encoder", tree["self_encoder"])
    _guided_encoder(out, "guided_encoder", tree["guided_encoder"])
    _positionwise_ffn(out, "fusion", tree["fusion"])
    _layer_norm(out, "norm", tree["norm"])
    _decoder(out, tree["decoder"])
    return out


def _joint_transformer(tree: Mapping[str, Any]) -> StateDict:
    """JointTransformer (the inverse of ``convert_joint_transformer``): the
    streams' embeddings at the top, the ``Encoder`` and the decoder."""
    out: StateDict = {}
    streams = tree["streams"]
    for name in ("region_embedding", "grid_embedding", "box_embedding"):
        _linear(out, f"{name}.proj", streams[name]["Dense_0"])
    _text_embedding(out, "text_embedding", streams["text_embedding"])
    _encoder(out, "encoder", tree["encoder"])
    _decoder(out, tree["decoder"])
    return out


def _decoder(out: StateDict, decoder: Mapping[str, Any]) -> None:
    """Decoder, and AdaptiveDecoder with its adaptive last layer and its
    ``language_model``."""
    _text_embedding(out, "decoder.word_emb", decoder["word_emb"])
    out["decoder.fc.weight"] = np.ascontiguousarray(_arr(decoder["fc"]["kernel"]).T)
    for i, layer in _layers(decoder):
        prefix = f"decoder.layers.{i}"
        _multi_head_attention(out, f"{prefix}.self_attn", layer["self_attn"])
        _multi_head_attention(out, f"{prefix}.enc_attn", layer["enc_attn"])
        _positionwise_ffn(out, f"{prefix}.pwff", layer["pwff"])
    if "language_model" in decoder:
        _frozen_language_model(out, "decoder.language_model", decoder["language_model"])


def _frozen_language_model(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """``_FrozenCausalLM``'s auto-names: the BERT backbone, ``Dense_0`` (the
    projection), ``BertLayer_0`` (the trainable layer) and ``Dense_1`` (the head)."""
    _bert_embeddings(out, f"{name}.backbone.embeddings", tree["BertEmbeddings_0"])
    _bert_encoder(out, f"{name}.backbone.encoder", tree["BertEncoderStack_0"])
    _linear(out, f"{name}.proj", tree["Dense_0"])
    _bert_layer(out, f"{name}.layer", tree["BertLayer_0"])
    _linear(out, f"{name}.head", tree["Dense_1"])


def _albert_backbone(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """AlbertEncoderStack -> HF AlbertModel names (the inverse of
    ``hf_conversion.convert_albert_weights``)."""
    emb = tree["embeddings"]
    for table in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        _embedding(out, f"{name}.embeddings.{table}", emb[table])
    _layer_norm(out, f"{name}.embeddings.LayerNorm", emb["LayerNorm"])
    _linear(out, f"{name}.encoder.embedding_hidden_mapping_in",
            tree["embedding_hidden_mapping_in"])
    for key, layer in tree.items():
        if not key.startswith("group_"):
            continue
        _, g, _, j = key.split("_")
        prefix = f"{name}.encoder.albert_layer_groups.{g}.albert_layers.{j}"
        for flax_name, torch_name in (("query", "attention.query"), ("key", "attention.key"),
                                      ("value", "attention.value"),
                                      ("attn_dense", "attention.dense"), ("ffn", "ffn"),
                                      ("ffn_output", "ffn_output")):
            _linear(out, f"{prefix}.{torch_name}", layer[flax_name])
        _layer_norm(out, f"{prefix}.attention.LayerNorm", layer["attn_LayerNorm"])
        _layer_norm(out, f"{prefix}.full_layer_layer_norm", layer["full_layer_LayerNorm"])


def _deberta_backbone(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """DebertaV2EncoderStack -> HF DebertaV2Model names (the inverse of
    ``hf_conversion.convert_deberta_v2_weights``)."""
    for table in ("word_embeddings", "position_embeddings"):
        if table in tree:
            _embedding(out, f"{name}.embeddings.{table}", tree[table])
    _layer_norm(out, f"{name}.embeddings.LayerNorm", tree["embeddings_LayerNorm"])
    out[f"{name}.encoder.rel_embeddings.weight"] = _arr(tree["rel_embeddings"])
    if "rel_LayerNorm" in tree:
        _layer_norm(out, f"{name}.encoder.LayerNorm", tree["rel_LayerNorm"])
    if "conv" in tree:
        _conv(out, f"{name}.encoder.conv.conv", tree["conv"])
        _layer_norm(out, f"{name}.encoder.conv.LayerNorm", tree["conv_LayerNorm"])
    for i, layer in _layers(tree):
        prefix = f"{name}.encoder.layer.{i}"
        for proj, weights in layer["self"].items():
            _linear(out, f"{prefix}.attention.self.{proj}", weights)
        _linear(out, f"{prefix}.attention.output.dense", layer["attn_output"])
        _layer_norm(out, f"{prefix}.attention.output.LayerNorm", layer["attn_LayerNorm"])
        _linear(out, f"{prefix}.intermediate.dense", layer["intermediate"])
        _linear(out, f"{prefix}.output.dense", layer["output"])
        _layer_norm(out, f"{prefix}.output.LayerNorm", layer["output_LayerNorm"])


def backbone_state(family: str, tree: Mapping[str, Any]) -> StateDict:
    """A flax backbone tree of `family` (t5, albert, deberta; vit: the
    ViTEmbedding-level tree with ``patch_embed``, ``cls_token``,
    ``position_embedding`` and ``backbone``; bert_layout: ``{"embeddings",
    "encoder"}`` as ``hf_conversion.convert_bert_weights`` returns it) -> the
    state_dict of the port's backbone module (a BertBackbone or TextBert for
    bert_layout), keys relative to it."""
    out: StateDict = {}
    if family == "bert_layout":
        _bert_embeddings(out, "_.embeddings", tree["embeddings"])
        _bert_encoder(out, "_.encoder", tree["encoder"])
    else:
        {"t5": _t5_encoder, "albert": _albert_backbone, "deberta": _deberta_backbone,
         "vit": _vit_backbone}[family](out, "_", tree)
    return {key[2:]: value for key, value in out.items()}


def _kernel(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """A bias-free Dense (T5's projections, SAAA's v_conv)."""
    out[f"{name}.weight"] = np.ascontiguousarray(_arr(tree["kernel"]).T)


def _vit_backbone(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """ViTEmbedding's raw-pixel front and backbone -> HF ViTModel names (the
    inverse of ``hf_conversion.convert_vit_weights``): the flax Conv kernel
    (kh, kw, in, out) becomes the torch Conv2d weight (out, in, kh, kw)."""
    patch = f"{name}.embeddings.patch_embeddings.projection"
    out[f"{patch}.weight"] = np.ascontiguousarray(
        _arr(tree["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    out[f"{patch}.bias"] = _arr(tree["patch_embed"]["bias"])
    out[f"{name}.embeddings.cls_token"] = _arr(tree["cls_token"])
    out[f"{name}.embeddings.position_embeddings"] = _arr(tree["position_embedding"])
    backbone = tree["backbone"]
    for i, layer in _layers(backbone):
        prefix = f"{name}.encoder.layer.{i}"
        _layer_norm(out, f"{prefix}.layernorm_before", layer["layernorm_before"])
        _layer_norm(out, f"{prefix}.layernorm_after", layer["layernorm_after"])
        for flax_name in ("query", "key", "value"):
            _linear(out, f"{prefix}.attention.attention.{flax_name}", layer["attention"][flax_name])
        _linear(out, f"{prefix}.attention.output.dense", layer["attention"]["out"])
        _linear(out, f"{prefix}.intermediate.dense", layer["intermediate"])
        _linear(out, f"{prefix}.output.dense", layer["output"])
    _layer_norm(out, f"{name}.layernorm", backbone["final_layernorm"])


def _t5_encoder(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """T5EncoderStack -> HF T5EncoderModel names (the inverse of
    ``hf_conversion.convert_t5_encoder_weights``); ``encoder.embed_tokens`` is
    ``shared``."""
    out[f"{name}.shared.weight"] = _arr(tree["token_embed"]["embedding"])
    out[f"{name}.encoder.embed_tokens.weight"] = out[f"{name}.shared.weight"]
    out[f"{name}.encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = _arr(
        tree["relative_attention_bias"]["embedding"])
    out[f"{name}.encoder.final_layer_norm.weight"] = _arr(tree["final_layer_norm"]["weight"])
    n_blocks = sum(1 for key in tree if key.startswith("block_"))
    for i in range(n_blocks):
        block = tree[f"block_{i}"]
        attn, ff = f"{name}.encoder.block.{i}.layer.0", f"{name}.encoder.block.{i}.layer.1"
        out[f"{attn}.layer_norm.weight"] = _arr(block["ln_attn"]["weight"])
        for proj in ("q", "k", "v", "o"):
            _kernel(out, f"{attn}.SelfAttention.{proj}", block["attention"][proj])
        out[f"{ff}.layer_norm.weight"] = _arr(block["ln_ff"]["weight"])
        for proj, weights in block["ff"].items():
            _kernel(out, f"{ff}.DenseReluDense.{proj}", weights)


def _vision_embedding(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """ViTEmbedding (its backbone, where it has one, under HF names) or
    FeatureEmbedding: then the projection ``proj``."""
    if "backbone" in tree:
        _vit_backbone(out, f"{name}.backbone", tree)
    _linear(out, f"{name}.proj", tree["Dense_0"])


def _pretrained_text_embedding(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    """T5Embedding, AlbertEmbedding or DebertaEmbedding (their ``backbone``,
    told apart by its keys) or a BERT-layout wrapper (flax's
    ``BertEmbeddings_0`` and ``BertEncoderStack_0`` -> HF BertModel's
    ``embeddings`` and ``encoder``): the frozen backbone under
    ``<name>.backbone``, then the projection ``proj``."""
    if "backbone" in tree:
        backbone = tree["backbone"]
        if "embedding_hidden_mapping_in" in backbone:
            _albert_backbone(out, f"{name}.backbone", backbone)
        elif "embeddings_LayerNorm" in backbone:
            _deberta_backbone(out, f"{name}.backbone", backbone)
        else:
            _t5_encoder(out, f"{name}.backbone", backbone)
    else:
        _bert_embeddings(out, f"{name}.backbone.embeddings", tree["BertEmbeddings_0"])
        _bert_encoder(out, f"{name}.backbone.encoder", tree["BertEncoderStack_0"])
    _linear(out, f"{name}.proj", tree["Dense_0"])


def _vit_generation(tree: Mapping[str, Any]) -> StateDict:
    """ViTmT5 and ViTmBERTGeneration: the vision and text embeddings (frozen
    backbones under HF names, their projections ``proj``), the ``fusion``
    Linear and the decoder.  The JAX package has no converter for either: this
    bridge and its inverse (from ``hf_conversion``'s backbone converters) are
    written by hand."""
    out: StateDict = {}
    _vision_embedding(out, "vision_encoder", tree["vision_encoder"])
    _pretrained_text_embedding(out, "text_embedding", tree["text_embedding"])
    _linear(out, "fusion", tree["fusion"])
    _decoder(out, tree["decoder"])
    return out


_BERT_WRAPPERS = ("BertEmbedding_0", "RobertaEmbedding_0", "XLMRobertaEmbedding_0",
                  "AlbertEmbedding_0", "DebertaEmbedding_0", "T5Embedding_0")


def _vit_mbert_classification(tree: Mapping[str, Any]) -> StateDict:
    """ViTmBERTClassification's flax auto-names: the vision embedding, the
    pretrained text wrapper (BERT-layout, ALBERT, DeBERTa or T5), ``Dense_0``
    (the fusion) and ``Dense_1`` (the classifier)."""
    out: StateDict = {}
    vision = next(key for key in tree if key.endswith("Embedding_0") and key not in _BERT_WRAPPERS)
    _vision_embedding(out, "vision_encoder", tree[vision])
    text = next(key for key in _BERT_WRAPPERS if key in tree)
    _pretrained_text_embedding(out, "text_embedding", tree[text])
    _linear(out, "fusion", tree["Dense_0"])
    _linear(out, "classify", tree["Dense_1"])
    return out


def params_from_flax(tree: Mapping[str, Any], config=None) -> StateDict:
    """A flax ``params`` collection (numpy arrays) -> the port's state_dict as
    float32 numpy arrays, for the M4C family (MMF_M4C, MMF_ImprovedDecodingM4C,
    experimental_MMF_M4C, MMF_REGIONAL_M4C, MMF_SAL, MMF_LanguageAdaptiveM4C,
    MMF_IterativeM4C and its multilevel variant, the standalone M4C,
    IterativeM4C, MMF_LoRRA, MMF_IterativeLoRRA), IterativeMCAN, ReadableIterativeMCAN,
    ExtendedMCAN, IterativeSAAA, ViTmT5, ViTmBERTGeneration, ViTmBERTClassification,
    JointTransformer, UniqueTransformer,
    CrossModalityTransformer and VisiolinguisticTransformer (either mode), any
    decoder an AdaptiveDecoder, any text wrapper an ALBERT or DeBERTa one, and
    the classification models (MCAN, SAAA, VanillaTransformer,
    ParallelAttentionTransformer, HierarchicalCoAttention; each text embedding:
    Usual, LSTM, hierarchical) trees, told apart by their top-level keys.
    `config` (the MODEL node) is accepted for symmetry with the JAX converters;
    the tree alone determines the layer counts."""
    if "self_attn" in tree and "txt_embedding" in tree:
        return _mmf_iterative_lorra(tree) if "mmt" in tree else _mmf_lorra(tree)
    if "question_encoder" in tree:
        return _standalone_m4c(tree)
    if "dynamic_embedding" in tree and "region_embedding" in tree:
        return _iterative_m4c(tree)
    if "txt_context_encoder" in tree:
        return _experimental_mmf_m4c(tree)
    if "joint_encoder" in tree:
        return _mmf_iterative_m4c(tree)
    if "language_backbone" in tree:
        return _mmf_language_adaptive(tree)
    if "text_bert" in tree:
        return _mmf_m4c(tree)
    if "self_encoder" in tree and "grid_embedding" in tree:
        return _extended_mcan(tree)
    if "self_encoder" in tree and "decoder" in tree:
        return _iterative_mcan(tree)
    if "text" in tree and "decoder" in tree:
        return _iterative_saaa(tree)
    if "self_encoder" in tree and "classify" in tree:
        return _mcan(tree)
    if "CoAttention_0" in tree:
        return _saaa(tree)
    if "Encoder_0" in tree and "AttentionReduceMLP_0" in tree:
        return _vanilla_transformer(tree)
    if "CoAttentionEncoder_0" in tree and "DualStreamClassifier_0" in tree:
        return _co_attention_model(tree)
    if "vision_encoder" in tree and "text_embedding" in tree and "fusion" in tree:
        return _vit_generation(tree)
    if any(key in tree for key in _BERT_WRAPPERS) and "Dense_1" in tree:
        return _vit_mbert_classification(tree)
    if "streams" in tree and "fc" in tree:
        return _unique_transformer(tree)
    if "streams" in tree and "encoder" in tree:
        return _joint_transformer(tree)
    if "region_embedding" in tree and "encoder" in tree:
        return _dual_stream_model(tree)
    raise ValueError(f"no bridge for a parameter tree with keys {sorted(tree)}")
