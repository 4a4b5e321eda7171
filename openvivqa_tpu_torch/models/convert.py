"""Weight bridge from the JAX package's flax parameter tree to the port's
``state_dict`` (numpy only).

The port's parameter names are the reference's torch names, the ones
``openvivqa_tpu.models.modules.torch_conversion.convert_mmf_m4c`` reads, so
that converter is this bridge's inverse and the port also loads the
reference's own checkpoints.  Flax Dense kernels are (in, out) and torch
Linear weights (out, in); LayerNorm scale/bias become weight/bias.
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


def _bert_layer(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    attention = tree["BertSelfAttention_0"]
    for flax_name, torch_name in (
        ("Dense_0", "attention.self.query"),
        ("Dense_1", "attention.self.key"),
        ("Dense_2", "attention.self.value"),
        ("Dense_3", "attention.output.dense"),
    ):
        _linear(out, f"{name}.{torch_name}", attention[flax_name])
    _layer_norm(out, f"{name}.attention.output.LayerNorm", attention["LayerNorm_0"])
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


def params_from_flax(tree: Mapping[str, Any], config=None) -> StateDict:
    """Flax MMF_M4C params (the ``params`` collection, as numpy arrays) -> the
    port's MMF_M4C state_dict as float32 numpy arrays.  `config` (the MODEL
    node) is accepted for symmetry with the JAX converters; the tree alone
    determines the layer counts."""
    out: StateDict = {}
    text = tree["text_bert"]
    embeddings = text["BertEmbeddings_0"]
    _embedding(out, "text_bert.embeddings.word_embeddings", embeddings["Embed_0"])
    _embedding(out, "text_bert.embeddings.position_embeddings", embeddings["Embed_1"])
    _embedding(out, "text_bert.embeddings.token_type_embeddings", embeddings["Embed_2"])
    _layer_norm(out, "text_bert.embeddings.LayerNorm", embeddings["LayerNorm_0"])
    _bert_encoder(out, "text_bert.encoder", text["BertEncoderStack_0"])
    if "text_bert_out_linear" in tree:
        _linear(out, "text_bert_out_linear", tree["text_bert_out_linear"])
    _feature_box(out, "obj", tree["obj_encoding"])
    _feature_box(out, "ocr", tree["ocr_encoding"])

    ppe = tree["mmt"]["prev_pred_embeddings"]
    _layer_norm(out, "mmt.prev_pred_embeddings.ans_layer_norm", ppe["LayerNorm_0"])
    _layer_norm(out, "mmt.prev_pred_embeddings.ocr_layer_norm", ppe["LayerNorm_1"])
    _layer_norm(out, "mmt.prev_pred_embeddings.emb_layer_norm", ppe["LayerNorm_2"])
    _embedding(out, "mmt.prev_pred_embeddings.position_embeddings", ppe["Embed_0"])
    _embedding(out, "mmt.prev_pred_embeddings.token_type_embeddings", ppe["Embed_1"])
    _bert_encoder(out, "mmt.encoder", tree["mmt"]["encoder"])

    out["classifier.weight"] = np.ascontiguousarray(_arr(tree["classifier_kernel"]).T)
    out["classifier.bias"] = _arr(tree["classifier_bias"])
    _linear(out, "ocr_ptr_net.query", tree["ocr_ptr_net"]["Dense_0"])
    _linear(out, "ocr_ptr_net.key", tree["ocr_ptr_net"]["Dense_1"])
    return out
