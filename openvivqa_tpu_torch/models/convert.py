"""Weight bridge from the JAX package's flax parameter tree to the port's
``state_dict`` (numpy only).

The port's parameter names are the reference's torch names, the ones
``openvivqa_tpu.models.modules.torch_conversion``'s converters read
(``convert_mmf_m4c``, ``convert_iterative_mcan``), so those converters are this
bridge's inverses and the port also loads the reference's own checkpoints.  Flax Dense kernels are (in, out) and torch
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


def _mmf_m4c(tree: Mapping[str, Any]) -> StateDict:
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


def _multi_head_attention(out: StateDict, name: str, tree: Mapping[str, Any]) -> None:
    for projection in ("fc_q", "fc_k", "fc_v", "fc_o"):
        _linear(out, f"{name}.attention.{projection}", tree["attention"][projection])
    _layer_norm(out, f"{name}.layer_norm", tree["layer_norm"])


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


def _layers(tree: Mapping[str, Any]):
    """(index, subtree) of a stack's ``layer_{i}`` entries, in order."""
    count = sum(1 for key in tree if key[6:].isdigit() and key.startswith("layer_"))
    return ((i, tree[f"layer_{i}"]) for i in range(count))


def _iterative_mcan(tree: Mapping[str, Any]) -> StateDict:
    out: StateDict = {}
    _linear(out, "vision_embedding.proj", tree["vision_embedding"]["Dense_0"])
    _text_embedding(out, "text_embedding", tree["text_embedding"])
    _layer_norm(out, "self_encoder.layer_norm", tree["self_encoder"]["layer_norm"])
    for i, layer in _layers(tree["self_encoder"]):
        _multi_head_attention(out, f"self_encoder.layers.{i}.mhatt", layer["mhatt"])
        _positionwise_ffn(out, f"self_encoder.layers.{i}.pwff", layer["pwff"])
    _layer_norm(out, "guided_encoder.layer_norm", tree["guided_encoder"]["layer_norm"])
    for i, layer in _layers(tree["guided_encoder"]):
        prefix = f"guided_encoder.guided_attn_layers.{i}"
        _multi_head_attention(out, f"{prefix}.self_mhatt", layer["self_mhatt"])
        _multi_head_attention(out, f"{prefix}.guided_mhatt", layer["guided_mhatt"])
        _positionwise_ffn(out, f"{prefix}.pwff", layer["pwff"])
    _positionwise_ffn(out, "fusion", tree["fusion"])
    _layer_norm(out, "norm", tree["norm"])
    decoder = tree["decoder"]
    _text_embedding(out, "decoder.word_emb", decoder["word_emb"])
    out["decoder.fc.weight"] = np.ascontiguousarray(_arr(decoder["fc"]["kernel"]).T)
    for i, layer in _layers(decoder):
        prefix = f"decoder.layers.{i}"
        _multi_head_attention(out, f"{prefix}.self_attn", layer["self_attn"])
        _multi_head_attention(out, f"{prefix}.enc_attn", layer["enc_attn"])
        _positionwise_ffn(out, f"{prefix}.pwff", layer["pwff"])
    return out


def params_from_flax(tree: Mapping[str, Any], config=None) -> StateDict:
    """A flax ``params`` collection (numpy arrays) -> the port's state_dict as
    float32 numpy arrays, for MMF_M4C and IterativeMCAN trees, told apart by
    their top-level keys.  `config` (the MODEL node) is accepted for symmetry
    with the JAX converters; the tree alone determines the layer counts."""
    if "text_bert" in tree:
        return _mmf_m4c(tree)
    if "self_encoder" in tree and "decoder" in tree:
        return _iterative_mcan(tree)
    raise ValueError(f"no bridge for a parameter tree with keys {sorted(tree)}")
