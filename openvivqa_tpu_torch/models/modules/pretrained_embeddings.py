"""Pretrained-backbone embeddings: the frozen backbone, a projection to D_MODEL,
exact GELU and dropout.

The port's counterparts of ``backbone_table_rows``, ``BACKBONE_SPECS``,
``resolve_backbone_spec``, ``_ProjectedBackboneEmbedding``, ``T5Embedding``,
``AlbertEmbedding``, ``DebertaEmbedding``, the BERT-layout text wrappers
(``_FrozenTextBackboneEmbedding``, registered as BertEmbedding, RobertaEmbedding
and XLMRobertaEmbedding), ``ViTEmbedding`` and the frozen causal language models
(``_FrozenCausalLM``, registered as BERTModel, PhoBERTModel, BARTPhoModel and
GPT2Model) in ``openvivqa_tpu/models/modules/pretrained_embeddings.py``.
Backbones are built at the published shapes of the checkpoint PRETRAINED_NAME
names (mT5-small: 8 layers of 512, 6 heads of 64, gated gelu_new FFN of 1024,
250,112 rows; bert-base-multilingual-uncased: 12 layers of 768, 12 heads of 64,
FFN 3072, 105,879 rows; albert-base-v2: 12 layers of 768 sharing one, 12 heads,
embedding 128, FFN 3072, 30,000 rows; deberta-v3-base: 12 layers of 768, 12
heads, FFN 3072, 128,100 rows, 256 position buckets and, as its config.json
says, no absolute position table and no token types; ViT-base: 12 layers of 768,
12 heads, patch 16 at 224), with random weights unless the pretrained-weights
policy (``pretrained_loading.py``) loads local files.  Their parameters are
HF's, under ``backbone.`` (a BERT backbone is HF ``BertModel``'s ``embeddings``
and ``encoder``, without the pooler), so a local checkpoint loads by
``load_state_dict``.

A backbone is frozen as the reference freezes it: ``requires_grad`` off and its
forward under ``torch.no_grad()`` (no gradient, no Adam update, no dropout), the
counterpart of the JAX package's ``stop_gradient``.  It runs its eval route in
training too, as the JAX wrappers call it with ``train=False``: a BERT layer is
kernel F then kernel C, an ALBERT layer kernel F then its tanh-GELU FFN in
torch, a DeBERTa layer the two-bias attention kernel then kernel C.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...builders import (
    META_PRETRAINED_LANGUAGE_MODEL,
    META_TEXT_EMBEDDING,
    META_VISION_EMBEDDING,
)
from .bert import BertEmbeddings, BertEncoderStack, BertLayer, dropout, init_jax_law_
from .masks import (
    causal_bias,
    combine_biases,
    padding_bias,
    sinusoid_encoding_table,
    validity_to_bias,
)

# real vocab sizes of the BERT-layout checkpoints the reference configs name
_BERT_FAMILY_VOCABS = {
    "bert-base-uncased": 30522,
    "bert-base-cased": 28996,
    "bert-base-multilingual-uncased": 105879,
    "bert-base-multilingual-cased": 119547,
    "xlm-roberta-base": 250002,
    "xlm-roberta-large": 250002,
    "roberta-base": 50265,
    "vinai/phobert-base": 64001,
    "vinai/phobert-large": 64001,
}


def backbone_table_rows(config, vocab_len: int = 0) -> int:
    """Embedding-table rows for a BERT-layout backbone: the explicit
    PRETRAINED_VOCAB_SIZE, else the known checkpoint size, and at least
    `vocab_len`.  An unknown checkpoint name without an explicit size raises:
    a table too small for the tokenizer's ids would be read out of range."""
    name = config.get("PRETRAINED_NAME")
    configured = config.get("PRETRAINED_VOCAB_SIZE")
    if configured:
        rows = int(configured)
    elif not name:
        rows = 30522  # BERT-base layout default (no checkpoint named)
    elif name in _BERT_FAMILY_VOCABS:
        rows = _BERT_FAMILY_VOCABS[name]
    else:
        raise ValueError(
            f"PRETRAINED_NAME {name!r} has no known vocab size; set "
            "PRETRAINED_VOCAB_SIZE to the checkpoint's real vocab rows"
        )
    return max(vocab_len, rows)


# Default dims follow the checkpoint PRETRAINED_NAME names; explicit config keys
# (D_PRETRAINED_FEATURE, PRETRAINED_LAYERS, NUM_ATTENTION_HEADS,
# PRETRAINED_VOCAB_SIZE, ...) override them.
BACKBONE_SPECS = {
    "google/mt5-small": dict(
        family="t5", hidden=512, layers=8, heads=6, d_kv=64, d_ff=1024,
        vocab_size=250112, gated_act=True, act_fn="gelu_new",
    ),
    "google/mt5-base": dict(
        family="t5", hidden=768, layers=12, heads=12, d_kv=64, d_ff=2048,
        vocab_size=250112, gated_act=True, act_fn="gelu_new",
    ),
    "t5-small": dict(
        family="t5", hidden=512, layers=6, heads=8, d_kv=64, d_ff=2048,
        vocab_size=32128, gated_act=False, act_fn="relu",
    ),
    "t5-base": dict(
        family="t5", hidden=768, layers=12, heads=12, d_kv=64, d_ff=3072,
        vocab_size=32128, gated_act=False, act_fn="relu",
    ),
    "albert-base-v2": dict(
        family="albert", hidden=768, layers=12, heads=12, embedding_size=128,
        intermediate=3072, vocab_size=30000,
    ),
    "albert-large-v2": dict(
        family="albert", hidden=1024, layers=24, heads=16, embedding_size=128,
        intermediate=4096, vocab_size=30000,
    ),
    "microsoft/deberta-v3-base": dict(
        family="deberta", hidden=768, layers=12, heads=12, intermediate=3072,
        vocab_size=128100, position_buckets=256, share_att_key=True, position_biased_input=False,
        norm_rel_ebd="layer_norm",
    ),
    "microsoft/deberta-v3-large": dict(
        family="deberta", hidden=1024, layers=24, heads=16, intermediate=4096,
        vocab_size=128100, position_buckets=256, share_att_key=True, position_biased_input=False,
        norm_rel_ebd="layer_norm",
    ),
    "microsoft/deberta-v2-xlarge": dict(
        family="deberta", hidden=1536, layers=24, heads=24, intermediate=6144,
        vocab_size=128100, position_buckets=256, share_att_key=True, position_biased_input=False,
        norm_rel_ebd="layer_norm", conv_kernel_size=3, conv_groups=1,
    ),
}

_FAMILY_DEFAULTS = {
    # used when PRETRAINED_NAME is absent or unknown: base-model shapes
    "t5": BACKBONE_SPECS["google/mt5-small"],
    "albert": BACKBONE_SPECS["albert-base-v2"],
    "deberta": BACKBONE_SPECS["microsoft/deberta-v3-base"],
}


def resolve_backbone_spec(config, family: str, vocab=None) -> dict:
    """Spec = family default <- PRETRAINED_NAME entry <- explicit keys; the
    table holds at least the vocab's rows, so framework-vocab ids stay
    addressable without a tokenizer."""
    spec = dict(_FAMILY_DEFAULTS[family])
    name = config.get("PRETRAINED_NAME")
    if name in BACKBONE_SPECS and BACKBONE_SPECS[name]["family"] == family:
        spec = dict(BACKBONE_SPECS[name])
    for cfg_key, spec_key in (
        ("D_PRETRAINED_FEATURE", "hidden"),
        ("HIDDEN_SIZE", "hidden"),
        ("PRETRAINED_LAYERS", "layers"),
        ("NUM_HIDDEN_LAYERS", "layers"),
        ("NUM_ATTENTION_HEADS", "heads"),
        ("PRETRAINED_VOCAB_SIZE", "vocab_size"),
        ("PRETRAINED_INTERMEDIATE_SIZE", "intermediate"),
        ("PRETRAINED_D_KV", "d_kv"),
        ("PRETRAINED_D_FF", "d_ff"),
        ("PRETRAINED_EMBEDDING_SIZE", "embedding_size"),
    ):
        value = config.get(cfg_key)
        if value is not None:
            spec[spec_key] = int(value)
    if vocab is not None:
        spec["vocab_size"] = max(spec["vocab_size"], len(vocab))
    return spec


class _ProjectedBackboneEmbedding(nn.Module):
    """Frozen text backbone -> Linear(D_MODEL) -> GELU -> dropout; returns
    (features, padding bias).  The bias comes from `padding_mask` (a
    tokenizer's validity mask) when given, else from the ids equal to
    `padding_idx` (the vocab's by default)."""

    family = "t5"

    def __init__(self, config, vocab):
        super().__init__()
        spec = self._spec(config, vocab)
        self.padding_idx = vocab.padding_idx
        self.dropout = config.DROPOUT
        self.backbone = self._build_backbone(spec)
        self.backbone.requires_grad_(False)  # frozen, as the reference freezes it
        self.proj = nn.Linear(spec["hidden"], config.D_MODEL)

    def _spec(self, config, vocab) -> dict:
        return resolve_backbone_spec(config, self.family, vocab)

    def _build_backbone(self, spec) -> nn.Module:
        raise NotImplementedError

    def forward(self, tokens, generator: Optional[torch.Generator] = None,
                padding_idx: Optional[int] = None, padding_mask=None):
        if padding_mask is not None:
            bias = validity_to_bias(padding_mask)
        else:
            bias = padding_bias(tokens, self.padding_idx if padding_idx is None else padding_idx)
        with torch.no_grad():
            encoded = self.backbone(tokens, bias)
        out = dropout(F.gelu(self.proj(encoded)), self.dropout, generator)
        return out, bias


@META_TEXT_EMBEDDING.register()
class T5Embedding(_ProjectedBackboneEmbedding):
    """The mT5 / T5 encoder (``modules/t5.py``) behind the projection."""

    family = "t5"

    def _build_backbone(self, spec) -> nn.Module:
        from .t5 import T5EncoderStack

        return T5EncoderStack(
            vocab_size=spec["vocab_size"], d_model=spec["hidden"], num_layers=spec["layers"],
            num_heads=spec["heads"], d_kv=spec.get("d_kv", 64), d_ff=spec.get("d_ff"),
            gated_act=spec.get("gated_act", True), act_fn=spec.get("act_fn", "gelu_new"),
        )


@META_TEXT_EMBEDDING.register()
class AlbertEmbedding(_ProjectedBackboneEmbedding):
    """ALBERT (factorised embeddings, one shared layer group) behind the
    projection, with the single ``embedding_hidden_mapping_in`` of HF's model."""

    family = "albert"

    def _build_backbone(self, spec) -> nn.Module:
        from .albert import AlbertEncoderStack

        return AlbertEncoderStack(
            vocab_size=spec["vocab_size"], hidden_size=spec["hidden"], num_layers=spec["layers"],
            num_heads=spec["heads"], embedding_size=spec.get("embedding_size", 128),
            intermediate_size=spec.get("intermediate"),
        )


@META_TEXT_EMBEDDING.register()
class DebertaEmbedding(_ProjectedBackboneEmbedding):
    """DeBERTa-v2 / v3 (disentangled attention) behind the projection."""

    family = "deberta"

    def _build_backbone(self, spec) -> nn.Module:
        from .deberta import DebertaV2EncoderStack

        return DebertaV2EncoderStack(
            vocab_size=spec["vocab_size"], hidden_size=spec["hidden"], num_layers=spec["layers"],
            num_heads=spec["heads"], intermediate_size=spec.get("intermediate"),
            position_biased_input=spec.get("position_biased_input", True),
            position_buckets=spec.get("position_buckets", -1),
            share_att_key=spec.get("share_att_key", False),
            norm_rel_ebd=spec.get("norm_rel_ebd", "none"),
            conv_kernel_size=spec.get("conv_kernel_size", 0),
            conv_groups=spec.get("conv_groups", 1),
        )


class BertBackbone(nn.Module):
    """HF ``BertModel`` without its pooler: ``embeddings`` (word, position and
    token-type tables, LayerNorm) and ``encoder`` (``layer.N``, kernels F and
    C on the eval route).  Returns the last hidden states."""

    def __init__(self, vocab_size: int, hidden: int, layers: int, heads: int,
                 intermediate: Optional[int] = None):
        super().__init__()
        self.embeddings = BertEmbeddings(vocab_size, hidden)
        self.encoder = BertEncoderStack(hidden, layers, heads, intermediate)

    def init_weights_(self, generator: torch.Generator) -> None:
        """BERT's law (normal(0.02) tables and matrices), drawn from `generator`."""
        init_jax_law_(self, generator)

    def forward(self, tokens, attention_bias):
        return self.encoder(self.embeddings(tokens), attention_bias)


class _FrozenTextBackboneEmbedding(_ProjectedBackboneEmbedding):
    """The BERT-layout text wrappers: a frozen ``BertBackbone`` at the named
    checkpoint's shapes (BERT-base unless D_PRETRAINED_FEATURE,
    PRETRAINED_LAYERS / NUM_HIDDEN_LAYERS, NUM_ATTENTION_HEADS,
    PRETRAINED_INTERMEDIATE_SIZE or PRETRAINED_VOCAB_SIZE say otherwise) ->
    Linear(D_MODEL) -> GELU -> dropout.  RoBERTa and XLM-R share the layout;
    their differences lie in the checkpoint's weights."""

    family = "bert"

    def _spec(self, config, vocab) -> dict:
        hidden = int(config.get("D_PRETRAINED_FEATURE", 768))
        return dict(
            hidden=hidden,
            layers=int(config.get("PRETRAINED_LAYERS") or config.get("NUM_HIDDEN_LAYERS") or 12),
            heads=int(config.get("NUM_ATTENTION_HEADS") or max(1, hidden // 64)),
            intermediate=config.get("PRETRAINED_INTERMEDIATE_SIZE"),
            vocab_size=backbone_table_rows(config, len(vocab)),
        )

    def _build_backbone(self, spec) -> nn.Module:
        return BertBackbone(spec["vocab_size"], spec["hidden"], spec["layers"], spec["heads"],
                            spec["intermediate"])


@META_TEXT_EMBEDDING.register()
class BertEmbedding(_FrozenTextBackboneEmbedding):
    pass


@META_TEXT_EMBEDDING.register()
class RobertaEmbedding(_FrozenTextBackboneEmbedding):
    pass


@META_TEXT_EMBEDDING.register()
class XLMRobertaEmbedding(_FrozenTextBackboneEmbedding):
    pass


@META_VISION_EMBEDDING.register()
class ViTEmbedding(nn.Module):
    """Frozen ViT backbone over (b, H, W, 3) pixels -> Linear(D_MODEL) -> GELU
    -> dropout; returns (features, padding bias).  Given (b, L, D) features
    instead (pre-extracted ViT outputs), the backbone is skipped.  An all-zero
    feature row is padding (``padding_bias(features, 0)``, as the JAX package
    computes it)."""

    def __init__(self, config):
        super().__init__()
        from .vit import ViTBackbone

        hidden = int(config.get("D_PRETRAINED_FEATURE", 768))
        self.dropout = config.DROPOUT
        self.backbone = ViTBackbone(
            hidden_size=hidden,
            num_layers=int(config.get("PRETRAINED_LAYERS", 12)),  # ViT-base depth
            num_heads=int(config.get("PRETRAINED_HEADS", max(1, hidden // 64))),
            intermediate_size=config.get("PRETRAINED_INTERMEDIATE_SIZE"),
            patch=int(config.get("PATCH_SIZE", 16)),
            image_size=int(config.get("IMAGE_SIZE", 224)),
        )
        self.backbone.requires_grad_(False)  # frozen, as the reference freezes it
        self.proj = nn.Linear(hidden, config.D_MODEL)

    def forward(self, pixel_values, generator: Optional[torch.Generator] = None):
        if pixel_values.ndim == 4:
            with torch.no_grad():
                features = self.backbone(pixel_values)
        else:
            features = pixel_values.detach()
        mask = padding_bias(features, padding_idx=0)
        return dropout(F.gelu(self.proj(features)), self.dropout, generator), mask


class _FrozenCausalLM(nn.Module):
    """A frozen BERT-layout language model, a projection to D_MODEL plus
    sinusoid positions, one trainable ``BertLayer`` under a causal padding bias
    and a vocab head; returns (log-probs, language signals), the signals being
    the layer's output, for the AdaptiveDecoder.

    As in the JAX package, the frozen backbone (at D_PRETRAINED_FEATURE, 768 by
    default, PRETRAINED_LAYERS deep, 12 by default, with at least 30,522 rows)
    masks its padding.  Its only caller, the AdaptiveDecoder, runs it with
    ``train=False`` in the JAX package, so the layer has no dropout: with a
    `generator` it takes the layer's differentiable training route at rate 0,
    without one the eval route (the kernels: F and C in the backbone; packed or
    F, and C, in the layer)."""

    def __init__(self, config, vocab):
        super().__init__()
        hidden = int(config.get("D_PRETRAINED_FEATURE", 768))
        d_model = int(config.D_MODEL)
        self.padding_idx = vocab.padding_idx
        self.backbone = BertBackbone(max(len(vocab), 30522), hidden,
                                     int(config.get("PRETRAINED_LAYERS", 12)), max(1, hidden // 64))
        self.backbone.requires_grad_(False)  # frozen, as the reference freezes it
        self.proj = nn.Linear(hidden, d_model)
        # row 0 for padding, rows 1.. for the positions the backbone's table covers
        rows = self.backbone.embeddings.position_embeddings.num_embeddings + 1
        self.register_buffer("pos_table", torch.from_numpy(
            sinusoid_encoding_table(rows, d_model, 0)), persistent=False)
        self.layer = BertLayer(d_model, max(1, d_model // 64), dropout=0.0)
        self.head = nn.Linear(d_model, len(vocab))

    def forward(self, tokens: torch.Tensor, generator: Optional[torch.Generator] = None):
        length = tokens.shape[1]
        pad_bias = padding_bias(tokens, self.padding_idx)
        self_bias = combine_biases(pad_bias, causal_bias(length, tokens.device))
        with torch.no_grad():
            encoded = self.backbone(tokens, pad_bias)
        positions = torch.arange(1, length + 1, device=tokens.device)[None, :]
        positions = torch.where(pad_bias[:, 0, 0, :] != 0, 0, positions)
        feature = self.proj(encoded) + self.pos_table[positions]
        feature = self.layer(feature, self_bias, generator=generator)
        return torch.log_softmax(self.head(feature), dim=-1), feature


@META_PRETRAINED_LANGUAGE_MODEL.register()
class BERTModel(_FrozenCausalLM):
    pass


@META_PRETRAINED_LANGUAGE_MODEL.register()
class PhoBERTModel(_FrozenCausalLM):
    pass


@META_PRETRAINED_LANGUAGE_MODEL.register()
class BARTPhoModel(_FrozenCausalLM):
    """An empty stub in the reference; registered as a working frozen LM, as
    the JAX package registers it."""


@META_PRETRAINED_LANGUAGE_MODEL.register()
class GPT2Model(_FrozenCausalLM):
    """An empty stub in the reference; see BARTPhoModel."""
