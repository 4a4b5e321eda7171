"""The transformer decoder: teacher-forced forward and single-token decode.

Counterpart of ``DecoderLayer``, ``Decoder`` and ``AdaptiveDecoder`` in
``openvivqa_tpu/models/modules/decoders.py``, under the reference's parameter
names (``layers.N.{self_attn,enc_attn,pwff}``, ``word_emb``, a bias-free ``fc``,
``language_model``).

Decode state is explicit.  ``Decoder.prepare_decode`` computes, once per
generate, what no decode step changes (the JAX package's ``decode_prep``
collection): which route each layer takes, the kernels' weight bundles (bf16
copies on the card) and the projected encoder K/V (bf16 on the card for the
kernels).  ``Decoder.init_cache`` makes the per-layer ring caches and the
position counter; beam search reorders the rings between steps.

Routes of one layer's decode step, chosen by configuration only
(``ops/decode_step.decode_kernel_parts()`` and the layer's attention modules),
never by catching a failure:
  * layer: ``fused_decoder_layer_step``, the whole layer in one call, when
    'layer' is among the parts, the self-attention is stateful and the
    cross-attention is not, both are scaled dot-product cores that tile the
    model width (d_k == d_v, h * d_k == d_model) and share their head geometry;
  * staged: kernel A for the self-attention ('self'), kernel B for the
    cross-attention ('cross'), kernel C for the FFN ('ffn'), each where its
    part is chosen and its module supports it; a layer that cannot take the
    layer step while 'layer' is chosen (the AdaptiveDecoder's adaptive layer)
    is routed core by core, each on its stage kernel where it supports one;
  * module: the modules' own projections and the flat attention kernel
    (``attend``) on the ring and the encoder cache.
On CPU tensors every kernel wrapper runs its plain version.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ...builders import META_DECODER, build_pretrained_language_model, build_text_embedding
from ...ops import _cuda
from ...ops import decode_step as _ds
from .attentions import MultiHeadAttention, key_bias_rows
from .ffn import PositionWiseFeedForward
from .masks import causal_bias, combine_biases, padding_bias, sinusoid_encoding_table


class DecoderLayer(nn.Module):
    """Masked self-attention + cross-attention + FFN."""

    def __init__(self, config):
        super().__init__()
        self.self_attn = MultiHeadAttention(config.SELF_ATTENTION)
        self.enc_attn = MultiHeadAttention(config.ENC_ATTENTION)
        self.pwff = PositionWiseFeedForward(config.ENC_ATTENTION)

    def forward(self, queries, keys, values, self_attention_bias, enc_attention_bias,
                generator: Optional[torch.Generator] = None, **extras):
        """`extras` (the AdaptiveDecoder's ``language_signals``) reach both
        attention cores; the scaled dot-product core ignores them."""
        self_att = self.self_attn(queries, queries, queries, self_attention_bias, generator,
                                  **extras)
        enc_att = self.enc_attn(self_att, keys, values, enc_attention_bias, generator, **extras)
        return self.pwff(enc_att, generator)

    # -- decode ------------------------------------------------------------------
    def supports_layer_step(self) -> bool:
        """Whether ``fused_decoder_layer_step`` computes this layer."""
        sa, ca = self.self_attn, self.enc_attn
        if not (sa.can_be_stateful and not ca.can_be_stateful
                and sa.supports_fused_decode() and ca.supports_fused_decode()):
            return False
        core, ccore = sa.attention, ca.attention
        return ccore.h == core.h and ccore.d_k == core.d_k

    def precast_bundle(self, keys, values, parts: frozenset) -> Dict:
        """What this layer's decode steps reuse unchanged: its route, the
        kernels' weight bundles and the projected encoder K/V, in the kernels'
        storage type where a kernel reads them."""
        sa, ca = self.self_attn, self.enc_attn
        if not sa.can_be_stateful or ca.can_be_stateful:
            raise NotImplementedError(
                "decode needs a stateful self-attention and a stateless cross-attention"
            )
        dtype = _cuda.kernel_dtype(keys.device)
        if "layer" in parts and self.supports_layer_step():
            return {
                "route": "layer",
                "self_w": sa.fused_weights(dtype), "cross_w": ca.fused_weights(dtype),
                "ffn_w": self.pwff.fused_weights(dtype),
                "enc_kv": ca.fill_enc_cache(keys, values, dtype),
            }
        if "layer" in parts:  # a layer the layer step cannot take: core by core
            parts = parts | {"self", "cross", "ffn"}
        use_cross = "cross" in parts and ca.supports_fused_decode()
        return {
            "route": "staged",
            "self_w": sa.fused_weights(dtype)
            if "self" in parts and sa.supports_fused_decode() else None,
            "cross_w": ca.fused_weights(dtype) if use_cross else None,
            "ffn_w": self.pwff.fused_weights(dtype) if "ffn" in parts else None,
            "enc_kv": ca.fill_enc_cache(keys, values, dtype if use_cross else torch.float32),
        }

    def decode_step(self, queries, cache, bundle: Dict, step_bias, enc_bias, t: int,
                    language_signals=None):
        """One token (rows, 1, d_model) through the layer; the ring `cache` is
        written in place at slot min(t, T - 1).  step_bias (rows,) is the
        token's padding bias, enc_bias (rows, Sk) the encoder's;
        `language_signals` (rows, 1, d_model) feed an adaptive self-attention."""
        enc_kv = bundle["enc_kv"]
        if bundle["route"] == "layer":
            core = self.self_attn.attention
            y, _, _, _ = _ds.fused_decoder_layer_step(
                queries[:, 0].float().contiguous(), bundle["self_w"], bundle["cross_w"],
                bundle["ffn_w"], step_bias, t, cache.key, cache.value, cache.bias,
                enc_kv.key, enc_kv.value, enc_bias, core.scale, core.h,
            )
            return y[:, None, :]
        out = self.self_attn.decode_step(queries, cache, step_bias, t, bundle["self_w"],
                                         language_signals)
        out = self.enc_attn.cross_decode_step(out, enc_kv, enc_bias, bundle["cross_w"])
        if bundle["ffn_w"] is not None:
            return self.pwff.decode_step(
                out[:, 0].float().contiguous(), bundle["ffn_w"])[:, None, :]
        return self.pwff(out)


@META_DECODER.register()
class Decoder(nn.Module):
    """N masked decoder layers over word embeddings plus sinusoid positions,
    with a log-softmax output."""

    def __init__(self, config, vocab):
        super().__init__()
        self.d_model = config.D_MODEL
        self.max_len = vocab.max_answer_length
        self.padding_idx = vocab.padding_idx
        self.word_emb = build_text_embedding(config.TEXT_EMBEDDING, vocab)
        table = sinusoid_encoding_table(self.max_len + 1, self.d_model, padding_idx=0)
        self.register_buffer("pos_table", torch.from_numpy(table), persistent=False)
        self.layers = nn.ModuleList(DecoderLayer(config.ATTENTION) for _ in range(config.LAYERS))
        self.fc = nn.Linear(self.d_model, len(vocab), bias=False)

    def forward(self, answer_tokens, encoder_features, encoder_attention_bias,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced log-probs (bs, L, V)."""
        seq_len = answer_tokens.shape[1]
        pad_bias = padding_bias(answer_tokens, self.padding_idx)
        self_bias = combine_biases(pad_bias, causal_bias(seq_len, answer_tokens.device))
        positions = torch.arange(1, seq_len + 1, device=answer_tokens.device)[None, :]
        # padded tokens take position 0, the table's zero row
        positions = torch.where(pad_bias[:, 0, 0, :] != 0, 0, positions)

        embedded, _ = self.word_emb(answer_tokens, generator)
        out = embedded + self.pos_table[positions]
        for layer in self.layers:
            out = layer(out, encoder_features, encoder_features, self_bias,
                        encoder_attention_bias, generator)
        return torch.log_softmax(self.fc(out), dim=-1)

    # -- decode ------------------------------------------------------------------
    @torch.no_grad()
    def prepare_decode(self, encoder_features, encoder_attention_bias) -> Dict:
        """The decode steps' invariants, computed once per generate from the
        encoder stream already expanded to one row per beam."""
        parts = _ds.decode_kernel_parts()
        rows, keys = encoder_features.shape[:2]
        return {
            "layers": [layer.precast_bundle(encoder_features, encoder_features, parts)
                       for layer in self.layers],
            "enc_bias": key_bias_rows(encoder_attention_bias, rows, keys, encoder_features.device),
        }

    def init_cache(self, rows: int, device) -> Dict:
        """Zeroed ring caches, one per layer, and the position counter."""
        return {
            "pos": 0,
            "layers": [layer.self_attn.init_decode_cache(rows, self.max_len, device)
                       for layer in self.layers],
        }

    @torch.no_grad()
    def step(self, token: torch.Tensor, cache: Dict, prep: Dict) -> torch.Tensor:
        """One decode token per row, token (rows, 1): log-probs (rows, 1, V).
        Writes the rings of `cache` in place and advances its counter; the
        token's position is t + 1 whatever the token."""
        t = cache["pos"]
        cache["pos"] = t + 1
        step_bias = padding_bias(token, self.padding_idx)[:, 0, 0, 0].contiguous()
        embedded, _ = self.word_emb(token)
        out = embedded + self.pos_table[t + 1]
        layer_caches: List = cache["layers"]
        for layer, layer_cache, bundle in zip(self.layers, layer_caches, prep["layers"]):
            out = layer.decode_step(out, layer_cache, bundle, step_bias, prep["enc_bias"], t)
        return torch.log_softmax(self.fc(out), dim=-1)


@META_DECODER.register()
class AdaptiveDecoder(Decoder):
    """The Decoder's LAYERS layers, one more layer on ADAPTIVE_ATTENTION (its
    self-attention the adaptive core) and a frozen language model
    (LANGUAGE_MODEL, from the PRETRAINED_LANGUAGE_MODEL registry) whose
    signals over the answer tokens feed the adaptive column.

    Decode keeps the Decoder's explicit state: the ordinary layers take the
    layer step, the adaptive layer is routed core by core (its self-attention
    on the plain cached route with the step's signals, its cross-attention
    and FFN on kernels B and C where 'layer' is chosen).  As in the JAX
    package, a step runs the language model on the current token only."""

    def __init__(self, config, vocab):
        super().__init__(config, vocab)
        self.layers.append(DecoderLayer(config.ADAPTIVE_ATTENTION))
        self.language_model = build_pretrained_language_model(config.LANGUAGE_MODEL, vocab)

    def forward(self, answer_tokens, encoder_features, encoder_attention_bias,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        seq_len = answer_tokens.shape[1]
        pad_bias = padding_bias(answer_tokens, self.padding_idx)
        self_bias = combine_biases(pad_bias, causal_bias(seq_len, answer_tokens.device))
        positions = torch.arange(1, seq_len + 1, device=answer_tokens.device)[None, :]
        positions = torch.where(pad_bias[:, 0, 0, :] != 0, 0, positions)
        _, signals = self.language_model(answer_tokens, generator)
        embedded, _ = self.word_emb(answer_tokens, generator)
        out = embedded + self.pos_table[positions]
        for layer in self.layers:
            out = layer(out, encoder_features, encoder_features, self_bias,
                        encoder_attention_bias, generator, language_signals=signals)
        return torch.log_softmax(self.fc(out), dim=-1)

    @torch.no_grad()
    def step(self, token: torch.Tensor, cache: Dict, prep: Dict) -> torch.Tensor:
        t = cache["pos"]
        cache["pos"] = t + 1
        step_bias = padding_bias(token, self.padding_idx)[:, 0, 0, 0].contiguous()
        _, signals = self.language_model(token)
        embedded, _ = self.word_emb(token)
        out = embedded + self.pos_table[t + 1]
        for layer, layer_cache, bundle in zip(self.layers, cache["layers"], prep["layers"]):
            out = layer.decode_step(out, layer_cache, bundle, step_bias, prep["enc_bias"], t,
                                    signals)
        return torch.log_softmax(self.fc(out), dim=-1)
