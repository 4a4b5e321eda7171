"""BERT-style post-LN transformer stack, routed through the kernels.

Counterpart of ``openvivqa_tpu/models/modules/bert.py`` (BertSelfAttention,
BertLayer, BertEncoderStack, BertEmbeddings).  Parameter names are those of
the HuggingFace BertLayer the reference checkpoints hold
(``attention.self.query``, ``attention.output.LayerNorm``,
``intermediate.dense``, ``output.dense``, ``output.LayerNorm``, ...), so
``openvivqa_tpu.models.modules.torch_conversion`` reads this module's
``state_dict()`` directly.

Eval routes (CPU tensors take each kernel's plain version; call under
``torch.no_grad()``):
  * self-attention with no bias or a key-only (b, 1, 1, S) bias -> kernel F;
  * self-attention with a full (b, 1, Sq, Sk) bias (the causal decoder's
    (1, 1, T, T) one included), and every cross-attention (``kv_states``, the
    ``crossattention`` sublayer of a cross-attention BertLayer) whatever its
    bias -> the packed attention kernel between plain q/k/v and out
    projections; kernel F is self-attention only and never sees them (the
    encoder rows a cross-attention projects to keys and values, here or in
    ``BertLayer.project_cross_kv``, add to the ``decode.cross_kv_rows`` counter);
  * every FFN, multi-row encodes and single-row decode steps -> kernel C;
  * every incremental decode step of the MMT -> kernel D (the Iterative M4C
    family's decoder steps are driven by its model: kernels A, E and C).
Training route, taken when a ``generator`` is passed (``openvivqa_tpu/models/
modules/bert.py:228-338``): q/k/v projections as ``nn.Linear``, then every
self-attention (head-shared biases only reach this module, TextBert's 10-key
one included) through the dropout attention kernel when the rate is above 0,
else through the packed attention's autograd function; out projection,
dropout, residual LayerNorm; the FFN as Linear, exact-erf GELU, Linear,
dropout, LayerNorm.  Kernels C and F are eval-only, as in the JAX package.
Dropout draws from the explicit ``generator`` (never the global RNG), and so
does the dropout kernel's seed, one draw per call.  Rates are the modules'
``dropout`` attributes (0.1, the JAX package's defaults).

Kernel weight bundles (`kernel_weights`) hold the matrices transposed to
(in, out) and cast to ``kernel_dtype(device)`` (bf16 on the card) with q|k|v
packed into one (hd, 3hd) matrix.  Callers build them once per forward or
decode, outside any loop.  The wrappers are called through their modules'
attributes (``_ds.fused_ffn_step``), so a comparison run can swap in the plain
versions (chip_smoke.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import _cuda
from ...ops import decode_step as _ds
from ...ops import encoder_layer as _enc
from ...ops import fused_attention as _attn
from ...parallel.mesh import whole
from ...utils import tracing

LN_EPS = 1e-12


def _matrix(linear: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """A Linear's weight, whole, as the (in, out) matrix the kernels read."""
    return whole(linear.weight).detach().t().to(dtype).contiguous()


def vector(param: torch.Tensor) -> torch.Tensor:
    """A bias or LayerNorm parameter, whole, as the float32 vector the kernels read."""
    return whole(param).detach().float()


def init_jax_law_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initialisers, drawn from `generator` in module order:
    normal(0.02) for Linear and Embedding weights, zero biases, LayerNorm
    scale 1 and bias 0."""
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, (nn.Linear, nn.Embedding)):
                sub.weight.copy_(
                    torch.randn(sub.weight.shape, generator=generator) * 0.02
                )
                if getattr(sub, "bias", None) is not None:
                    sub.bias.zero_()
            elif isinstance(sub, nn.LayerNorm):
                sub.weight.fill_(1.0)
                sub.bias.zero_()
    return module


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawn from `generator`; the identity without one (eval)
    or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep / (1.0 - rate)


def draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """One (1,) int64 kernel seed in [0, 2^31 - 1) from `generator`, left on
    the device so that drawing it never waits for the host."""
    return torch.randint(0, 2**31 - 1, (1,), generator=generator, device=device)


def _is_key_only(bias: Optional[torch.Tensor]) -> bool:
    return bias is None or (bias.ndim == 4 and bias.shape[1] == 1 and bias.shape[2] == 1)


class _Projections(nn.Module):
    def __init__(self, hidden_size: int):
        super().__init__()
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)


class _DenseLayerNorm(nn.Module):
    def __init__(self, in_size: int, hidden_size: int):
        super().__init__()
        self.dense = nn.Linear(in_size, hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=LN_EPS)


class _Dense(nn.Module):
    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.dense = nn.Linear(in_size, out_size)


class BertSelfAttention(nn.Module):
    """q/k/v/out projections + softmax attention + residual LayerNorm
    (HF BertAttention: ``self.{query,key,value}``, ``output.{dense,LayerNorm}``).
    With ``kv_states`` it is a cross-attention: keys and values project those
    states while the residual stays on ``hidden``."""

    def __init__(self, hidden_size: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden size {hidden_size} not divisible by {num_heads} heads")
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.dropout = dropout
        self.scale = 1.0 / float(hidden_size // num_heads) ** 0.5
        self.self = _Projections(hidden_size)
        self.output = _DenseLayerNorm(hidden_size, hidden_size)

    @torch.no_grad()
    def kernel_weights(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        p = self.self
        return {
            "wqkv": torch.cat([_matrix(p.query, dtype), _matrix(p.key, dtype),
                               _matrix(p.value, dtype)], dim=1),
            "bqkv": torch.cat([vector(p.query.bias), vector(p.key.bias), vector(p.value.bias)]),
            "wo": _matrix(self.output.dense, dtype),
            "bo": vector(self.output.dense.bias),
            "ln_scale": vector(self.output.LayerNorm.weight),
            "ln_bias": vector(self.output.LayerNorm.bias),
        }

    @torch.no_grad()
    def cross_kernel_weights(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """Kernel E's bundle: the q projection alone (keys and values are
        projected once per sequence) and the out projection + LayerNorm."""
        return {
            "wq": _matrix(self.self.query, dtype),
            "bq": vector(self.self.query.bias),
            "wo": _matrix(self.output.dense, dtype),
            "bo": vector(self.output.dense.bias),
            "ln_scale": vector(self.output.LayerNorm.weight),
            "ln_bias": vector(self.output.LayerNorm.bias),
        }

    def project_kv(self, states: torch.Tensor):
        """Packed (b, S, hd) key and value projections of `states`."""
        return self.self.key(states), self.self.value(states)

    def attend(self, hidden, keys, values, attention_bias):
        """Eval sublayer of `hidden`'s queries over pre-projected float32 (b,
        S, hd) keys and values: the packed attention between the q and out
        projections, then the residual LayerNorm."""
        context = _attn.fused_attention_packed(
            self.self.query(hidden), keys, values, attention_bias, self.scale, self.num_heads
        )
        return self.output.LayerNorm(hidden + self.output.dense(context))

    def forward(self, hidden, attention_bias=None, weights=None, generator=None,
                kv_states=None):
        if generator is not None:
            return self._train_forward(hidden, attention_bias, generator, kv_states)
        if kv_states is None and _is_key_only(attention_bias):
            b, s, _ = hidden.shape
            if weights is None:
                weights = self.kernel_weights(_cuda.kernel_dtype(hidden.device))
            if attention_bias is None:
                key_bias = torch.zeros((b, s), dtype=torch.float32, device=hidden.device)
            else:
                key_bias = attention_bias[:, 0, 0, :].expand(b, s).float().contiguous()
            return _enc.fused_encoder_self_attention(
                hidden.float().contiguous(), weights, key_bias, self.scale,
                self.num_heads, LN_EPS,
            )
        if kv_states is not None:
            tracing.count("decode.cross_kv_rows", kv_states.shape[0] * kv_states.shape[1])
        k, v = self.project_kv(hidden if kv_states is None else kv_states)
        return self.attend(hidden, k, v, attention_bias)

    def _train_forward(self, hidden, attention_bias, generator, kv_states=None):
        q = self.self.query(hidden)
        k, v = self.project_kv(hidden if kv_states is None else kv_states)
        if self.dropout > 0.0:
            context = _attn.fused_attention_packed_dropout(
                q, k, v, attention_bias, draw_seed(generator, hidden.device), self.scale,
                self.num_heads, self.dropout,
            )
        else:
            context = _attn.fused_attention_packed(
                q, k, v, attention_bias, self.scale, self.num_heads
            )
        out = dropout(self.output.dense(context), self.dropout, generator)
        return self.output.LayerNorm(hidden + out)


class BertLayer(nn.Module):
    """Self-attention sublayer (+ with ``cross_attention`` the HF decoder's
    ``crossattention`` sublayer over encoder states) + GELU FFN sublayer,
    post-LN."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: Optional[int] = None,
                 dropout: float = 0.1, cross_attention: bool = False):
        super().__init__()
        d_ff = intermediate_size or 4 * hidden_size
        self.dropout = dropout
        self.attention = BertSelfAttention(hidden_size, num_heads, dropout)
        self.crossattention = (
            BertSelfAttention(hidden_size, num_heads, dropout) if cross_attention else None
        )
        self.intermediate = _Dense(hidden_size, d_ff)
        self.output = _DenseLayerNorm(d_ff, hidden_size)

    @torch.no_grad()
    def kernel_weights(self, dtype: torch.dtype) -> Dict[str, Dict[str, torch.Tensor]]:
        cross = {}
        if self.crossattention is not None:
            cross = {"crossattention": self.crossattention.cross_kernel_weights(dtype)}
        return {"attention": self.attention.kernel_weights(dtype), **cross,
                "ffn": self.ffn_kernel_weights(dtype)}

    @torch.no_grad()
    def ffn_kernel_weights(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        return {
            "w1": _matrix(self.intermediate.dense, dtype),
            "b1": vector(self.intermediate.dense.bias),
            "w2": _matrix(self.output.dense, dtype),
            "b2": vector(self.output.dense.bias),
            "ln_scale": vector(self.output.LayerNorm.weight),
            "ln_bias": vector(self.output.LayerNorm.bias),
        }

    def project_kv(self, states):
        return self.attention.project_kv(states)

    def project_cross_kv(self, states):
        """Packed (b, S, hd) cross-attention key and value projections of the
        encoder states: once per sequence when decoding."""
        tracing.count("decode.cross_kv_rows", states.shape[0] * states.shape[1])
        return self.crossattention.project_kv(states)

    def decode_step(self, hidden, k_cache, v_cache, attention_bias, cross_kv=None,
                    encoder_bias=None):
        """The plain decode route of one (b, 1, hd) token: self-attention over
        the pre-projected float32 caches, cross-attention over the pre-projected
        encoder K/V when given, then the FFN (kernel C).  Eval only."""
        hidden = self.attention.attend(hidden, k_cache, v_cache, attention_bias)
        if cross_kv is not None:
            hidden = self.crossattention.attend(hidden, *cross_kv, encoder_bias)
        return self.ffn(hidden)

    def ffn(self, hidden, weights=None):
        f = weights
        if f is None:
            f = self.ffn_kernel_weights(_cuda.kernel_dtype(hidden.device))
        rows = hidden.reshape(-1, hidden.shape[-1]).float().contiguous()
        out = _ds.fused_ffn_step(
            rows, f["w1"], f["b1"], f["w2"], f["b2"], f["ln_scale"], f["ln_bias"], eps=LN_EPS
        )
        return out.reshape(hidden.shape)

    def _train_ffn(self, hidden, generator):
        intermediate = F.gelu(self.intermediate.dense(hidden))
        out = dropout(self.output.dense(intermediate), self.dropout, generator)
        return self.output.LayerNorm(hidden + out)

    def forward(self, hidden, attention_bias=None, weights=None, generator=None,
                encoder_states=None, encoder_bias=None):
        if generator is not None:
            hidden = self.attention(hidden, attention_bias, generator=generator)
        else:
            weights = weights or self.kernel_weights(_cuda.kernel_dtype(hidden.device))
            hidden = self.attention(hidden, attention_bias, weights["attention"])
        if self.crossattention is not None:
            hidden = self.crossattention(hidden, encoder_bias, generator=generator,
                                         kv_states=encoder_states)
        if generator is not None:
            return self._train_ffn(hidden, generator)
        return self.ffn(hidden, weights["ffn"])


class BertEncoderStack(nn.Module):
    """N BertLayers (``layer.N``).  Full-sequence encode via forward;
    incremental decode via project_context (once per sequence) and
    fused_decode_step (once per token, kernels D and C).  With
    ``cross_attention`` every layer has the ``crossattention`` sublayer (a BERT
    decoder stack, whose decode steps its model drives layer by layer)."""

    def __init__(self, hidden_size: int, num_layers: int, num_heads: int,
                 intermediate_size: Optional[int] = None, cross_attention: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.layer = nn.ModuleList(
            BertLayer(hidden_size, num_heads, intermediate_size, cross_attention=cross_attention)
            for _ in range(num_layers)
        )

    def kernel_weights(self, device) -> List[Dict]:
        """Per-layer kernel weight bundles in ``kernel_dtype(device)``."""
        dtype = _cuda.kernel_dtype(device)
        return [layer.kernel_weights(dtype) for layer in self.layer]

    def forward(self, hidden, attention_bias=None, return_layer_inputs: bool = False,
                weights=None, generator=None, encoder_states=None, encoder_bias=None,
                return_all: bool = False):
        """Eval encode through the kernels, or, with a `generator`, the
        training route (the weight bundles are not built then).  Returns the
        last hidden states, with ``return_layer_inputs`` also each layer's
        input, with ``return_all`` also each layer's output (the multilevel
        decoder cross-attends layer i's)."""
        if return_all and return_layer_inputs:
            raise ValueError("return_all and return_layer_inputs are mutually exclusive")
        if generator is not None:
            weights = [None] * len(self.layer)
        elif weights is None:
            weights = self.kernel_weights(hidden.device)
        layer_inputs, all_states = [], []
        for layer, w in zip(self.layer, weights):
            layer_inputs.append(hidden)
            hidden = layer(hidden, attention_bias, w, generator, encoder_states, encoder_bias)
            all_states.append(hidden)
        if return_layer_inputs:
            return hidden, layer_inputs
        if return_all:
            return hidden, all_states
        return hidden

    def project_context(self, layer_inputs):
        """Per-layer packed (K, V) projections of the frozen context states."""
        return tuple(
            layer.project_kv(states) for layer, states in zip(self.layer, layer_inputs)
        )

    def init_fused_decode_state(self, context_kv, col_bias, dec_len: int, weights=None):
        """Kernel-D decode state, built once per sequence: the weight bundles,
        per-layer context (K, V) in the cache dtype (bf16 on the card), per-layer
        zeroed (bs, dec_len, hd) slot caches and the (bs, C) float32 context bias.
        Unlike the JAX package, the context is not padded to a chunk multiple."""
        device = context_kv[0][0].device
        dtype = _cuda.kernel_dtype(device)
        bs, ctx_len = context_kv[0][0].shape[:2]
        if weights is None:
            weights = self.kernel_weights(device)

        def cache(x):
            return x.to(dtype).contiguous()

        return {
            "weights": weights,
            "ctx_kvs": tuple((cache(k), cache(v)) for k, v in context_kv),
            "slots": tuple(
                tuple(torch.zeros((bs, dec_len, self.hidden_size), dtype=dtype, device=device)
                      for _ in range(2))
                for _ in self.layer
            ),
            "ctx_bias": col_bias[:, 0, 0, :].expand(bs, ctx_len).float().contiguous(),
        }

    def fused_decode_step(self, hidden, state, step: int):
        """One new token (bs, 1, hd) through every layer: kernel D then kernel C.
        The slot caches in `state` are written in place at min(step, T-1).
        Returns (bs, 1, hd)."""
        scale = 1.0 / float(self.hidden_size // self.num_heads) ** 0.5
        x = hidden[:, 0, :].float().contiguous()
        for i, w in enumerate(state["weights"]):
            slot_k, slot_v = state["slots"][i]
            x, _, _ = _ds.fused_bert_self_step(
                x, w["attention"], state["ctx_kvs"][i], slot_k, slot_v, step,
                state["ctx_bias"], scale, self.num_heads, LN_EPS,
            )
            f = w["ffn"]
            x = _ds.fused_ffn_step(
                x, f["w1"], f["b1"], f["w2"], f["b2"], f["ln_scale"], f["ln_bias"], eps=LN_EPS
            )
        return x[:, None, :]


class BertEmbeddings(nn.Module):
    """Word + learned position + token-type embeddings, LayerNorm, dropout."""

    def __init__(self, vocab_size: int, hidden_size: int, max_position_embeddings: int = 512,
                 type_vocab_size: int = 2, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_position_embeddings, hidden_size)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=LN_EPS)

    def forward(self, token_ids, generator=None):
        token_ids = token_ids.long()
        positions = torch.arange(token_ids.shape[1], device=token_ids.device)[None]
        out = (
            self.word_embeddings(token_ids)
            + self.position_embeddings(positions)
            + self.token_type_embeddings(torch.zeros_like(token_ids))
        )
        return dropout(self.LayerNorm(out), self.dropout, generator)
