"""ALBERT and DeBERTa in the port against the JAX package and against
``transformers``.

The port's ``AlbertEncoderStack`` and ``DebertaV2EncoderStack`` (kernel F and
the two-bias attention with kernel C on the card; their plain versions here)
against the flax stacks on weights bridged by ``models/convert.py``, and
against HF ``AlbertModel`` / ``DebertaV2Model`` loaded with ``load_state_dict``
(the port carries HF's names); DeBERTa's bucket table integer-equal to the JAX
one; the two-bias attention's plain version at the DeBERTa form (a per-sample
head bias, hb = b) against the Pallas kernel in interpret mode; the
AlbertEmbedding and DebertaEmbedding wrappers against flax.  Float32
tolerances: 1e-5 against flax, 5e-5 against torch's own attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from jax.experimental.pallas import tpu as pltpu

from openvivqa_tpu import builders as jax_builders
from openvivqa_tpu.models.modules import deberta as jax_deberta
from openvivqa_tpu.models.modules.albert import AlbertEncoderStack as JaxAlbert
from openvivqa_tpu.models.modules.deberta import DebertaV2EncoderStack as JaxDeberta
from openvivqa_tpu.models.modules.masks import padding_bias as jax_padding_bias
from openvivqa_tpu.models.modules.pretrained_embeddings import (
    AlbertEmbedding as JaxAlbertEmbedding,
    DebertaEmbedding as JaxDebertaEmbedding,
)
from openvivqa_tpu.ops import fused_attention as jattn
from openvivqa_tpu_torch import builders
from openvivqa_tpu_torch.config import ConfigNode
from openvivqa_tpu_torch.models import convert
from openvivqa_tpu_torch.models.modules import deberta
from openvivqa_tpu_torch.models.modules.albert import AlbertEncoderStack
from openvivqa_tpu_torch.models.modules.deberta import DebertaV2EncoderStack
from openvivqa_tpu_torch.models.modules.masks import padding_bias
from openvivqa_tpu_torch.ops import fused_attention

jax_builders.populate()
builders.populate()


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=1e-5, rtol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _tokens(seed, b=3, length=10, vocab=60):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, vocab, size=(b, length)).astype(np.int32)
    tokens[0, -3:] = 0
    tokens[2, -1:] = 0
    return tokens


def _flax_params(module, tokens, seed, bias=True):
    args = (jnp.asarray(tokens),)
    if bias:
        args += (jax_padding_bias(jnp.asarray(tokens), 0),)
    params = module.init(jax.random.PRNGKey(seed), *args)["params"]
    # nonzero biases and LayerNorm offsets, so that the bridge's every tensor counts
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (0.02 * rng.normal(size=x.shape)).astype(np.float32), params)


def _load(port, family, params):
    port.load_state_dict({k: _t(v) for k, v in convert.backbone_state(family, params).items()})
    return port.eval()


# -- DeBERTa's relative positions ------------------------------------------------------------
@pytest.mark.parametrize("length,buckets,max_position", [
    (10, 8, 40), (197, 256, 512), (64, 256, 512), (300, 256, 512), (33, -1, 24)])
def test_bucket_table_is_integer_equal_to_jax(length, buckets, max_position):
    got = deberta.build_relative_position(length, length, buckets, max_position)
    want = jax_deberta.build_relative_position(length, length, buckets, max_position)
    assert got.dtype == np.int64 and np.array_equal(got, want)


# -- ALBERT ------------------------------------------------------------------------------------
@pytest.mark.parametrize("groups,inner", [(1, 1), (2, 2)])
def test_albert_stack_matches_flax(groups, inner):
    kwargs = dict(vocab_size=60, hidden_size=32, num_layers=4, num_heads=4, embedding_size=16,
                  intermediate_size=48, num_groups=groups, inner_group_num=inner,
                  max_position_embeddings=24)
    tokens = _tokens(0)
    jax_stack = JaxAlbert(**kwargs)
    params = _flax_params(jax_stack, tokens, 1)
    bias = jax_padding_bias(jnp.asarray(tokens), 0)
    want = jax_stack.apply({"params": params}, jnp.asarray(tokens), attention_bias=bias)
    port = _load(AlbertEncoderStack(**kwargs), "albert", params)
    with torch.no_grad():
        got = port(_t(tokens), padding_bias(_t(tokens), 0))
    _close(got, want)


@pytest.mark.parametrize("groups,inner", [(1, 1), (2, 1)])
def test_albert_stack_matches_transformers(groups, inner):
    config = transformers.AlbertConfig(
        vocab_size=70, embedding_size=16, hidden_size=32, num_hidden_layers=4,
        num_hidden_groups=groups, inner_group_num=inner, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=40, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(3)
    hf = transformers.AlbertModel(config, add_pooling_layer=False).eval()
    port = AlbertEncoderStack(70, 32, 4, 4, embedding_size=16, intermediate_size=64,
                              num_groups=groups, inner_group_num=inner,
                              max_position_embeddings=40)
    port.load_state_dict({k: v for k, v in hf.state_dict().items()
                          if not k.endswith("position_ids")})
    tokens = torch.from_numpy(_tokens(4, vocab=70)).long()
    mask = (tokens != 0).float()
    with torch.no_grad():
        want = hf(input_ids=tokens, attention_mask=mask).last_hidden_state
        got = port.eval()(tokens, padding_bias(tokens, 0))
    valid = mask.bool()
    _close(got[valid], want[valid].numpy(), atol=5e-5)


# -- DeBERTa -----------------------------------------------------------------------------------
DEBERTA_STYLES = {
    # the published layouts (config.json), buckets cut to 8
    "v3": dict(position_biased_input=False, position_buckets=8, share_att_key=True,
               norm_rel_ebd="layer_norm"),
    "v2-xlarge": dict(position_biased_input=False, position_buckets=8, share_att_key=True,
                      norm_rel_ebd="layer_norm", conv_kernel_size=3, conv_groups=1),
    # DebertaV2Config's defaults: absolute positions, unbucketed, separate position
    # projections, no LayerNorm on the relative table
    "unshared": dict(position_biased_input=True, position_buckets=-1, share_att_key=False,
                     norm_rel_ebd="none"),
}


@pytest.mark.parametrize("style", sorted(DEBERTA_STYLES))
def test_deberta_stack_matches_flax(style):
    kwargs = dict(vocab_size=60, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=48,
                  max_position_embeddings=24, **DEBERTA_STYLES[style])
    tokens = _tokens(5)
    jax_stack = JaxDeberta(**kwargs)
    params = _flax_params(jax_stack, tokens, 6)
    bias = jax_padding_bias(jnp.asarray(tokens), 0)
    want = jax_stack.apply({"params": params}, jnp.asarray(tokens), attention_bias=bias)
    port = _load(DebertaV2EncoderStack(**kwargs), "deberta", params)
    with torch.no_grad():
        got = port(_t(tokens), padding_bias(_t(tokens), 0))
    _close(got, want)


@pytest.mark.parametrize("style", sorted(DEBERTA_STYLES))
def test_deberta_stack_matches_transformers(style):
    extra = DEBERTA_STYLES[style]
    config = transformers.DebertaV2Config(
        vocab_size=80, hidden_size=32, num_hidden_layers=3, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=40, relative_attention=True,
        position_biased_input=extra["position_biased_input"],
        position_buckets=extra["position_buckets"], pos_att_type=["p2c", "c2p"],
        share_att_key=extra["share_att_key"], norm_rel_ebd=extra["norm_rel_ebd"],
        conv_kernel_size=extra.get("conv_kernel_size", 0), type_vocab_size=0,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, pad_token_id=0)
    torch.manual_seed(7)
    hf = transformers.DebertaV2Model(config).eval()
    port = DebertaV2EncoderStack(80, 32, 3, 4, intermediate_size=64, max_position_embeddings=40,
                                 **extra)
    port.load_state_dict({k: v for k, v in hf.state_dict().items()
                          if not k.endswith("position_ids")})
    tokens = torch.from_numpy(_tokens(8, vocab=80)).long()
    mask = (tokens != 0).float()
    with torch.no_grad():
        want = hf(input_ids=tokens, attention_mask=mask).last_hidden_state
        got = port.eval()(tokens, padding_bias(tokens, 0))
    valid = mask.bool()
    _close(got[valid], want[valid].numpy(), atol=5e-5)


def test_two_bias_plain_matches_jax_kernel_interpret_per_sample():
    """The DeBERTa form of the two-bias attention: a (b, 1, 1, L) padding bias
    and a per-sample (b, h, L, L) head bias, scale 1 / sqrt(3 d), 12 heads of
    64 at bf16, against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(9)
    b, n, heads, d = 2, 10, 12, 64
    hd = heads * d

    def bf16(x):
        return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))

    q, k, v = (bf16(rng.normal(size=(b, n, hd)).astype(np.float32)) for _ in range(3))
    head_bias = rng.normal(size=(b, heads, n, n)).astype(np.float32)
    bias = np.zeros((b, 1, 1, n), np.float32)
    bias[0, ..., -3:] = -10e4
    scale = 1.0 / np.sqrt(3.0 * d)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.fused_attention_packed_2bias(
            *(jnp.asarray(x) for x in (q, k, v, bias, head_bias)), scale, heads)
    got = fused_attention.fused_attention_packed_2bias_plain(
        *(_t(x) for x in (q, k, v, bias, head_bias)), scale, heads, op_dtype=torch.bfloat16)
    _close(got, want)


# -- the wrappers ------------------------------------------------------------------------------
class _Vocab:
    padding_idx, bos_idx, eos_idx, unk_idx = 0, 1, 2, 3

    def __len__(self):
        return 60


WRAPPERS = {
    "AlbertEmbedding": (JaxAlbertEmbedding, {"PRETRAINED_NAME": "albert-base-v2",
                                             "PRETRAINED_EMBEDDING_SIZE": 16}),
    "DebertaEmbedding": (JaxDebertaEmbedding, {"PRETRAINED_NAME": "microsoft/deberta-v3-base"}),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_text_wrapper_matches_flax(name):
    """The wrapper at its checkpoint's layout (ALBERT's shared group, DeBERTa-v3's
    256 buckets, shared keys and LayerNormed table) cut to 2 layers of 32 wide:
    the backbone, the projection and exact GELU; the padding bias it returns."""
    jax_cls, spec = WRAPPERS[name]
    config = ConfigNode({"ARCHITECTURE": name, "D_MODEL": 24, "DROPOUT": 0.1,
                         "D_PRETRAINED_FEATURE": 32, "PRETRAINED_LAYERS": 2,
                         "NUM_ATTENTION_HEADS": 4, "PRETRAINED_VOCAB_SIZE": 60,
                         "PRETRAINED_INTERMEDIATE_SIZE": 48, **spec})
    tokens = _tokens(10)
    jax_wrapper = jax_cls(config=config, vocab=_Vocab())
    params = jax_wrapper.init(jax.random.PRNGKey(11), jnp.asarray(tokens))["params"]
    if name == "DebertaEmbedding":
        # the JAX wrapper builds an absolute position table that deberta-v3's
        # published config lacks and the port's wrapper does not: zeroed, it adds
        # nothing
        table = params["backbone"]["position_embeddings"]["embedding"]
        params = dict(params, backbone=dict(
            params["backbone"], position_embeddings={"embedding": jnp.zeros_like(table)}))
    want, want_bias = jax_wrapper.apply({"params": params}, jnp.asarray(tokens))
    port = builders.build_text_embedding(config, _Vocab()).eval()
    state = {}
    convert._pretrained_text_embedding(state, "w", params)
    if name == "DebertaEmbedding":
        assert not state.pop("w.backbone.embeddings.position_embeddings.weight").any()
    port.load_state_dict({key[2:]: _t(value) for key, value in state.items()})
    with torch.no_grad():
        got, got_bias = port(_t(tokens))
    _close(got, want)
    _close(got_bias, want_bias)
    assert not any(p.requires_grad for p in port.backbone.parameters())
