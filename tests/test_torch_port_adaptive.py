"""The AdaptiveDecoder with its frozen language model, and the last attention
and encoder modules, in the port against the JAX package.

Every module gets the same numpy-drawn inputs on both sides and the flax
parameters bridged by ``params_from_flax`` (or the bridge's module helpers):
the box-relation embedding, the geometry, memory and adaptive attention cores,
the AoA gates, the GeometricEncoder, SpatialCirclePosition and
TextSemanticSeparate within 1e-5 (1e-4 downstream of the trigonometric box
embedding, whose angles reach ~690 rad); the frozen causal LM (BERTModel); the
AdaptiveDecoder under IterativeMCAN teacher-forced and step by step on each
decode route, beam-3 generate against the JAX package's, and one gradient of
the decoder against ``jax.grad``.  The registries of the two packages hold the
same names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvivqa_tpu import builders as jax_builders
from openvivqa_tpu.config import ConfigNode as JaxConfigNode
from openvivqa_tpu.models.iterative_mcan import IterativeMCAN as JaxIterativeMCAN
from openvivqa_tpu.models.modules import attentions as jattentions
from openvivqa_tpu.models.modules import encoders as jencoders
from openvivqa_tpu.models.modules import masks as jmasks
from openvivqa_tpu.models.modules import scp_tss as jscp
from openvivqa_tpu.models.modules.pretrained_embeddings import BERTModel as JaxBERTModel
from openvivqa_tpu.training import decode as jdecode
from openvivqa_tpu_torch import builders
from openvivqa_tpu_torch.config import ConfigNode
from openvivqa_tpu_torch.models import convert
from openvivqa_tpu_torch.models.convert import params_from_flax
from openvivqa_tpu_torch.models.iterative_mcan import IterativeMCAN
from openvivqa_tpu_torch.models.modules import attentions, encoders, masks, scp_tss
from openvivqa_tpu_torch.training import decode

jax_builders.populate()
builders.populate()

D, HEADS, MASK = 32, 4, -10e4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=1e-5, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _noisy(params, seed):
    """Nonzero biases and LayerNorm offsets, so that every bridged tensor counts."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (0.05 * rng.normal(size=np.shape(x))).astype(np.float32),
        params)


def _attention(arch="ScaledDotProductAttention", stateful=False, dropout=0.1, **extra):
    return {"ARCHITECTURE": arch, "HEAD": HEADS, "D_MODEL": D, "D_KEY": D // HEADS,
            "D_VALUE": D // HEADS, "D_FF": 2 * D, "USE_AOA": False, "CAN_BE_STATEFUL": stateful,
            "DROPOUT": dropout, **extra}


def _boxes(rng, b, n):
    xy = rng.uniform(0.0, 0.6, size=(b, n, 2))
    wh = rng.uniform(0.05, 0.4, size=(b, n, 2))
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def _key_bias(rng, b, n):
    bias = np.where(rng.random((b, 1, 1, n)) < 0.25, MASK, 0.0).astype(np.float32)
    bias[..., 0] = 0.0
    return bias


def _registry_names(module):
    return {name: set(getattr(module, name).keys()) for name in dir(module)
            if name.startswith("META_")}


def test_every_jax_registration_is_in_the_port():
    ours, theirs = _registry_names(builders), _registry_names(jax_builders)
    assert set(theirs) <= set(ours)
    missing = {name: sorted(theirs[name] - ours[name]) for name in theirs
               if theirs[name] - ours[name]}
    assert not missing, missing


# -- the plain-torch modules -------------------------------------------------------------
@pytest.mark.parametrize("trig", [True, False])
def test_box_relational_embedding_matches_jax(trig):
    """The log displacements within 1e-5; their sines and cosines within 1e-4:
    the angles reach 100 * |log 1e-3| ~ 690 rad, where one float32 ulp of the
    angle is 6e-5."""
    boxes = _boxes(np.random.default_rng(0), 2, 6)
    want = jmasks.box_relational_embedding(jnp.asarray(boxes), dim_g=16,
                                           trignometric_embedding=trig)
    got = masks.box_relational_embedding(_t(boxes), dim_g=16, trignometric_embedding=trig)
    _close(got, want, atol=1e-4 if trig else 1e-5)


CORES = {
    "geometry": ("AugmentedGeometryScaledDotProductAttention", {"TRIGNOMETRIC_EMBEDDING": True}),
    "geometry-4": ("AugmentedGeometryScaledDotProductAttention",
                   {"TRIGNOMETRIC_EMBEDDING": False}),
    "memory": ("AugmentedMemoryScaledDotProductAttention", {"MEMORY": 5}),
    "adaptive": ("AdaptiveScaledDotProductAttention", {}),
}


@pytest.mark.parametrize("core", sorted(CORES))
@pytest.mark.parametrize("aoa", [False, True])
def test_multi_head_attention_with_each_core_matches_flax(core, aoa):
    """MultiHeadAttention over the core (self-attention over 7 tokens with
    padded keys), with and without the AoA gates; within 1e-5, 1e-4 over the
    trigonometric box embedding (an ulp of its angles, see above)."""
    arch, extra = CORES[core]
    config = _attention(arch, **extra, USE_AOA=aoa)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, D)).astype(np.float32)
    bias = _key_bias(rng, 2, 7)
    kwargs = {}
    if core.startswith("geometry"):
        kwargs["boxes"] = _boxes(rng, 2, 7)
    if core == "adaptive":
        kwargs["language_signals"] = rng.normal(size=(2, 7, D)).astype(np.float32)
    flax_mha = jattentions.MultiHeadAttention(JaxConfigNode(config))
    jargs = (jnp.asarray(x), jnp.asarray(x), jnp.asarray(x), jnp.asarray(bias))
    jkw = {k: jnp.asarray(v) for k, v in kwargs.items()}
    params = _noisy(flax_mha.init(jax.random.PRNGKey(2), *jargs, **jkw)["params"], 3)
    want = flax_mha.apply({"params": params}, *jargs, **jkw)
    port = attentions.MultiHeadAttention(ConfigNode(config)).eval()
    state = {}
    convert._multi_head_attention(state, "m", params)
    port.load_state_dict({key[2:]: _t(value) for key, value in state.items()})
    with torch.no_grad():
        got = port(_t(x), _t(x), _t(x), _t(bias), **{k: _t(v) for k, v in kwargs.items()})
    _close(got, want, atol=1e-4 if core == "geometry" else 1e-5)


def test_geometric_encoder_matches_flax():
    config = {"ARCHITECTURE": "GeometricEncoder", "D_MODEL": D, "LAYERS": 2,
              "SELF_ATTENTION": _attention("AugmentedGeometryScaledDotProductAttention",
                                           TRIGNOMETRIC_EMBEDDING=True)}
    rng = np.random.default_rng(4)
    features = rng.normal(size=(2, 6, D)).astype(np.float32)
    boxes = _boxes(rng, 2, 6)
    bias = _key_bias(rng, 2, 6)
    flax_encoder = jencoders.GeometricEncoder(JaxConfigNode(config))
    jargs = (jnp.asarray(features), jnp.asarray(boxes), jnp.asarray(bias))
    params = _noisy(flax_encoder.init(jax.random.PRNGKey(5), *jargs)["params"], 6)
    want = flax_encoder.apply({"params": params}, *jargs)
    port = builders.build_encoder(ConfigNode(config)).eval()
    state = {}
    convert._encoder(state, "e", params)
    port.load_state_dict({key[2:]: _t(value) for key, value in state.items()})
    with torch.no_grad():
        got = port(_t(features), _t(boxes), _t(bias))
    _close(got, want, atol=1e-4)  # the trigonometric box embedding, see above


def test_spatial_circle_position_and_text_semantic_separate_match_flax():
    rng = np.random.default_rng(7)
    boxes = _boxes(rng, 2, 5)
    np.testing.assert_array_equal(scp_tss.quantise_to_patch_grid(_t(boxes)).numpy(),
                                  np.asarray(jscp.quantise_to_patch_grid(jnp.asarray(boxes))))
    config = {"ARCHITECTURE": "SpatialCirclePosition", "HEAD": HEADS, "D_MODEL": D,
              "D_KEY": D // HEADS, "D_VALUE": D // HEADS, "NUM_DISTANCE": 8, "DROPOUT": 0.1,
              "USE_AOA": False, "CAN_BE_STATEFUL": False}
    feats = rng.normal(size=(2, 5, D)).astype(np.float32)
    bias = _key_bias(rng, 2, 5)
    flax_scp = jscp.SpatialCirclePosition(JaxConfigNode(config))
    jargs = (jnp.asarray(feats), jnp.asarray(boxes), jnp.asarray(bias))
    params = _noisy(flax_scp.init(jax.random.PRNGKey(8), *jargs)["params"], 9)
    want, want_weights = flax_scp.apply({"params": params}, *jargs)
    port = builders.build_attention(ConfigNode(config)).eval()
    state = {}
    convert._attention_core(state, "s", params)
    port.load_state_dict({key[2:]: _t(value) for key, value in state.items()})
    with torch.no_grad():
        got, got_weights = port(_t(feats), _t(boxes), _t(bias))
    _close(got, want)
    _close(got_weights, want_weights)

    streams = [rng.normal(size=(2, 4, D)).astype(np.float32) for _ in range(4)]
    flax_tss = jscp.TextSemanticSeparate(JaxConfigNode({"D_MODEL": D}))
    tss_params = flax_tss.init(jax.random.PRNGKey(10), *map(jnp.asarray, streams))["params"]
    tss = scp_tss.TextSemanticSeparate(ConfigNode({"D_MODEL": D}))
    tss.load_state_dict({"context_embedding": _t(tss_params["context_embedding"])})
    _close(tss(*map(_t, streams)), flax_tss.apply({"params": tss_params}, *map(jnp.asarray,
                                                                                streams)))


def test_memory_slots_and_context_embedding_draw_from_the_generator():
    """init_xavier_law_ draws the memory core's slots and TextSemanticSeparate's
    context embedding from its generator: the same seed gives the same values
    whatever the global RNG, and the slots keep the JAX package's spread
    (std 1 / d_k and 1 / m)."""
    from openvivqa_tpu_torch.models.base import init_xavier_law_

    def seeded(global_seed):
        torch.manual_seed(global_seed)
        holder = torch.nn.ModuleDict({
            "memory": builders.build_attention(ConfigNode(_attention(
                "AugmentedMemoryScaledDotProductAttention", MEMORY=64))),
            "tss": scp_tss.TextSemanticSeparate(ConfigNode({"D_MODEL": D})),
        })
        init_xavier_law_(holder, torch.Generator().manual_seed(3))
        return holder

    first, second = seeded(0), seeded(1)
    for (name, a), b in zip(first.state_dict().items(), second.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    core = first["memory"]
    d_k = D // HEADS
    assert abs(float(core.m_k.detach().std()) * d_k - 1.0) < 0.1
    assert abs(float(core.m_v.detach().std()) * 64 - 1.0) < 0.1
    assert float(first["tss"].context_embedding.detach().abs().max()) <= (6.0 / (1 + D)) ** 0.5


# -- the frozen language model -----------------------------------------------------------
class _Vocab:
    padding_idx, bos_idx, eos_idx, unk_idx = 0, 1, 2, 3
    max_question_length = 9
    max_answer_length = 7
    word_embeddings = None

    def __len__(self):
        return 40


LANGUAGE_MODEL = {"ARCHITECTURE": "BERTModel", "D_MODEL": D, "D_PRETRAINED_FEATURE": 48,
                  "PRETRAINED_LAYERS": 2, "DROPOUT": 0.1}


def test_frozen_language_model_matches_flax():
    """BERTModel's (log-probs, signals) with padded tails; its differentiable
    route (a generator: the layer's training route at rate 0) equals its eval
    route, and the backbone is frozen."""
    tokens = np.random.default_rng(11).integers(4, 40, size=(3, 6)).astype(np.int32)
    tokens[0, -2:] = 0
    flax_lm = JaxBERTModel(config=JaxConfigNode(LANGUAGE_MODEL), vocab=_Vocab())
    params = _noisy(flax_lm.init(jax.random.PRNGKey(12), jnp.asarray(tokens))["params"], 13)
    want_logprobs, want_signals = jax.jit(lambda p, x: flax_lm.apply({"params": p}, x))(
        params, jnp.asarray(tokens))
    port = builders.build_pretrained_language_model(ConfigNode(LANGUAGE_MODEL), _Vocab()).eval()
    state = {}
    convert._frozen_language_model(state, "l", params)
    port.load_state_dict({key[2:]: _t(value) for key, value in state.items()})
    with torch.no_grad():
        got_logprobs, got_signals = port(_t(tokens))
    _close(got_logprobs, want_logprobs)
    _close(got_signals, want_signals)
    _, train_signals = port(_t(tokens), torch.Generator().manual_seed(0))
    _close(train_signals, want_signals)
    assert train_signals.requires_grad
    assert not any(p.requires_grad for p in port.backbone.parameters())


# -- the AdaptiveDecoder under IterativeMCAN ---------------------------------------------------
def _model_config(dropout=0.1):
    text = {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": D, "D_EMBEDDING": D,
            "DROPOUT": dropout, "WORD_EMBEDDING": None, "WORD_EMBEDDING_CACHE": None}
    attn = _attention(dropout=dropout)
    return {
        "NAME": "adaptive_port_test", "ARCHITECTURE": "IterativeMCAN", "D_MODEL": D,
        "VISION_EMBEDDING": {"ARCHITECTURE": "FeatureEmbedding", "D_FEATURE": 24,
                             "D_MODEL": D, "DROPOUT": dropout},
        "TEXT_EMBEDDING": text,
        "SELF_ENCODER": {"ARCHITECTURE": "Encoder", "D_MODEL": D, "LAYERS": 1,
                         "SELF_ATTENTION": attn},
        "GUIDED_ENCODER": {"ARCHITECTURE": "GuidedAttentionEncoder", "D_MODEL": D, "LAYERS": 1,
                           "SELF_ATTENTION": attn, "GUIDED_ATTENTION": attn},
        "MULTIMODAL_FUSION": {"D_MODEL": D, "D_FF": 2 * D, "DROPOUT": dropout},
        "DECODER": {
            "ARCHITECTURE": "AdaptiveDecoder", "D_MODEL": D, "LAYERS": 2,
            "ATTENTION": {"SELF_ATTENTION": _attention(stateful=True, dropout=dropout),
                          "ENC_ATTENTION": attn},
            "ADAPTIVE_ATTENTION": {
                "SELF_ATTENTION": _attention("AdaptiveScaledDotProductAttention", stateful=True,
                                             dropout=dropout),
                "ENC_ATTENTION": attn},
            "TEXT_EMBEDDING": text,
            "LANGUAGE_MODEL": dict(LANGUAGE_MODEL, DROPOUT=dropout),
        },
    }


def _numpy_batch(seed, bs, vocab):
    rng = np.random.default_rng(seed)
    regions = rng.normal(size=(bs, 5, 24)).astype(np.float32)
    regions[0, -2:] = 0.0
    questions = rng.integers(4, len(vocab), size=(bs, vocab.max_question_length)).astype(np.int32)
    questions[1, -3:] = vocab.padding_idx
    answers = rng.integers(4, len(vocab), size=(bs, vocab.max_answer_length)).astype(np.int32)
    answers[:, 0] = vocab.bos_idx
    answers[0, -2:] = vocab.padding_idx
    shifted = np.concatenate([answers[:, 1:], np.zeros((bs, 1), np.int32)], axis=1)
    return {"region_features": regions, "question_tokens": questions, "answer_tokens": answers,
            "shifted_right_answer_tokens": shifted, "sample_valid": np.ones((bs,), bool)}


def _pair(dropout=0.1):
    vocab = _Vocab()
    flax_model = JaxIterativeMCAN(JaxConfigNode(_model_config(dropout)), vocab)
    batch = {k: jnp.asarray(v) for k, v in _numpy_batch(0, 3, vocab).items()}
    variables = jax.jit(lambda r, b: flax_model.init(r, b, train=False))(
        jax.random.PRNGKey(0), batch)
    params = variables["params"]
    port = IterativeMCAN(ConfigNode(_model_config(dropout)), vocab).eval()
    state = params_from_flax(jax.tree.map(np.asarray, params))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return flax_model, params, port


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_adaptive_decoder_teacher_forced_matches_jax(pair):
    flax_model, params, port = pair
    batch = _numpy_batch(1, 3, flax_model.vocab)
    want = jax.jit(lambda p, b: flax_model.apply({"params": p}, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = port({k: _t(v) for k, v in batch.items()})
    _close(got, want)
    assert len(port.decoder.layers) == 3
    assert not any(p.requires_grad for p in port.decoder.language_model.backbone.parameters())


@pytest.mark.parametrize("parts", ["layer", "none"])
def test_adaptive_decoder_step_matches_jax(pair, monkeypatch, parts):
    """Seven single-token steps, some tokens padding: the ordinary layers on
    the layer step (or the module route), the adaptive layer core by core,
    against the JAX step on its XLA path; the language model sees the current
    token only on both sides."""
    flax_model, params, port = pair
    vocab = flax_model.vocab
    rng = np.random.default_rng(2)
    rows = 4
    enc = rng.normal(size=(rows, 9, D)).astype(np.float32)
    enc_bias = _key_bias(rng, rows, 9)
    tokens = rng.integers(4, len(vocab), size=(vocab.max_answer_length, rows, 1)).astype(np.int32)
    tokens[0] = vocab.bos_idx
    tokens[3, :2] = vocab.padding_idx
    flax_decoder = jax_builders.build_decoder(flax_model.config.DECODER, vocab)
    monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL", "0")
    monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL_PARTS", parts)
    prep = port.prepare_decode(_t(enc), _t(enc_bias))
    routes = [b["route"] for b in prep["layers"]]
    assert routes == (["layer", "layer", "staged"] if parts == "layer" else ["staged"] * 3)
    adaptive = prep["layers"][-1]
    assert adaptive["self_w"] is None
    assert (adaptive["cross_w"] is not None) == (adaptive["ffn_w"] is not None) == (
        parts == "layer")
    cache = port.init_decode_cache(rows, "cpu")
    step = jax.jit(lambda v, tok: flax_decoder.apply(
        v, tok, jnp.asarray(enc), jnp.asarray(enc_bias), method=flax_decoder.step,
        mutable=["cache"]))
    variables = {"params": params["decoder"]}
    for token in tokens:
        want, mutated = step(variables, jnp.asarray(token))
        variables = {"params": params["decoder"], "cache": mutated["cache"]}
        _close(port.decode_step(_t(token).long(), cache, prep), want, atol=2e-5)


def test_adaptive_generate_matches_jax_and_routes_agree(pair, monkeypatch):
    """Beam-3 generate of a numpy batch: the JAX package's on its XLA path, the
    port's on the layer route and on the module route: the same tokens."""
    flax_model, params, port = pair
    batch = _numpy_batch(3, 3, flax_model.vocab)
    monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL", "0")
    want_tokens, want_logprobs = jdecode.generate(
        flax_model, {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
        batch_size=3, beam_size=3)
    for parts in ("layer", "none"):
        monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL_PARTS", parts)
        got_tokens, got_logprobs = decode.generate(port, {k: _t(v) for k, v in batch.items()},
                                                   3)
        np.testing.assert_array_equal(got_tokens.numpy(), np.asarray(want_tokens))
        _close(got_logprobs, want_logprobs, atol=1e-4)


def test_adaptive_decoder_gradient_matches_jax():
    """At dropout 0, the gradient of one teacher-forced loss through the whole
    model (the language model's projection and layer through the adaptive
    column included, none on its frozen backbone) against ``jax.grad``."""
    flax_model, params, port = _pair(dropout=0.0)
    batch = _numpy_batch(4, 3, flax_model.vocab)
    targets = batch["shifted_right_answer_tokens"]
    onehot = np.eye(len(flax_model.vocab), dtype=np.float32)[targets]

    def jax_loss(p):
        out = flax_model.apply({"params": p}, {k: jnp.asarray(v) for k, v in batch.items()},
                               train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return -(out * onehot).sum() / targets.size

    want = params_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(jax_loss))(params)))
    port.train()
    out = port({k: _t(v) for k, v in batch.items()}, torch.Generator().manual_seed(0))
    (-(out * _t(onehot)).sum() / targets.size).backward()
    checked = 0
    for name, p in port.named_parameters():
        if ".language_model.backbone." in name:
            assert p.grad is None and not p.requires_grad
            continue
        # the head's log-probs are not read: no gradient, zeros in JAX
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        _close(grad, want[name], atol=1e-5, rtol=1e-3)
        checked += 1
    grads = dict(port.named_parameters())
    for name in ("decoder.language_model.proj.weight",
                 "decoder.language_model.layer.attention.self.query.weight",
                 "decoder.layers.2.self_attn.attention.fc_s.weight"):
        assert float(grads[name].grad.abs().max()) > 0.0, name
    assert checked > 50
