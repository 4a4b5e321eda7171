"""The rest of the port's M4C family against the JAX package on the CPU: the
standalone M4C, IterativeM4C, MMF_ImprovedDecodingM4C, experimental_MMF_M4C,
MMF_LoRRA and MMF_IterativeLoRRA, and their new modules.

Modules (the dynamic-vocab and OCR word embeddings, MultiModalEncoder with its
single-token decode step, DynamicPointerNetwork, LoRRA's registry attention) are
held to their flax counterparts within 1e-5, with nonzero padding rows in the
inputs.  Each architecture is initialised in flax at hidden 32 with 4 heads and
1 to 2 layers, bridged into the port with params_from_flax, and both run on one
numpy batch in float32: teacher-forced scores or log-probs within 1e-4, greedy
ids equal in both decode modes (and MMF_ImprovedDecodingM4C's prefix after each
step), IterativeM4C's beam search equal to the JAX ``generate`` in sequences
with cumulative log-probs within 1e-4, MMF_LoRRA's scores and BCE loss.  The
bridges round-trip every flax tensor; one training step gives finite gradients
that are non-zero except where none exists analytically.  On the CPU the port
runs each kernel's plain version and the JAX package its XLA paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvivqa_tpu.builders import META_ARCHITECTURE as JAX_ARCHITECTURE
from openvivqa_tpu.builders import populate as populate_jax
from openvivqa_tpu.config import ConfigNode as JaxConfigNode
from openvivqa_tpu.models import iterative_m4c as jiterative
from openvivqa_tpu.models import mmf_lorra as jlorra
from openvivqa_tpu.models.modules import encoders as jencoders
from openvivqa_tpu.models.modules import text_embeddings as jtext
from openvivqa_tpu.models.modules import torch_conversion
from openvivqa_tpu.training import decode as jdecode
from openvivqa_tpu.training.train_state import bce_with_logits_loss as jax_bce
from openvivqa_tpu_torch.builders import META_ARCHITECTURE, build_model, populate
from openvivqa_tpu_torch.config import ConfigNode
from openvivqa_tpu_torch.models import convert, iterative_m4c, mmf_lorra
from openvivqa_tpu_torch.models.modules import encoders, text_embeddings
from openvivqa_tpu_torch.models.modules.masks import MASK_VALUE
from openvivqa_tpu_torch.training import decode
from openvivqa_tpu_torch.training.train_state import bce_with_logits_loss

populate_jax()
populate()

H, HEADS, VOCAB, MAXA = 32, 4, 25, 6
N_OBJ, N_OCR, N_GRID, QLEN = 4, 3, 3, 5
MODULE_TOL, MODEL_TOL = 1e-5, 1e-4


class Vocab:
    padding_idx, bos_idx, eos_idx, unk_idx = 0, 1, 2, 3
    img_idx, feat_idx, box_idx, ocr_idx, ocr_det_idx, ocr_rec_idx = 4, 5, 6, 7, 8, 9
    question_idx, answer_idx = 10, 11
    max_answer_length = MAXA
    total_answers = 7
    word_embeddings = None

    def __len__(self):
        return VOCAB


def _attention(heads=HEADS, d=H):
    return {"ARCHITECTURE": "ScaledDotProductAttention", "HEAD": heads, "D_MODEL": d,
            "D_KEY": d // heads, "D_VALUE": d // heads, "D_FF": 2 * d, "USE_AOA": False,
            "CAN_BE_STATEFUL": False, "DROPOUT": 0.1}


def _usual(d=H):
    return {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": d, "D_EMBEDDING": 16, "DROPOUT": 0.1,
            "WORD_EMBEDDING": None}


def _features(width):
    return {"ARCHITECTURE": "FeatureEmbedding", "D_FEATURE": width, "D_MODEL": H, "DROPOUT": 0.1}


_MMT = {"HIDDEN_SIZE": H, "NUM_HIDDEN_LAYERS": 2, "NUM_ATTENTION_HEADS": HEADS}
_MMF = {
    "D_MODEL": H, "MMT": _MMT, "TEXT_BERT": {"HIDDEN_SIZE": H, "NUM_HIDDEN_LAYERS": 1},
    "OBJECT_EMBEDDING": {"D_FEATURE": 12, "DROPOUT": 0.1},
    "OCR_EMBEDDING": {"D_FEATURE": 314, "DROPOUT": 0.1},
    "OCR_PTR_NET": {"HIDDEN_SIZE": H, "QUERY_KEY_SIZE": 16},
}
_BRANCH = {"HEAD": 1, "D_KEY": 8, "D_VALUE": 8, "D_MODEL": H}
_LORRA = {
    "D_MODEL": H, "MAX_SCENE_TEXT": N_OCR, "TEXT_EMBEDDING": _usual(),
    "OBJECT_EMBEDDING": {"D_FEATURE": 12, "DROPOUT": 0.1},
    "OCR_EMBEDDING": {"D_FEATURE": 300, "DROPOUT": 0.1},
    "SELF_ATTENTION": _BRANCH, "SPATIAL_ATTENTION": _BRANCH, "CONTEXT_ATTENTION": _BRANCH,
}
ARCHS = {
    "M4C": {
        "D_MODEL": H, "MMT": _MMT,
        "TEXT_BERT": {"HIDDEN_SIZE": H, "NUM_HIDDEN_LAYERS": 1, "INTERMEDIATE_SIZE": 48},
        "ENCODER": {"LAYERS": 2, "INTERMEDIATE_SIZE": 48, "SELF_ATTENTION": _attention()},
        "DYNAMIC_EMBEDDING": {"ARCHITECTURE": "FixedVocabDynamicEmbedding", "D_MODEL": H},
        "OBJECT_EMBEDDING": {"D_FEATURE": 12, "DROPOUT": 0.1},
        "OCR_EMBEDDING": {"D_FEATURE": 314, "DROPOUT": 0.1},
    },
    "IterativeM4C": {
        "D_MODEL": H, "REGION_EMBEDDING": _features(12), "GRID_EMBEDDING": _features(12),
        "BOX_EMBEDDING": _features(4), "OCR_DET_EMBEDDING": _features(6),
        "OCR_REC_EMBEDDING": _features(8), "TEXT_EMBEDDING": _usual(),
        "OCR_TEXT_EMBEDDING": {"ARCHITECTURE": "OcrWordEmbedding", "D_MODEL": H,
                               "D_EMBEDDING": 300, "DROPOUT": 0.1},
        "DYNAMIC_EMBEDDING": {"ARCHITECTURE": "DynamicEmbedding", "D_MODEL": H},
        "ENCODER": {"ARCHITECTURE": "MultiModalEncoder", "D_MODEL": H, "LAYERS": 2,
                    "SELF_ATTENTION": _attention()},
    },
    "MMF_ImprovedDecodingM4C": _MMF,
    "experimental_MMF_M4C": _MMF,
    "MMF_LoRRA": _LORRA,
    "MMF_IterativeLoRRA": {**_LORRA, "MMT": _MMT, "OCR_PTR_NET": _MMF["OCR_PTR_NET"]},
}
GREEDY = ("M4C", "MMF_ImprovedDecodingM4C", "experimental_MMF_M4C", "MMF_IterativeLoRRA")
# the JAX converters from the reference's torch layout, the bridge's inverses
CONVERTERS = {
    "M4C": torch_conversion.convert_standalone_m4c,
    "MMF_ImprovedDecodingM4C": torch_conversion.convert_mmf_m4c,
    "MMF_LoRRA": torch_conversion.convert_mmf_lorra,
}


def _config(arch, **extra):
    return {**ARCHS[arch], "ARCHITECTURE": arch, **extra}


def _numpy_batch(bs=3, seed=13):
    rng = np.random.default_rng(seed)

    def feats(*shape):
        return rng.normal(size=shape).astype(np.float32)

    q = rng.integers(12, VOCAB, (bs, QLEN)).astype(np.int32)
    q[:, -1] = 0
    q[2, -2] = 0
    answers = rng.integers(12, VOCAB + N_OCR, (bs, MAXA)).astype(np.int32)
    answers[:, 0] = Vocab.bos_idx
    answers[0, -2:] = Vocab.padding_idx  # a padded answer tail
    batch = {
        "question_tokens": q,
        "region_features": feats(bs, N_OBJ, 12), "region_boxes": feats(bs, N_OBJ, 4),
        "grid_features": feats(bs, N_GRID, 12), "grid_boxes": feats(bs, N_GRID, 4),
        "ocr_fasttext_features": feats(bs, N_OCR, 300), "ocr_rec_features": feats(bs, N_OCR, 8),
        "ocr_det_features": feats(bs, N_OCR, 6), "ocr_boxes": feats(bs, N_OCR, 4),
        "answer_tokens": answers,
        "answer": np.array([[1], [8], [VOCAB - 1]], np.int32)[:bs] % (Vocab.total_answers + N_OCR),
    }
    batch["shifted_right_answer_tokens"] = np.concatenate(
        [answers[:, 1:], np.zeros((bs, 1), np.int32)], axis=1)
    # padded rows exercise the object, grid and OCR padding biases
    batch["region_features"][0, -1] = 0.0
    batch["grid_features"][2, -2:] = 0.0
    for key in ("ocr_fasttext_features", "ocr_rec_features", "ocr_det_features"):
        batch[key][1, -1] = 0.0
    return batch


BATCH = _numpy_batch()
_CACHE = {}


def _jax_batch(batch=BATCH):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_model(arch, **extra):
    return JAX_ARCHITECTURE.get(arch)(JaxConfigNode(_config(arch, **extra)), Vocab())


def _nonzero_padding_rows(params):
    """Every table's padding row set nonzero: both sides must read it as the
    forward rules say (UsualEmbedding as zero, the dynamic tables as is)."""
    params = jax.tree.map(np.array, params)
    rng = np.random.default_rng(5)

    def visit(node):
        for key, value in node.items():
            if isinstance(value, dict):
                visit(value)
            elif key in ("embedding", "fixed_weights") and value.ndim == 2:
                value[0] = rng.normal(size=value.shape[1])

    visit(params)
    return params


def _jp(params):
    return jax.tree.map(jnp.asarray, params)


def _jax(arch):
    """The flax parameters of `arch` and the JAX package's outputs, once."""
    if arch not in _CACHE:
        init_model = _jax_model(arch)
        variables = jax.jit(
            lambda r, b: init_model.init({"params": r, "dropout": r}, b, train=False)
        )(jax.random.PRNGKey(3), _jax_batch())
        params = _nonzero_padding_rows(variables["params"])
        out = {"params": params}
        result = init_model.apply({"params": _jp(params)}, _jax_batch(), train=False)
        out["teacher_forced"] = np.asarray(result if arch == "IterativeM4C" else result["scores"])
        if arch in GREEDY:
            for mode, extra in (("quadratic", {}),
                                ("incremental", {"DECODING_MODE": "incremental"})):
                got = _jax_model(arch, **extra).apply({"params": _jp(params)}, _jax_batch(),
                                                      method="greedy_decode")
                out[mode] = {k: np.asarray(v) for k, v in got.items()}
        _CACHE[arch] = out
    return _CACHE[arch]


def _port_model(arch, params, **extra):
    model = META_ARCHITECTURE.get(arch)(ConfigNode(_config(arch, **extra)), Vocab())
    state = convert.params_from_flax(params)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.eval()


def _torch_batch(batch=BATCH):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# -- the modules ------------------------------------------------------------------------------
def test_split_embedding_lookup_matches_jax_and_stops_padding_gradients():
    """Fixed rows, OCR rows, the padding id (its row read as is) and an id past
    the OCR block (a zero row); the padding row's gradient is stopped."""
    rng = np.random.default_rng(1)
    fixed = rng.normal(size=(7, 5)).astype(np.float32)
    oov = rng.normal(size=(2, 3, 5)).astype(np.float32)
    tokens = np.array([[0, 4, 7, 9, 10], [1, 0, 8, 6, 2]], np.int32)
    want = jtext.split_embedding_lookup(jnp.asarray(fixed), jnp.asarray(oov),
                                        jnp.asarray(tokens), 0)
    fixed_t = _t(fixed).requires_grad_(True)
    got = text_embeddings.split_embedding_lookup(fixed_t, _t(oov), _t(tokens), 0)
    _close(got.detach(), want, MODULE_TOL)
    assert bool(got[0, 0].abs().sum() > 0)  # the padding row reads as it is
    got.sum().backward()
    want_grad = jax.grad(lambda f: jtext.split_embedding_lookup(
        f, jnp.asarray(oov), jnp.asarray(tokens), 0).sum())(jnp.asarray(fixed))
    _close(fixed_t.grad, want_grad, MODULE_TOL)
    assert not bool(fixed_t.grad[0].any())


@pytest.mark.parametrize("kind", ["DynamicEmbedding", "FixedVocabDynamicEmbedding"])
def test_dynamic_embeddings_match_flax(kind):
    rng = np.random.default_rng(2)
    config = {"ARCHITECTURE": kind, "D_MODEL": H}
    oov = rng.normal(size=(2, N_OCR, H)).astype(np.float32)
    tokens = np.array([[0, 4, VOCAB, VOCAB + 2], [1, VOCAB + 1, 0, 24]], np.int32)
    fixed = rng.normal(size=(VOCAB, H)).astype(np.float32)
    flax_module = getattr(jtext, kind)(JaxConfigNode(config), Vocab())
    port = getattr(text_embeddings, kind)(ConfigNode(config), Vocab())
    args = (jnp.asarray(tokens), jnp.asarray(oov))
    if kind == "DynamicEmbedding":
        params = _nonzero_padding_rows(flax_module.init(jax.random.PRNGKey(0), *args)["params"])
        want, (want_pad, want_causal) = flax_module.apply({"params": _jp(params)}, *args)
        port.load_state_dict({"fixed_weights": _t(params["fixed_weights"])})
        got, (pad, causal) = port(_t(tokens), _t(oov))
    else:
        fixed[0] = rng.normal(size=H)
        want, (want_pad, want_causal) = flax_module.apply({}, *args, jnp.asarray(fixed))
        got, (pad, causal) = port(_t(tokens), _t(oov), _t(fixed))
    _close(got.detach(), want, MODULE_TOL)
    _close(pad, want_pad, 0.0)
    _close(causal, want_causal, 0.0)


def test_ocr_word_embedding_matches_flax():
    rng = np.random.default_rng(3)
    config = {"ARCHITECTURE": "OcrWordEmbedding", "D_MODEL": H, "D_EMBEDDING": 300,
              "DROPOUT": 0.1}
    x = rng.normal(size=(2, N_OCR, 300)).astype(np.float32)
    flax_module = jtext.OcrWordEmbedding(JaxConfigNode(config), Vocab())
    params = flax_module.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want, _ = flax_module.apply({"params": params}, jnp.asarray(x))
    port = text_embeddings.OcrWordEmbedding(ConfigNode(config), Vocab())
    state = {}
    convert._linear(state, "proj", params["Dense_0"])
    port.load_state_dict({k: _t(v) for k, v in state.items()})
    got, masks = port(_t(x))
    assert masks is None
    _close(got.detach(), want, MODULE_TOL)


def test_multimodal_encoder_and_its_decode_step_match_flax():
    """MultiModalEncoder over a full (bs, 1, L, L) prefix-LM bias with its
    layer inputs, then Encoder.decode_step at a 1-based absolute position over
    [the frozen layer inputs | the slot cache] against flax's."""
    rng = np.random.default_rng(4)
    config = {"ARCHITECTURE": "MultiModalEncoder", "D_MODEL": H, "LAYERS": 2,
              "SELF_ATTENTION": _attention()}
    bs, ctx, slots = 2, 7, 4
    x = rng.normal(size=(bs, ctx, H)).astype(np.float32)
    bias = np.zeros((bs, 1, ctx, ctx), np.float32)
    bias[1, :, :, -2:] = MASK_VALUE
    bias[0, :, 2, :] = MASK_VALUE  # a fully masked query row
    flax_module = jencoders.MultiModalEncoder(JaxConfigNode(config))
    params = flax_module.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(bias))["params"]
    want, want_inputs = flax_module.apply({"params": params}, jnp.asarray(x), jnp.asarray(bias),
                                          return_layer_inputs=True)
    port = encoders.MultiModalEncoder(ConfigNode(config))
    state = {}
    convert._encoder(state, "e", jax.tree.map(np.asarray, params))
    port.load_state_dict({k[2:]: _t(v) for k, v in state.items()})
    with torch.no_grad():
        got, got_inputs = port(_t(x), _t(bias), return_layer_inputs=True)
    _close(got, want, MODULE_TOL)
    for g, w in zip(got_inputs, want_inputs):
        _close(g, w, MODULE_TOL)

    token = rng.normal(size=(bs, 1, H)).astype(np.float32)
    caches = [rng.normal(size=(bs, slots, H)).astype(np.float32) for _ in range(2)]
    step = 2
    position = np.full((bs, 1), ctx + 1 + step, np.float32)
    step_bias = np.zeros((bs, 1, 1, ctx + slots), np.float32)
    step_bias[..., ctx + step + 1:] = MASK_VALUE
    step_bias[1, ..., :2] = MASK_VALUE
    want_out, want_caches = flax_module.apply(
        {"params": params}, jnp.asarray(token), jnp.asarray(position),
        [jnp.asarray(w) for w in want_inputs], [jnp.asarray(c) for c in caches], step,
        jnp.asarray(step_bias), method="decode_step")
    port_caches = [_t(c) for c in caches]
    with torch.no_grad():
        got_out = port.decode_step(_t(token), _t(position), got_inputs, port_caches, step,
                                   _t(step_bias))
    _close(got_out, want_out, MODULE_TOL)
    for g, w in zip(port_caches, want_caches):  # written in place at the step's slot
        _close(g, w, MODULE_TOL)


def test_dynamic_pointer_network_matches_flax():
    rng = np.random.default_rng(6)
    ocr = rng.normal(size=(2, N_OCR, H)).astype(np.float32)
    ans = rng.normal(size=(2, 4, H)).astype(np.float32)
    bias = np.zeros((2, 1, 1, N_OCR), np.float32)
    bias[1, ..., -1] = MASK_VALUE
    flax_module = jiterative.DynamicPointerNetwork(H)
    args = tuple(jnp.asarray(a) for a in (ocr, ans, bias))
    params = flax_module.init(jax.random.PRNGKey(2), *args)["params"]
    want = flax_module.apply({"params": params}, *args)
    port = iterative_m4c.DynamicPointerNetwork(H)
    state = {}
    convert._linear(state, "query", params["Dense_0"])
    convert._linear(state, "key", params["Dense_1"])
    port.load_state_dict({k: _t(v) for k, v in state.items()})
    with torch.no_grad():
        got = port(_t(ocr), _t(ans), _t(bias))
    assert got.shape == (2, 4, N_OCR)
    _close(got, want, MODULE_TOL)


def test_registry_attention_matches_flax_with_its_weights():
    rng = np.random.default_rng(7)
    node = {"HEAD": 1, "D_KEY": 8, "D_VALUE": 8, "D_MODEL": H}
    q = rng.normal(size=(2, 4, H)).astype(np.float32)
    kv = rng.normal(size=(2, QLEN, H)).astype(np.float32)
    bias = np.zeros((2, 1, 1, QLEN), np.float32)
    bias[0, ..., -2:] = MASK_VALUE
    flax_module = jlorra._RegistryAttention(JaxConfigNode(node))
    args = tuple(jnp.asarray(a) for a in (q, kv, kv, bias))
    params = flax_module.init(jax.random.PRNGKey(3), *args)["params"]
    want, want_w = flax_module.apply({"params": params}, *args)
    port = mmf_lorra._RegistryAttention(ConfigNode(node), H, H)
    state = {}
    for name in ("fc_q", "fc_k", "fc_v", "fc_o"):
        convert._linear(state, name, params[name])
    port.load_state_dict({k: _t(v) for k, v in state.items()})
    with torch.no_grad():
        got, got_w = port(_t(q), _t(kv), _t(kv), _t(bias))
    _close(got, want, MODULE_TOL)
    _close(got_w, want_w, MODULE_TOL)


# -- the six architectures ------------------------------------------------------------------
@pytest.mark.parametrize("arch", list(ARCHS))
def test_teacher_forced_outputs_match_jax(arch):
    """Scores (log-probs for IterativeM4C) on the batch's answer tokens."""
    want = _jax(arch)
    with torch.no_grad():
        got = _port_model(arch, want["params"])(_torch_batch())
    _close(got if arch == "IterativeM4C" else got["scores"], want["teacher_forced"], MODEL_TOL)


@pytest.mark.parametrize("arch", [arch for arch in ARCHS if arch != "IterativeM4C"])
def test_stream_widths_come_from_the_data_as_flax_infers_them(arch):
    """A config that misstates the object and OCR input widths (1024 each, as
    experimental_mmf_m4c.yaml does its OCR width): flax's Dense infers them
    from the batch, build_model takes them from one sample of the data, so the
    flax tree loads and the scores match."""
    want = _jax(arch)
    wrong = {node: {**ARCHS[arch][node], "D_FEATURE": 1024}
             for node in ("OBJECT_EMBEDDING", "OCR_EMBEDDING")}
    model = build_model(ConfigNode(_config(arch, **wrong)), Vocab(),
                        {key: value[0] for key, value in BATCH.items()})
    state = convert.params_from_flax(want["params"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    assert model.linear_ocr_feat_to_mmt_in.in_features == ARCHS[arch]["OCR_EMBEDDING"]["D_FEATURE"]
    with torch.no_grad():
        got = model.eval()(_torch_batch())
    _close(got["scores"], want["teacher_forced"], MODEL_TOL)


@pytest.mark.parametrize("mode", ["quadratic", "incremental"])
@pytest.mark.parametrize("arch", GREEDY)
def test_greedy_decode_matches_jax(arch, mode):
    want = _jax(arch)
    extra = {"DECODING_MODE": "incremental"} if mode == "incremental" else {}
    got = _port_model(arch, want["params"], **extra).greedy_decode(_torch_batch())
    np.testing.assert_array_equal(got["prev_inds"].numpy(), want[mode]["prev_inds"])
    np.testing.assert_array_equal(got["scores"].argmax(-1).numpy(),
                                  want[mode]["scores"].argmax(-1))
    _close(got["scores"], want[mode]["scores"], MODEL_TOL)


@pytest.mark.parametrize("arch", GREEDY)
def test_incremental_equals_context_blind_quadratic(arch):
    params = _jax(arch)["params"]
    quadratic = _port_model(arch, params, CONTEXT_BLIND=True).greedy_decode(_torch_batch())
    incremental = _port_model(arch, params, DECODING_MODE="incremental").greedy_decode(
        _torch_batch())
    np.testing.assert_array_equal(incremental["prev_inds"].numpy(), quadratic["prev_inds"].numpy())
    _close(incremental["scores"], quadratic["scores"], 2e-5)


def test_improved_decoding_prefix_matches_jax_after_each_step():
    """MMF_ImprovedDecodingM4C's _update_prev_inds against the JAX hook at
    every step of the quadratic greedy, on the port's own scores: positions
    past step + 1 reset to 0; MMF_M4C's hook leaves them."""
    arch = "MMF_ImprovedDecodingM4C"
    params = _jax(arch)["params"]
    model = _port_model(arch, params)
    flax_model = _jax_model(arch)
    batch = _torch_batch()
    weights = model.kernel_weights()
    with torch.no_grad():
        streams = model._greedy_invariants(batch, weights)
        prev = torch.zeros((3, MAXA), dtype=torch.long)
        prev[:, 0] = Vocab.bos_idx
        for step in range(MAXA):
            scores = model._scores_from_streams(streams, prev, weights)
            want = flax_model._update_prev_inds(jnp.asarray(prev.numpy()),
                                                jnp.asarray(scores.numpy()), step)
            prev = model._update_prev_inds(prev, scores, step)
            np.testing.assert_array_equal(prev.numpy(), np.asarray(want))
            assert not bool(prev[:, step + 2:].any())
    np.testing.assert_array_equal(prev.numpy(), _jax(arch)["quadratic"]["prev_inds"])


@pytest.mark.parametrize("mode", ["quadratic", "incremental"])
def test_iterative_m4c_beam_search_matches_jax(mode):
    """Beam-3 generate: the same sequences as the JAX package's, cumulative
    log-probs within 1e-4 (the incremental mode context-blind on both sides)."""
    arch = "IterativeM4C"
    params = _jax(arch)["params"]
    extra = {"DECODING_MODE": "incremental"} if mode == "incremental" else {}
    flax_model = _jax_model(arch, **extra)
    want_tokens, want_logprobs = jdecode.generate(
        flax_model, {"params": _jp(params)}, _jax_batch(), batch_size=3, beam_size=3, out_size=3)
    got_tokens, got_logprobs = decode.generate(_port_model(arch, params, **extra),
                                               _torch_batch(), 3, out_size=3)
    np.testing.assert_array_equal(got_tokens.numpy(), np.asarray(want_tokens))
    _close(got_logprobs.sum(-1), np.asarray(want_logprobs).sum(-1), MODEL_TOL)


def test_iterative_m4c_incremental_equals_context_blind_quadratic():
    params = _jax("IterativeM4C")["params"]
    quadratic = decode.generate(_port_model("IterativeM4C", params, CONTEXT_BLIND=True),
                                _torch_batch(), 3, out_size=3)
    incremental = decode.generate(
        _port_model("IterativeM4C", params, DECODING_MODE="incremental"), _torch_batch(), 3,
        out_size=3)
    np.testing.assert_array_equal(incremental[0].numpy(), quadratic[0].numpy())
    _close(incremental[1], quadratic[1], 2e-5)


@pytest.mark.parametrize("mode", ["quadratic", "incremental"])
def test_iterative_m4c_decode_teacher_forced_matches_jax(mode):
    """decode_teacher_forced from an encode() state against the JAX
    package's.  In the quadratic mode it is forward's log-probs; in the
    incremental mode both packages take the first cached layer input, the
    encoder's LayerNorm-ed and position-added prefix, as the raw prefix, so
    there it is not (the SCST re-scoring path; SCST is not ported)."""
    extra = {"DECODING_MODE": "incremental"} if mode == "incremental" else {}
    params = _jax("IterativeM4C")["params"]
    flax_model = _jax_model("IterativeM4C", **extra)
    variables = {"params": _jp(params)}
    state, bias = flax_model.apply(variables, _jax_batch(), method="encode")
    want = flax_model.apply(variables, jnp.asarray(BATCH["answer_tokens"]), state, bias,
                            method="decode_teacher_forced")
    model = _port_model("IterativeM4C", params, **extra)
    batch = _torch_batch()
    with torch.no_grad():
        port_state, port_bias = model.encode(batch)
        assert ("ctx_inputs" in port_state) == (mode == "incremental")
        got = model.decode_teacher_forced(batch["answer_tokens"], port_state, port_bias)
        forward = model(batch)
    _close(got, want, MODEL_TOL)
    if mode == "quadratic":
        _close(got, forward, 1e-5)


def test_beam_cache_keeps_one_step_counter():
    """The decode cache's step counter is one int for all rows, so beam
    search's reorder passes it by; the token buffer and the answer bank are
    reordered with the beams."""
    model = _port_model("IterativeM4C", _jax("IterativeM4C")["params"],
                        DECODING_MODE="incremental")
    cache = model.init_decode_cache(6, torch.device("cpu"))
    cache["step"] = 2
    cache["tokens"][:, 0] = torch.arange(6)
    cache["bank"][:, :, 0, 0] = torch.arange(6, dtype=torch.float32)[:, None]
    gathered = decode._gather_beams(cache, torch.tensor([[1, 0, 0], [2, 2, 1]]), 2, 3)
    assert gathered["step"] == 2
    assert gathered["tokens"][:, 0].tolist() == [1, 0, 0, 5, 5, 4]
    assert gathered["bank"][:, 1, 0, 0].tolist() == [1.0, 0.0, 0.0, 5.0, 5.0, 4.0]


def test_mmf_lorra_scores_and_bce_loss_match_jax():
    want = _jax("MMF_LoRRA")
    model = _port_model("MMF_LoRRA", want["params"])
    with torch.no_grad():
        scores = model(_torch_batch())["scores"]
    assert scores.shape == (3, Vocab.total_answers + N_OCR)
    _close(scores, want["teacher_forced"], MODEL_TOL)
    valid = np.array([True, True, False])
    targets = BATCH["answer"].reshape(-1)
    for weights in (None, valid):
        want_loss = jax_bce(jnp.asarray(want["teacher_forced"]), jnp.asarray(targets),
                            weights=None if weights is None else jnp.asarray(weights))
        got_loss = bce_with_logits_loss(_t(want["teacher_forced"]), _t(targets),
                                        weights=None if weights is None else _t(weights))
        assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-6)


# -- the bridges --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list(CONVERTERS))
def test_bridge_round_trips_through_the_reference_converter(arch):
    """The JAX package's converter from the reference's torch layout is the
    bridge's inverse: the port's state_dict gives back every flax tensor."""
    params = _jax(arch)["params"]
    model = _port_model(arch, params)
    back = CONVERTERS[arch]({k: v.numpy() for k, v in model.state_dict().items()},
                            JaxConfigNode(_config(arch)))
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), leaf, err_msg=str(path))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_bridge_covers_every_parameter_both_ways(arch):
    """Every flax tensor lands in exactly one port tensor (as it is, or as a
    Dense kernel transposed), and the bridge fills every port parameter at its
    shape (the architectures without a JAX converter included)."""
    params = _jax(arch)["params"]
    state = convert.params_from_flax(params)
    model = META_ARCHITECTURE.get(arch)(ConfigNode(_config(arch)), Vocab())
    assert set(state) == set(model.state_dict())
    for name, tensor in model.state_dict().items():
        assert tuple(tensor.shape) == state[name].shape, name
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) == len(state)
    unused = dict(state)
    for path, leaf in leaves:
        match = next(name for name, value in unused.items()
                     if value.shape in (leaf.shape, leaf.T.shape)
                     and (np.array_equal(value, leaf) or np.array_equal(value, leaf.T)))
        del unused[match]
    assert not unused


def _gradient_free(name):
    # softmax(q . (k + b)) does not depend on the key projection's bias b
    return name.endswith(("self.key.bias", "fc_k.bias"))


def _unread(arch, name):
    # MMF_LoRRA keeps only the spatial and context branches' weights
    return arch == "MMF_LoRRA" and name.startswith(
        ("spatial_attn.fc_v", "spatial_attn.fc_o", "context_attn.fc_v", "context_attn.fc_o"))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_one_training_step_gives_finite_nonzero_gradients(arch):
    """One training step (dropout at the configs' 0.1, drawn from a
    generator): finite gradients on every parameter, non-zero except the key
    biases; MMF_LoRRA's unread branch projections get none at all."""
    model = _port_model(arch, _jax(arch)["params"]).train()
    batch = _torch_batch()
    generator = torch.Generator().manual_seed(7)
    out = model(batch, generator=generator)
    if arch == "MMF_LoRRA":
        loss = bce_with_logits_loss(out["scores"], batch["answer"].reshape(-1))
    else:
        logprobs = out if arch == "IterativeM4C" else torch.log_softmax(out["scores"], -1)
        loss = torch.nn.functional.nll_loss(
            logprobs.reshape(-1, logprobs.shape[-1]),
            batch["shifted_right_answer_tokens"].long().reshape(-1), ignore_index=0)
    loss.backward()
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        if _unread(arch, name):  # not in the graph at all
            assert p.grad is None, name
            continue
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        assert _gradient_free(name) or float(p.grad.abs().max()) > 0.0, name
