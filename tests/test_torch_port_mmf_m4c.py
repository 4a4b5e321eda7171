"""The port's MMF_M4C slice (openvivqa_tpu_torch.models) against the JAX package.

A small MMF_M4C (hidden 32, 2 heads, 2 MMT layers, 1 TextBert layer) is
initialised in flax, bridged into the port with params_from_flax, and both run
on the same numpy batch: the modules that hold kernels, then the whole slice
(teacher-forced scores, quadratic greedy, incremental greedy).  On the CPU the
port runs each kernel's plain version and the JAX package its XLA paths, both
in float32: scores agree to atol 1e-4 and greedy ids exactly (torch.argmax and
jnp.argmax both take the first maximum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvivqa_tpu.builders import populate as populate_jax
from openvivqa_tpu.config import ConfigNode
from openvivqa_tpu.models.mmf_m4c import MMF_M4C as JaxMMF
from openvivqa_tpu.models.modules import bert as jbert
from openvivqa_tpu.models.modules.torch_conversion import convert_mmf_m4c
from openvivqa_tpu_torch.builders import populate
from openvivqa_tpu_torch.models import convert
from openvivqa_tpu_torch.models.mmf_m4c import MMF_M4C
from openvivqa_tpu_torch.models.modules.bert import BertEncoderStack, BertLayer, init_jax_law_
from openvivqa_tpu_torch.models.modules.masks import MASK_VALUE

populate_jax()
populate()

H, HEADS, VOCAB, MAXA = 32, 2, 25, 6
N_OBJ, N_OCR, QLEN = 4, 3, 5
SCORE_ATOL = 1e-4


class Vocab:
    padding_idx, bos_idx, eos_idx, unk_idx = 0, 1, 2, 3
    max_answer_length = MAXA

    def __len__(self):
        return VOCAB


def _config(**extra):
    return ConfigNode({
        "ARCHITECTURE": "MMF_M4C",
        "D_MODEL": H,
        "MMT": {"HIDDEN_SIZE": H, "NUM_HIDDEN_LAYERS": 2, "NUM_ATTENTION_HEADS": HEADS},
        "TEXT_BERT": {"HIDDEN_SIZE": H, "NUM_HIDDEN_LAYERS": 1},
        "OBJECT_EMBEDDING": {"D_FEATURE": 12, "DROPOUT": 0.0},
        "OCR_EMBEDDING": {"D_FEATURE": 24, "DROPOUT": 0.0},
        "OCR_PTR_NET": {"HIDDEN_SIZE": H, "QUERY_KEY_SIZE": 16},
        **extra,
    })


MODES = {
    "reference": {},
    "context_blind": {"CONTEXT_BLIND": True},
    "incremental": {"DECODING_MODE": "incremental"},
}


def _numpy_batch(bs=3, seed=13):
    rng = np.random.default_rng(seed)

    def feats(*shape):
        return rng.normal(size=shape).astype(np.float32)

    q = rng.integers(4, VOCAB, (bs, QLEN)).astype(np.int32)
    q[:, -1] = 0
    batch = {
        "question_tokens": q,
        "region_features": feats(bs, N_OBJ, 12),
        "region_boxes": feats(bs, N_OBJ, 4),
        "ocr_fasttext_features": feats(bs, N_OCR, 10),
        "ocr_rec_features": feats(bs, N_OCR, 8),
        "ocr_det_features": feats(bs, N_OCR, 6),
        "ocr_boxes": feats(bs, N_OCR, 4),
        "answer_tokens": rng.integers(4, VOCAB + N_OCR, (bs, MAXA)).astype(np.int32),
    }
    # padded rows exercise the object and OCR padding biases
    batch["region_features"][0, -1] = 0.0
    for key in ("ocr_fasttext_features", "ocr_rec_features", "ocr_det_features"):
        batch[key][1, -1] = 0.0
    return batch


@pytest.fixture(scope="module")
def setup():
    batch = _numpy_batch()
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    torch_batch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    init_model = JaxMMF(_config(CONTEXT_BLIND=True), Vocab())
    variables = jax.jit(
        lambda r, b: init_model.init({"params": r, "dropout": r}, b, train=False)
    )(jax.random.PRNGKey(3), jax_batch)
    params = jax.tree.map(np.asarray, variables["params"])
    return {"batch": batch, "jax_batch": jax_batch, "torch_batch": torch_batch, "params": params}


def _jax_model(mode):
    return JaxMMF(_config(**MODES[mode]), Vocab())


def _port_model(mode, params):
    model = MMF_M4C(_config(**MODES[mode]), Vocab())
    state = convert.params_from_flax(params)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.eval()


def _close(got, want, atol=SCORE_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _prefixed(state, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in state.items() if k.startswith(prefix)}


# -- modules that hold kernels ----------------------------------------------------
@pytest.mark.parametrize("bias", ["none", "key-only", "prefix-lm"])
def test_bert_layer_matches_jax(bias):
    """A key-only bias takes kernel F, a full (b, 1, S, S) bias the packed
    attention; the FFN takes kernel C either way."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 9, H)).astype(np.float32)
    attention_bias = None
    if bias == "key-only":
        attention_bias = np.where(np.arange(9)[None] < np.array([[9], [4]]), 0.0, MASK_VALUE)
        attention_bias = attention_bias[:, None, None, :].astype(np.float32)
    elif bias == "prefix-lm":
        attention_bias = np.zeros((2, 1, 9, 9), np.float32)
        attention_bias[:, :, :, -3:] = np.triu(np.full((9, 3), MASK_VALUE, np.float32), 7)
        attention_bias[1, :, :, 2] = MASK_VALUE
    layer = jbert.BertLayer(hidden_size=H, num_heads=HEADS)
    variables = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))
    jb = None if attention_bias is None else jnp.asarray(attention_bias)
    want = layer.apply(variables, jnp.asarray(x), attention_bias=jb)

    state = {}
    convert._bert_layer(state, "l", jax.tree.map(np.asarray, variables["params"]))
    port = BertLayer(H, HEADS)
    port.load_state_dict(_prefixed(state, "l."))
    tb = None if attention_bias is None else torch.from_numpy(attention_bias)
    with torch.no_grad():
        got = port(torch.from_numpy(x), tb)
    _close(got, want, atol=1e-5)


def test_encoder_stack_encode_matches_jax():
    rng = np.random.default_rng(22)
    x = rng.normal(size=(3, 7, H)).astype(np.float32)
    bias = np.where(np.arange(7)[None] < np.array([[7], [3], [1]]), 0.0, MASK_VALUE)
    bias = bias[:, None, None, :].astype(np.float32)
    stack = jbert.BertEncoderStack(hidden_size=H, num_layers=2, num_heads=HEADS)
    variables = stack.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want, want_inputs = stack.apply(
        variables, jnp.asarray(x), attention_bias=jnp.asarray(bias), return_layer_inputs=True
    )
    state = {}
    convert._bert_encoder(state, "s", jax.tree.map(np.asarray, variables["params"]))
    port = BertEncoderStack(H, 2, HEADS)
    port.load_state_dict(_prefixed(state, "s."))
    with torch.no_grad():
        got, got_inputs = port(torch.from_numpy(x), torch.from_numpy(bias), return_layer_inputs=True)
    _close(got, want, atol=1e-5)
    for g, w in zip(got_inputs, want_inputs):
        _close(g, w, atol=1e-5)


def _jax_context(m, b):
    streams = m._mmt_streams(b, False)
    return m.mmt.encode_context(*streams["txt"], *streams["obj"], *streams["ocr"])


def _port_context(model, batch):
    weights = model.kernel_weights()
    streams = model._mmt_streams(batch, weights)
    return model.mmt.encode_context(
        *streams["txt"], *streams["obj"], *streams["ocr"], weights=weights["mmt"]
    ), streams, weights


def test_mmt_encode_context_matches_jax(setup):
    want = _jax_model("incremental").apply(
        {"params": setup["params"]}, setup["jax_batch"], method=_jax_context
    )
    model = _port_model("incremental", setup["params"])
    with torch.no_grad():
        got, _, _ = _port_context(model, setup["torch_batch"])
    _close(got["ctx_out"], want["ctx_out"], atol=1e-5)
    for (gk, gv), (wk, wv) in zip(got["context_kv"], want["context_kv"]):
        _close(gk, wk, atol=1e-5)
        _close(gv, wv, atol=1e-5)
    assert (got["ocr_begin"], got["ocr_end"]) == (want["ocr_begin"], want["ocr_end"])


def test_fused_decode_steps_match_jax(setup):
    """Kernel D + kernel C steps against the JAX package's joint-cache XLA
    decode step, on the same token sequence."""
    tokens = setup["batch"]["answer_tokens"]

    def jax_steps(m, b):
        streams = m._mmt_streams(b, False)
        context = _jax_context(m, b)
        caches, bias_base = m.mmt.init_decode_caches(context, MAXA)
        table = m.mmt.build_dec_table(m._fixed_ans_emb(), streams["ocr"][0])
        outs = []
        for step in range(MAXA):
            emb = m.mmt.embed_step(table, VOCAB, jnp.asarray(tokens[:, step]), step)
            out, caches = m.mmt.decode_step(emb, context, caches, bias_base, step)
            outs.append(out)
        return jnp.concatenate(outs, axis=1)

    want = _jax_model("incremental").apply(
        {"params": setup["params"]}, setup["jax_batch"], method=jax_steps
    )
    model = _port_model("incremental", setup["params"])
    with torch.no_grad():
        context, streams, weights = _port_context(model, setup["torch_batch"])
        state = model.mmt.init_fused_decode(context, MAXA, weights["mmt"])
        table = model.mmt.build_dec_table(model.classifier.weight, streams["ocr"][0])
        outs = []
        for step in range(MAXA):
            emb = model.mmt.embed_step(table, VOCAB, torch.from_numpy(tokens[:, step]), step)
            outs.append(model.mmt.fused_decode_step(emb, state, step))
        got = torch.cat(outs, dim=1)
    _close(got, want, atol=1e-5)


# -- the whole slice ------------------------------------------------------------------
@pytest.mark.parametrize("mode", list(MODES))
def test_teacher_forced_scores_match_jax(setup, mode):
    want = _jax_model(mode).apply({"params": setup["params"]}, setup["jax_batch"], train=False)
    got = _port_model(mode, setup["params"])(setup["torch_batch"])
    _close(got["scores"], want["scores"])


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_decode_matches_jax(setup, mode):
    """The quadratic greedy (reference and context-blind masks) and the
    incremental greedy: scores to 1e-4 and identical ids."""
    want = _jax_model(mode).apply(
        {"params": setup["params"]}, setup["jax_batch"], method="greedy_decode"
    )
    got = _port_model(mode, setup["params"]).greedy_decode(setup["torch_batch"])
    np.testing.assert_array_equal(got["prev_inds"].numpy(), np.asarray(want["prev_inds"]))
    np.testing.assert_array_equal(
        got["scores"].argmax(-1).numpy(), np.asarray(jnp.argmax(want["scores"], -1))
    )
    _close(got["scores"], want["scores"])


def test_incremental_equals_quadratic_under_context_blind(setup):
    """The port's twin of tests/test_incremental_m4c.py: with context-blind
    masking, the KV-cached decode gives the quadratic greedy's tokens and
    scores."""
    quadratic = _port_model("context_blind", setup["params"]).greedy_decode(setup["torch_batch"])
    incremental = _port_model("incremental", setup["params"]).greedy_decode(setup["torch_batch"])
    np.testing.assert_array_equal(incremental["prev_inds"].numpy(), quadratic["prev_inds"].numpy())
    _close(incremental["scores"], quadratic["scores"], atol=2e-5)


# -- the weight bridge -------------------------------------------------------------------
def test_weight_bridge_round_trip(setup):
    """convert_mmf_m4c (the JAX package's reader of reference checkpoints) is
    the bridge's inverse: the port's state_dict gives back the flax tree."""
    model = _port_model("reference", setup["params"])
    back = convert_mmf_m4c(model.state_dict(), _config())
    flat_want = jax.tree_util.tree_flatten_with_path(setup["params"])[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf)


def test_bridge_covers_every_port_parameter(setup):
    state = convert.params_from_flax(setup["params"])
    model = MMF_M4C(_config(), Vocab())
    assert set(state) == set(model.state_dict())
    for name, tensor in model.state_dict().items():
        assert tuple(tensor.shape) == state[name].shape, name


def test_seeded_init_follows_the_jax_law():
    model = init_jax_law_(MMF_M4C(_config(), Vocab()), torch.Generator().manual_seed(0))
    again = init_jax_law_(MMF_M4C(_config(), Vocab()), torch.Generator().manual_seed(0))
    for (name, p), (_, q) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(p, q), name
    assert torch.all(model.mmt.encoder.layer[0].output.LayerNorm.weight == 1)
    assert torch.all(model.classifier.bias == 0)
    std = float(model.text_bert.embeddings.word_embeddings.weight.detach().std())
    assert abs(std - 0.02) < 1e-3
