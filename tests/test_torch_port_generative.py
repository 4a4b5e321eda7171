"""The port's beam-searched generative slice (IterativeMCAN under OpenEndedTask)
on the CPU against the JAX package, at small sizes.

One flax IterativeMCAN (64 wide, 4 heads, 2 + 2 + 2 layers) is initialised from a
seed, its parameter tree bridged into the port with ``params_from_flax``, and
both run on the same numpy inputs in float32: modules within 1e-5 (the two
frameworks sum in different orders), whole decodes token for token with
log-probs within 1e-4.  Where the JAX side names a kernel it runs the Pallas
kernel in interpret mode (``OPENVIVQA_DECODE_KERNEL=interpret``); the port's
wrappers run their plain versions on CPU tensors.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvivqa_tpu.builders import populate as jax_populate
from openvivqa_tpu.models.iterative_mcan import IterativeMCAN as JaxIterativeMCAN
from openvivqa_tpu.models.modules import attentions as jattentions
from openvivqa_tpu.models.modules import decoders as jdecoders
from openvivqa_tpu.models.modules import encoders as jencoders
from openvivqa_tpu.models.modules import ffn as jffn
from openvivqa_tpu.models.modules.torch_conversion import MODEL_CONVERTERS
from openvivqa_tpu.training import decode as jdecode
from openvivqa_tpu.training import optim as joptim
from openvivqa_tpu.training.tasks.open_ended_task import OpenEndedTask as JaxOpenEndedTask
from openvivqa_tpu.training.train_state import TrainState
from openvivqa_tpu_torch.builders import build_task, populate
from openvivqa_tpu_torch.config import ConfigNode
from openvivqa_tpu_torch.models.convert import params_from_flax
from openvivqa_tpu_torch.models.iterative_mcan import IterativeMCAN
from openvivqa_tpu_torch.training import decode

jax_populate()
populate()

MASK = -10e4
D, HEADS, LAYERS = 64, 4, 2


class _Vocab:
    padding_idx, bos_idx, eos_idx, unk_idx = 0, 1, 2, 3
    max_question_length = 9
    max_answer_length = 7
    word_embeddings = None

    def __len__(self):
        return 40


def _attention(d_model, heads, d_key, stateful=False, dropout=0.1):
    return {
        "ARCHITECTURE": "ScaledDotProductAttention", "HEAD": heads, "D_MODEL": d_model,
        "D_KEY": d_key, "D_VALUE": d_key, "D_FF": 2 * d_model, "USE_AOA": False,
        "CAN_BE_STATEFUL": stateful, "DROPOUT": dropout,
    }


def _model_config(d_model=D, heads=HEADS, d_key=D // HEADS, layers=LAYERS, d_feature=48,
                  dropout=0.1):
    attn = _attention(d_model, heads, d_key, dropout=dropout)
    text = {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": d_model, "D_EMBEDDING": d_model,
            "DROPOUT": dropout, "WORD_EMBEDDING": None, "WORD_EMBEDDING_CACHE": None}
    return ConfigNode({
        "NAME": "iterative_mcan_port_test", "ARCHITECTURE": "IterativeMCAN", "D_MODEL": d_model,
        "VISION_EMBEDDING": {"ARCHITECTURE": "FeatureEmbedding", "D_FEATURE": d_feature,
                             "D_MODEL": d_model, "DROPOUT": dropout},
        "TEXT_EMBEDDING": text,
        "SELF_ENCODER": {"ARCHITECTURE": "Encoder", "D_MODEL": d_model, "LAYERS": layers,
                         "SELF_ATTENTION": attn},
        "GUIDED_ENCODER": {"ARCHITECTURE": "GuidedAttentionEncoder", "D_MODEL": d_model,
                           "LAYERS": layers, "SELF_ATTENTION": attn, "GUIDED_ATTENTION": attn},
        "MULTIMODAL_FUSION": {"D_MODEL": d_model, "D_FF": 2 * d_model, "DROPOUT": dropout},
        "DECODER": {
            "ARCHITECTURE": "Decoder", "D_MODEL": d_model, "LAYERS": layers,
            "ATTENTION": {
                "SELF_ATTENTION": _attention(d_model, heads, d_key, stateful=True, dropout=dropout),
                "ENC_ATTENTION": attn,
            },
            "TEXT_EMBEDDING": text,
        },
    })


def _t(x):
    return torch.from_numpy(np.array(x))


def _numpy_batch(seed, bs, vocab, n_regions=6, d_feature=48):
    """Region features with padded (all-zero) rows, questions and answers with
    padded tails."""
    rng = np.random.default_rng(seed)
    regions = rng.normal(size=(bs, n_regions, d_feature)).astype(np.float32)
    regions[0, -2:] = 0.0
    questions = rng.integers(4, len(vocab), size=(bs, vocab.max_question_length)).astype(np.int32)
    questions[1, -3:] = vocab.padding_idx
    answers = rng.integers(4, len(vocab), size=(bs, vocab.max_answer_length)).astype(np.int32)
    answers[:, 0] = vocab.bos_idx
    answers[0, -2:] = vocab.padding_idx
    shifted = np.concatenate([answers[:, 1:], np.zeros((bs, 1), np.int32)], axis=1)
    return {
        "region_features": regions, "question_tokens": questions, "answer_tokens": answers,
        "shifted_right_answer_tokens": shifted, "sample_valid": np.ones((bs,), bool),
    }


@pytest.fixture(scope="module")
def pair():
    """(flax model, its params, the port's model with those params)."""
    vocab, config = _Vocab(), _model_config()
    flax_model = JaxIterativeMCAN(config, vocab)
    batch = {k: jnp.asarray(v) for k, v in _numpy_batch(0, 3, vocab).items()}
    variables = jax.jit(lambda r, b: flax_model.init(r, b, train=False))(
        jax.random.PRNGKey(0), batch)
    params = variables["params"]
    port = IterativeMCAN(config, vocab).eval()
    state = params_from_flax(jax.tree.map(np.asarray, params))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return flax_model, params, port


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def _key_bias(rng, bs, n):
    bias = np.where(rng.random((bs, 1, 1, n)) < 0.25, MASK, 0.0).astype(np.float32)
    bias[..., 0] = 0.0
    return bias


# -- weights ----------------------------------------------------------------------------
def test_params_round_trip_through_the_reference_converter(pair):
    """The JAX package's IterativeMCAN converter reads the port's state_dict
    directly and returns the flax tree it came from."""
    flax_model, params, port = pair
    back = MODEL_CONVERTERS["IterativeMCAN"](port.state_dict(), flax_model.config)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(want), err_msg=str(path))


# -- modules ---------------------------------------------------------------------------
def test_usual_embedding_with_pretrained_vectors_matches_flax():
    """TEXT_EMBEDDING.WORD_EMBEDDING set: the vocab's frozen vectors under a
    learned projection (no file needed when the vocab carries the vectors)."""
    from openvivqa_tpu.models.modules.text_embeddings import UsualEmbedding as JaxUsualEmbedding
    from openvivqa_tpu_torch.models.convert import _text_embedding
    from openvivqa_tpu_torch.models.modules.text_embeddings import UsualEmbedding

    rng = np.random.default_rng(8)
    vocab = _Vocab()
    vocab.word_embeddings = rng.normal(size=(len(vocab), 12)).astype(np.float32)
    config = ConfigNode({"ARCHITECTURE": "UsualEmbedding", "D_MODEL": 16, "D_EMBEDDING": 12,
                         "DROPOUT": 0.1, "WORD_EMBEDDING": "vectors of the vocab"})
    tokens = rng.integers(0, len(vocab), size=(3, 6)).astype(np.int32)
    flax_module = JaxUsualEmbedding(config, vocab)
    variables = flax_module.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    want, (want_pad, want_causal) = flax_module.apply(variables, jnp.asarray(tokens))
    port = UsualEmbedding(config, vocab).eval()
    state = {}
    _text_embedding(state, "embedding", jax.tree.map(np.asarray, variables["params"]))
    port.load_state_dict({k.removeprefix("embedding."): torch.from_numpy(v)
                          for k, v in state.items()})
    with torch.no_grad():
        got, (pad, causal) = port(_t(tokens))
    _close(got, want)
    _close(pad, want_pad, atol=0)
    _close(causal, want_causal, atol=0)
    vocab.word_embeddings = None
    with pytest.raises(ValueError, match="no word_embeddings"):
        UsualEmbedding(config, vocab)


@pytest.mark.parametrize("bias_kind", ["key padding", "causal and padding", "none"])
def test_multi_head_attention_matches_flax(pair, bias_kind):
    flax_model, params, port = pair
    rng = np.random.default_rng(1)
    q = rng.normal(size=(3, 5, D)).astype(np.float32)
    kv = rng.normal(size=(3, 5 if bias_kind != "key padding" else 8, D)).astype(np.float32)
    bias = {
        "key padding": _key_bias(rng, 3, 8),
        "causal and padding": np.minimum(
            _key_bias(rng, 3, 5), np.triu(np.full((5, 5), MASK, np.float32), 1)[None, None]),
        "none": None,
    }[bias_kind]
    config = flax_model.config.SELF_ENCODER.SELF_ATTENTION
    want = jattentions.MultiHeadAttention(config).apply(
        {"params": params["self_encoder"]["layer_0"]["mhatt"]}, jnp.asarray(q), jnp.asarray(kv),
        jnp.asarray(kv), attention_bias=None if bias is None else jnp.asarray(bias))
    with torch.no_grad():
        got = port.self_encoder.layers[0].mhatt(
            _t(q), _t(kv), _t(kv), None if bias is None else _t(bias))
    _close(got, want)


def test_position_wise_feed_forward_matches_flax(pair):
    flax_model, params, port = pair
    x = np.random.default_rng(2).normal(size=(3, 7, D)).astype(np.float32)
    want = jffn.PositionWiseFeedForward(flax_model.config.MULTIMODAL_FUSION).apply(
        {"params": params["fusion"]}, jnp.asarray(x))
    with torch.no_grad():
        _close(port.fusion(_t(x)), want)
    w = port.fusion.fused_weights()
    assert w["w1"].shape == (D, 2 * D) and w["w1"].dtype == torch.float32
    _close(port.fusion.decode_step(_t(x[:, 0]), w), want[:, 0])


def test_encoders_match_flax(pair):
    flax_model, params, port = pair
    rng = np.random.default_rng(3)
    text = rng.normal(size=(3, 9, D)).astype(np.float32)
    vision = rng.normal(size=(3, 6, D)).astype(np.float32)
    text_bias, vision_bias = _key_bias(rng, 3, 9), _key_bias(rng, 3, 6)
    want_text = jencoders.Encoder(flax_model.config.SELF_ENCODER).apply(
        {"params": params["self_encoder"]}, jnp.asarray(text), jnp.asarray(text_bias))
    want_vision = jencoders.GuidedAttentionEncoder(flax_model.config.GUIDED_ENCODER).apply(
        {"params": params["guided_encoder"]}, jnp.asarray(vision), jnp.asarray(vision_bias),
        want_text, jnp.asarray(text_bias))
    with torch.no_grad():
        got_text = port.self_encoder(_t(text), _t(text_bias))
        got_vision = port.guided_encoder(_t(vision), _t(vision_bias), got_text, _t(text_bias))
    _close(got_text, want_text)
    _close(got_vision, want_vision)


def test_decoder_teacher_forced_matches_flax(pair):
    flax_model, params, port = pair
    rng = np.random.default_rng(4)
    batch = _numpy_batch(4, 3, flax_model.vocab)
    enc = rng.normal(size=(3, 11, D)).astype(np.float32)
    enc_bias = _key_bias(rng, 3, 11)
    want = jdecoders.Decoder(flax_model.config.DECODER, flax_model.vocab).apply(
        {"params": params["decoder"]}, jnp.asarray(batch["answer_tokens"]), jnp.asarray(enc),
        jnp.asarray(enc_bias))
    with torch.no_grad():
        got = port.decoder(_t(batch["answer_tokens"]), _t(enc), _t(enc_bias))
    _close(got, want)


@pytest.mark.parametrize("parts", ["layer", "self,cross,ffn", "none"])
def test_decoder_step_matches_flax_over_several_steps(pair, monkeypatch, parts):
    """Eight single-token steps against a ring of seven slots (the last
    overwrites the last slot on both sides), some tokens padding, on each of
    the port's decode routes against flax's step on its XLA path."""
    flax_model, params, port = pair
    vocab = flax_model.vocab
    rng = np.random.default_rng(5)
    rows = 6
    enc = rng.normal(size=(rows, 11, D)).astype(np.float32)
    enc_bias = _key_bias(rng, rows, 11)
    tokens = rng.integers(4, len(vocab), size=(vocab.max_answer_length, rows, 1)).astype(np.int32)
    tokens[0] = vocab.bos_idx
    tokens[3, :2] = vocab.padding_idx
    flax_decoder = jdecoders.Decoder(flax_model.config.DECODER, vocab)
    monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL", "0")
    monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL_PARTS", parts)
    prep = port.prepare_decode(_t(enc), _t(enc_bias))
    assert [b["route"] for b in prep["layers"]] == ["layer" if parts == "layer" else "staged"] * 2
    cache = port.init_decode_cache(rows, "cpu")
    variables = {"params": params["decoder"]}
    for token in tokens:
        want, mutated = flax_decoder.apply(
            variables, jnp.asarray(token), jnp.asarray(enc), jnp.asarray(enc_bias),
            method=flax_decoder.step, mutable=["cache"])
        variables = {"params": params["decoder"], "cache": mutated["cache"]}
        _close(port.decode_step(_t(token).long(), cache, prep), want)
    assert cache["pos"] == vocab.max_answer_length


# -- the slice as a whole ----------------------------------------------------------------
@pytest.mark.parametrize("parts", ["layer", "self,cross,ffn"])
def test_generate_matches_jax_with_pallas_kernels_in_interpret_mode(pair, monkeypatch, parts):
    """Beam-2 generate of a numpy batch: the JAX package through its decode
    kernels in interpret mode, the port through the same route's plain
    versions.  Identical tokens; log-probs within 1e-4 (the two sides sum in
    different orders and the Pallas FFN stage approximates erf)."""
    flax_model, params, port = pair
    batch = _numpy_batch(6, 3, flax_model.vocab)
    monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL", "interpret")
    monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL_PARTS", parts)
    want_tokens, want_logprobs = jdecode.generate(
        flax_model, {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
        batch_size=3, beam_size=2)
    got_tokens, got_logprobs = decode.generate(port, {k: _t(v) for k, v in batch.items()}, 2)
    np.testing.assert_array_equal(got_tokens.numpy(), np.asarray(want_tokens))
    _close(got_logprobs, want_logprobs, atol=1e-4)


def test_generate_routes_agree_and_out_size_shapes(pair, monkeypatch):
    flax_model, _, port = pair
    batch = {k: _t(v) for k, v in _numpy_batch(7, 3, flax_model.vocab).items()}
    results = {}
    for parts in ("layer", "self,cross,ffn", "none"):
        monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL_PARTS", parts)
        results[parts] = decode.generate(port, batch, 3, out_size=3, return_probs=True)
    tokens, logprobs, all_logprobs = results["layer"]
    assert tokens.shape == (3, 3, 7) and logprobs.shape == (3, 3, 7)
    assert all_logprobs.shape == (3, 3, 7, len(flax_model.vocab))
    for parts in ("self,cross,ffn", "none"):
        assert torch.equal(results[parts][0], tokens)
        _close(results[parts][1], logprobs.numpy(), atol=1e-5)


# -- the task ------------------------------------------------------------------------------
GRADIENT_FREE = "fc_k.bias"  # softmax(q . (k + b)) does not depend on b


def _task_config(paths, tmp_path, heads=2, d_key=16, dropout=0.1, **training):
    dataset = {"BATCH_SIZE": 8, "WORKERS": 2, "MAX_REGIONS": 36,
               "FEATURE_PATH": {"FEATURES": paths["features"]}}
    jp = {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["test"]}
    model = _model_config(d_model=32, heads=heads, d_key=d_key, d_feature=1024, dropout=dropout)
    return ConfigNode({
        "TASK": "OpenEndedTask",
        "DATASET": {
            "FEATURE_DATASET": dict(dataset, TYPE="FeatureDataset"),
            "DICT_DATASET": dict(dataset, TYPE="DictionaryDataset"),
            "VOCAB": {"TYPE": "Vocab", "TOKENIZER": None, "MIN_FREQ": 1, "WORD_EMBEDDING": None,
                      "WORD_EMBEDDING_CACHE": None, "PAD_TOKEN": "<pad>", "BOS_TOKEN": "<bos>",
                      "EOS_TOKEN": "<eos>", "UNK_TOKEN": "<unk>", "JSON_PATH": jp},
            "JSON_PATH": jp,
        },
        "TRAINING": {
            "CHECKPOINT_PATH": str(tmp_path / "saved_models"), "LEARNING_RATE": 1.0,
            "WARMUP": 100, "SCORE": "CIDEr", "TRAINING_BEAM_SIZE": 3, "EVALUATING_BEAM_SIZE": 2,
            "PATIENCE": 2, "MAX_EPOCHS": 2, "SEED": 11, **training,
        },
        "MODEL": model.to_dict(),
    })


def test_train_step_matches_jax(synthetic_data, tmp_path):
    """One OpenEndedTask step, loss and the Adam update, against the JAX
    package's OpenEndedTask._train_step on the same bridged weights and numpy
    batch, every dropout rate 0 (so the JAX forward with train=False is the
    same function).  Loss rtol 1e-5.  The first Adam step moves each weight by
    lr * g / (|g| + 1e-8) with lr 1.8e-4 here: about lr * sign(g), except where
    |g| comes within a few orders of Adam's 1e-8 (zero-padded region features
    give such gradients to the vision projection), where float32 gradients that
    differ in their last bits move the weight apart by a few percent of lr:
    atol 5e-6.  A key projection's bias has no gradient at all (a constant
    added to every key's logit leaves the softmax unchanged), so Adam turns
    its rounding noise into a step of +-lr on either side: those biases are
    only held to that bound."""
    config = _task_config(synthetic_data, tmp_path, dropout=0.0)
    task = build_task(config, "cpu")
    host = next(iter(task.train_dataloader))
    jax_batch = {key: jnp.asarray(value) for key, value in host.arrays().items()}

    jax_model = JaxIterativeMCAN(config.MODEL, task.vocab)
    variables = jax.jit(lambda r, b: jax_model.init(r, b, train=False))(
        jax.random.PRNGKey(0), jax_batch)
    params = jax.tree.map(np.asarray, variables["params"])
    task.model.load_state_dict({k: torch.from_numpy(v) for k, v in params_from_flax(params).items()})

    state = TrainState.create(
        lambda v, b, train, rngs: jax_model.apply(v, b, train=False), params, {},
        joptim.make_optimizer(joptim.noam_schedule(1.0, config.MODEL.D_MODEL, 100)),
    )
    stub = types.SimpleNamespace(vocab=task.vocab, maybe_remat=lambda fn: fn)
    step = jax.jit(lambda s, b, r: JaxOpenEndedTask._train_step(stub, s, b, r))
    new_state, jax_loss = step(state, jax_batch, jax.random.PRNGKey(1))

    before = params_from_flax(params)
    loss = task._train_step(task.put_batch(host))
    assert float(loss) == pytest.approx(float(jax_loss), rel=1e-5)
    want = params_from_flax(jax.tree.map(np.asarray, new_state.params))
    lr = float(joptim.noam_schedule(1.0, config.MODEL.D_MODEL, 100)(0))
    for name, tensor in task.model.state_dict().items():
        if name.endswith(GRADIENT_FREE):
            for after in (tensor.numpy(), want[name]):
                assert np.abs(after - before[name]).max() <= 1.01 * lr, name
            continue
        np.testing.assert_allclose(tensor.numpy(), want[name], atol=5e-6, rtol=0, err_msg=name)


def test_gradient_step_gives_finite_nonzero_grads(synthetic_data, tmp_path):
    """The training route at its 0.1 dropout rates: every trainable parameter
    gets a finite gradient that is not zero (the key biases, whose gradient is
    zero analytically, are only held to finite)."""
    task = build_task(_task_config(synthetic_data, tmp_path), "cpu")
    _, batch = next(task.device_batches(task.train_dataloader))
    task.optimizer.zero_grad(set_to_none=True)
    task.compute_loss(batch).backward()
    for name, param in task.model.named_parameters():
        assert param.grad is not None, name
        assert bool(torch.isfinite(param.grad).all()), name
        assert name.endswith(GRADIENT_FREE) or float(param.grad.abs().max()) > 0.0, name


@pytest.mark.parametrize("route,heads,d_key", [("layer", 2, 16), ("plain modules", 2, 8)])
def test_open_ended_end_to_end(synthetic_data, tmp_path, route, heads, d_key):
    """The port's twin of tests/test_generative_e2e.py: XE training, beam-search
    eval, checkpoints, predictions.  With 2 heads of 16 on a 32-wide model the
    decode takes the layer route; with heads of 8 (h * d_k != d_model, that
    test's geometry) it takes the modules' plain route."""
    config = _task_config(synthetic_data, tmp_path, heads=heads, d_key=d_key)
    task = build_task(config, "cpu")
    assert task.model.decoder.layers[0].supports_layer_step() == (route == "layer")
    task.start()

    ckpt_dir = os.path.join(config.TRAINING.CHECKPOINT_PATH, config.MODEL.NAME)
    assert os.path.isfile(os.path.join(ckpt_dir, "best_model.pth"))
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as handle:
        records = [json.loads(line) for line in handle]
    assert sum(r["phase"] == "train" for r in records) == 2
    assert all(np.isfinite(r["step_losses"]).all() for r in records if r["phase"] == "train")

    scores = task.get_predictions()
    assert "CIDEr" in scores
    with open(os.path.join(ckpt_dir, "test_results.json")) as handle:
        dumped = json.load(handle)
    assert len(dumped["results"]) > 0
    first = dumped["results"][0]["gens"]
    assert first and all(isinstance(v, str) for v in first.values())


def test_start_refuses_scst_until_it_is_ported(synthetic_data, tmp_path):
    """SCST is ported: with USE_SCST, start() runs its XE epochs and keeps
    ``use_rl`` in the checkpoint's metadata (the switch itself:
    tests/test_torch_port_scst.py)."""
    config = _task_config(synthetic_data, tmp_path, USE_SCST=True, MAX_EPOCHS=1)
    task = build_task(config, "cpu")
    task.start()
    ckpt = os.path.join(config.TRAINING.CHECKPOINT_PATH, config.MODEL.NAME, "last_model.pth")
    assert torch.load(ckpt, weights_only=False)["metadata"]["use_rl"] is False
