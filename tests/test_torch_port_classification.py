"""The port's classification slice (ClassificationTask with MCAN, SAAA,
VanillaTransformer, ParallelAttentionTransformer and HierarchicalCoAttention)
on the CPU against the JAX package, at small sizes.

Flax modules and models (64 wide, 4 heads of 16, 2 layers, a 40-word vocab)
are initialised from a seed, their parameter trees bridged into the port with
``params_from_flax`` (or its module helpers), and both sides run on the same
numpy inputs in float32: every module and every architecture's log-probs
within 1e-5 absolute (the two frameworks sum in different orders; the JAX LSTM
drifts by O(1e-7) from torch's).  Each bridged embedding table has a nonzero
padding row, which both sides must read as zero.  The JAX side runs its XLA
path, as off the TPU it does; the port's attention wrapper runs its plain
version on CPU tensors.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvivqa_tpu.builders import META_ARCHITECTURE as JAX_ARCHITECTURE
from openvivqa_tpu.builders import build_task as jax_build_task
from openvivqa_tpu.builders import populate as jax_populate
from openvivqa_tpu.models import common as jcommon
from openvivqa_tpu.models import hierarchical_co_attention as jhca
from openvivqa_tpu.models import saaa as jsaaa
from openvivqa_tpu.models.modules import encoders as jencoders
from openvivqa_tpu.models.modules import text_embeddings as jtext
from openvivqa_tpu.models.modules.torch_conversion import MODEL_CONVERTERS
from openvivqa_tpu.training import optim as joptim
from openvivqa_tpu.training.tasks.classification_task import (
    ClassificationTask as JaxClassificationTask,
)
from openvivqa_tpu.training.train_state import TrainState
from openvivqa_tpu_torch.builders import META_ARCHITECTURE, build_task, populate
from openvivqa_tpu_torch.config import ConfigNode, get_config
from openvivqa_tpu_torch.models import common, convert, hierarchical_co_attention, saaa
from openvivqa_tpu_torch.models.convert import params_from_flax
from openvivqa_tpu_torch.models.modules import encoders, text_embeddings

jax_populate()
populate()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASK = -10e4
D, HEADS, LAYERS, D_EMB, D_FEATURE = 64, 4, 2, 24, 48
TOL = 1e-5
# no gradient, analytically: softmax(q . (k + b)) does not depend on b, nor does a
# softmax over tokens or regions on the bias its logits share (the attention-reduce
# MLPs' fc2, SAAA's glimpse logits x_conv)
GRADIENT_FREE = ("fc_k.bias", "attr_reduce.fc2.bias", "x_conv.bias")
HELD = "lstm.bias_ih_l0"  # held out of training: flax's cell has one LSTM bias


class _Vocab:
    padding_idx, bos_idx, eos_idx, unk_idx = 0, 1, 2, 3
    max_question_length = 9
    total_answers = 12
    word_embeddings = None

    def __len__(self):
        return 40


def _attention(d_model=D, heads=HEADS, dropout=0.1):
    return {"ARCHITECTURE": "ScaledDotProductAttention", "HEAD": heads, "D_MODEL": d_model,
            "D_KEY": d_model // heads, "D_VALUE": d_model // heads, "D_FF": 2 * d_model,
            "USE_AOA": False, "CAN_BE_STATEFUL": False, "DROPOUT": dropout}


def _text(kind, d_model=D, dropout=0.1):
    text = {"ARCHITECTURE": kind, "D_MODEL": d_model, "D_EMBEDDING": D_EMB, "DROPOUT": dropout,
            "WORD_EMBEDDING": None, "WORD_EMBEDDING_CACHE": None}
    if kind == "HierarchicalFeaturesExtractor":
        text["N_GRAMS"] = [1, 2, 3]
    return text


def _model_config(arch, text_kind="UsualEmbedding", d_model=D, heads=HEADS, layers=LAYERS,
                  d_feature=D_FEATURE, dropout=0.1):
    """The MODEL node of `arch` at small widths; `text_kind` picks the text
    embedding (the three variants of the MCAN and SAAA configs)."""
    attn = _attention(d_model, heads, dropout)
    vision = {"ARCHITECTURE": "FeatureEmbedding", "D_FEATURE": d_feature, "D_MODEL": d_model,
              "DROPOUT": dropout}
    reduce = {"D_MODEL": d_model, "DROPOUT": dropout}
    co = {"ARCHITECTURE": "CoAttentionEncoder", "D_MODEL": d_model, "LAYERS": layers,
          **{k: attn for k in ("VISION_LANGUAGE_ATTENTION", "LANGUAGE_VISION_ATTENTION",
                               "VISION_SELF_ATTENTION", "LANGUAGE_SELF_ATTENTION")}}
    node = {"NAME": f"{arch.lower()}_port_test", "ARCHITECTURE": arch, "D_MODEL": d_model}
    if arch == "MCAN":
        node.update({
            "VISION_EMBEDDING": vision, "TEXT_EMBEDDING": _text(text_kind, d_model, dropout),
            "SELF_ENCODER": {"ARCHITECTURE": "Encoder", "D_MODEL": d_model, "LAYERS": layers,
                             "SELF_ATTENTION": attn},
            "GUIDED_ENCODER": {"ARCHITECTURE": "GuidedAttentionEncoder", "D_MODEL": d_model,
                               "LAYERS": layers, "SELF_ATTENTION": attn,
                               "GUIDED_ATTENTION": attn},
            "VISION_ATTR_REDUCE": reduce, "TEXT_ATTR_REDUCE": reduce})
    elif arch == "SAAA":
        node.update({
            "VISION_PROCESSOR": vision, "TEXT_PROCESSOR": _text(text_kind, d_model, dropout),
            "ATTENTION": {"D_VISION": d_model, "D_LANGUAGE": d_model, "D_MODEL": d_model,
                          "DROPOUT": dropout, "GLIMPSES": 2}})
    elif arch == "VanillaTransformer":
        node.update({
            "VISION_EMBEDDING": vision, "TEXT_EMBEDDING": _text(text_kind, d_model, dropout),
            "ENCODER": {"ARCHITECTURE": "Encoder", "D_MODEL": d_model, "LAYERS": layers,
                        "SELF_ATTENTION": attn},
            "ATTR_REDUCE": reduce})
    else:
        hierarchical = arch == "HierarchicalCoAttention"
        node.update({
            "VISION_EMBEDDING": vision,
            "TEXT_EMBEDDING": _text(text_kind, D_EMB if hierarchical else d_model, dropout),
            "ENCODER": co, "VISION_ATTR_REDUCE": reduce, "TEXT_ATTR_REDUCE": reduce})
        if hierarchical:
            node["HIERARCHICAL"] = {"D_MODEL": d_model, "N_GRAMS": [1, 2, 3],
                                    "WORD_EMBEDDING_DIM": D_EMB}
    return ConfigNode(node)


# the text-embedding variants of the nine configs, by architecture
VARIANTS = [
    ("MCAN", "LSTMTextEmbedding"),  # mcan.yaml
    ("MCAN", "UsualEmbedding"),  # mcan_non_lstm.yaml
    ("MCAN", "HierarchicalFeaturesExtractor"),  # mcan_hierarchical.yaml
    ("SAAA", "LSTMTextEmbedding"),  # saaa.yaml
    ("SAAA", "UsualEmbedding"),  # saaa_non_lstm.yaml
    ("SAAA", "HierarchicalFeaturesExtractor"),  # saaa_hierarchical.yaml
    ("VanillaTransformer", "UsualEmbedding"),
    ("ParallelAttentionTransformer", "UsualEmbedding"),
    ("HierarchicalCoAttention", "UsualEmbedding"),
]


def _t(x):
    return torch.from_numpy(np.array(x))


def _numpy_batch(seed, bs=3, n_regions=6, d_feature=D_FEATURE, vocab=_Vocab()):
    """Region features with padded (all-zero) rows, questions with padded
    tails (row 2 down to its <bos> alone) and class ids."""
    rng = np.random.default_rng(seed)
    regions = rng.normal(size=(bs, n_regions, d_feature)).astype(np.float32)
    regions[0, -2:] = 0.0
    questions = rng.integers(4, len(vocab), size=(bs, vocab.max_question_length)).astype(np.int32)
    questions[:, 0] = vocab.bos_idx
    questions[1, -3:] = vocab.padding_idx
    questions[2, 1:] = vocab.padding_idx
    answers = rng.integers(0, vocab.total_answers, size=(bs, 1)).astype(np.int32)
    return {"region_features": regions, "question_tokens": questions, "answer": answers,
            "sample_valid": np.ones((bs,), bool)}


def _with_nonzero_padding_rows(tree, rng):
    """A copy of `tree` whose embedding tables have a nonzero row 0 (the
    padding row): both sides must zero it at every forward."""
    def visit(node):
        if not isinstance(node, dict):
            return node
        out = {k: visit(v) for k, v in node.items()}
        if "embedding" in out and getattr(out["embedding"], "ndim", 0) == 2:
            table = np.array(out["embedding"])
            table[0] = rng.normal(size=table.shape[1])
            out["embedding"] = table
        return out

    return jax.tree.map(jnp.asarray, visit(jax.tree.map(np.asarray, tree)))


def _load(module, state):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return module.eval()


def _bridge(helper, tree):
    """A module's state_dict from one of convert's helpers."""
    out = {}
    helper(out, "m", tree)
    return {key[2:]: value for key, value in out.items()}


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def _init(module, *args, seed=0, **kwargs):
    return module.init(jax.random.PRNGKey(seed), *args, **kwargs)["params"]


# -- modules ---------------------------------------------------------------------------
def test_attention_reduce_mlp_and_pool_match_flax():
    config = ConfigNode({"D_MODEL": D, "DROPOUT": 0.1})
    x = np.random.default_rng(0).normal(size=(3, 7, D)).astype(np.float32)
    flax_module = jcommon.AttentionReduceMLP(config)
    params = _init(flax_module, jnp.asarray(x))
    port = _load(common.AttentionReduceMLP(config, D), _bridge(convert._attr_reduce, params))
    want = flax_module.apply({"params": params}, jnp.asarray(x))
    got = port(_t(x))
    _close(got, want)
    _close(common.attention_pool(_t(x), got), jcommon.attention_pool(jnp.asarray(x), want))


def test_dual_stream_classifier_matches_flax():
    config = _model_config("ParallelAttentionTransformer")
    rng = np.random.default_rng(1)
    v, t = (rng.normal(size=(3, n, D)).astype(np.float32) for n in (6, 9))
    flax_module = jcommon.DualStreamClassifier(config, 12)
    params = _init(flax_module, jnp.asarray(v), jnp.asarray(t))

    class Head(common.DualStreamClassifier, torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.build_classifier(config, 12)

    state = {}
    convert._dual_stream_head(state, params)
    port = _load(Head(), state)
    _close(port.classify_streams(_t(v), _t(t)),
           flax_module.apply({"params": params}, jnp.asarray(v), jnp.asarray(t)))


def test_lstm_matches_flax():
    """One LSTM over a (3, 9, 64) sequence, the biases summed into one."""
    x = np.random.default_rng(2).normal(size=(3, 9, D)).astype(np.float32)
    flax_module = jtext._LSTM(D)
    params = _init(flax_module, jnp.asarray(x))
    cell = dict(params["OptimizedLSTMCell_0"])
    rng = np.random.default_rng(3)
    cell = {k: {n: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32) if n == "bias" else a
                for n, a in jax.tree.map(np.asarray, v).items()} for k, v in cell.items()}
    port = _load(torch.nn.LSTM(D, D, batch_first=True), _bridge(convert._lstm, cell))
    want = flax_module.apply({"params": {"OptimizedLSTMCell_0": cell}}, jnp.asarray(x))
    _close(port(_t(x))[0], want)


@pytest.mark.parametrize("kind", ["LSTMTextEmbedding", "UsualEmbedding",
                                  "HierarchicalFeaturesExtractor"])
def test_text_embedding_matches_flax(kind):
    """Each text embedding of the configs with a nonzero padding row in the
    bridged table, on questions with padded tails: features within 1e-5,
    the padding bias equal."""
    vocab, config = _Vocab(), ConfigNode(_text(kind))
    tokens = _numpy_batch(4)["question_tokens"]
    flax_module = getattr(jtext, kind)(config, vocab)
    params = _with_nonzero_padding_rows(_init(flax_module, jnp.asarray(tokens)),
                                        np.random.default_rng(5))
    port = _load(getattr(text_embeddings, kind)(config, vocab),
                 _bridge(convert._any_text_embedding, params))
    want, (want_bias, _) = flax_module.apply({"params": params}, jnp.asarray(tokens))
    got, (got_bias, _) = port(_t(tokens))
    _close(got, want)
    np.testing.assert_array_equal(got_bias.numpy(), np.asarray(want_bias))


def test_model_local_hierarchical_extractor_matches_flax():
    """HierarchicalCoAttention's own extractor (the cumsum window sums), not
    the registered text embedding."""
    config = ConfigNode({"D_MODEL": D, "N_GRAMS": [1, 2, 3, 4]})
    x = np.random.default_rng(6).normal(size=(3, 9, D_EMB)).astype(np.float32)
    flax_module = jhca.HierarchicalFeaturesExtractor(config)
    params = _init(flax_module, jnp.asarray(x))
    state = {f"convs.{i}.{n}": v for i in range(4) for n, v in _bridge(
        convert._conv, params[f"Conv_{i}"]).items()}
    port = _load(hierarchical_co_attention.HierarchicalFeaturesExtractor(config, D_EMB), state)
    _close(port(_t(x)), flax_module.apply({"params": params}, jnp.asarray(x)))


def test_co_attention_encoder_matches_flax():
    """Both streams after two layers, in the JAX package's update order, under
    padding biases on both streams."""
    config = _model_config("ParallelAttentionTransformer").ENCODER
    rng = np.random.default_rng(7)
    v, t = (rng.normal(size=(3, n, D)).astype(np.float32) for n in (6, 9))
    v_bias = np.where(rng.random((3, 1, 1, 6)) < 0.3, MASK, 0.0).astype(np.float32)
    t_bias = np.where(rng.random((3, 1, 1, 9)) < 0.3, MASK, 0.0).astype(np.float32)
    v_bias[..., 0] = t_bias[..., 0] = 0.0
    flax_module = jencoders.CoAttentionEncoder(config)
    args = tuple(jnp.asarray(a) for a in (v, v_bias, t, t_bias))
    params = _init(flax_module, *args)
    port = _load(encoders.CoAttentionEncoder(config),
                 _bridge(convert._co_attention_encoder, params))
    want_v, want_t = flax_module.apply({"params": params}, *args)
    got_v, got_t = port(*(_t(a) for a in (v, v_bias, t, t_bias)))
    _close(got_v, want_v)
    _close(got_t, want_t)


def test_saaa_co_attention_matches_flax():
    config = ConfigNode({"D_MODEL": D, "DROPOUT": 0.1, "GLIMPSES": 2})
    rng = np.random.default_rng(8)
    v, q = rng.normal(size=(3, 6, D)).astype(np.float32), rng.normal(size=(3, D)).astype(
        np.float32)
    flax_module = jsaaa.CoAttention(config)
    params = _init(flax_module, jnp.asarray(v), jnp.asarray(q))
    state = {}
    convert._kernel(state, "v_conv", params["Dense_0"])
    convert._linear(state, "q_lin", params["Dense_1"])
    convert._linear(state, "x_conv", params["Dense_2"])
    port = _load(saaa.CoAttention(config, D, D), state)
    _close(port(_t(v), _t(q)), flax_module.apply({"params": params}, jnp.asarray(v),
                                                 jnp.asarray(q)))


# -- whole models ----------------------------------------------------------------------
def _pair(arch, text_kind, seed=0, **config_kwargs):
    """(flax model, its params with nonzero padding rows, the port's model
    with those params)."""
    vocab, config = _Vocab(), _model_config(arch, text_kind, **config_kwargs)
    flax_model = JAX_ARCHITECTURE.get(arch)(config=config, vocab=vocab)
    batch = {k: jnp.asarray(v) for k, v in _numpy_batch(0).items()}
    params = jax.jit(lambda r, b: flax_model.init(r, b, train=False))(
        jax.random.PRNGKey(seed), batch)["params"]
    params = _with_nonzero_padding_rows(params, np.random.default_rng(seed + 1))
    port = _load(META_ARCHITECTURE.get(arch)(config, vocab), params_from_flax(params, config))
    return flax_model, params, port


@pytest.mark.parametrize("arch,text_kind", VARIANTS, ids=[f"{a}-{t}" for a, t in VARIANTS])
def test_architecture_logprobs_match_flax(arch, text_kind):
    """Each architecture of the nine configs, across their text embeddings:
    the class log-probs of a numpy batch in eval within 1e-5, the bridge
    covering every parameter of the port's model."""
    flax_model, params, port = _pair(arch, text_kind)
    batch = _numpy_batch(9)
    want = flax_model.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = port({k: _t(v) for k, v in batch.items()})
    assert got.shape == (3, _Vocab.total_answers)
    _close(got, want)


@pytest.mark.parametrize("arch,text_kind", [("MCAN", "LSTMTextEmbedding"),
                                            ("MCAN", "UsualEmbedding"),
                                            ("SAAA", "LSTMTextEmbedding")])
def test_params_round_trip_through_the_reference_converter(arch, text_kind):
    """The JAX package's converter (``MODEL_CONVERTERS``) reads the port's
    state_dict back into the flax tree it came from (mcan.yaml,
    mcan_non_lstm.yaml, saaa.yaml; the LSTM's biases summed)."""
    config = _model_config(arch, text_kind)
    _, params, port = _pair(arch, text_kind)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    back = MODEL_CONVERTERS[arch](state, config)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_allclose(np.asarray(got[path]), leaf, atol=1e-6, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_bridge_refuses_an_unknown_tree():
    with pytest.raises(ValueError, match="no bridge"):
        params_from_flax({"unknown_0": {}})


# -- the task ----------------------------------------------------------------------------
def _task_config(paths, tmp_path, arch="MCAN", text_kind="LSTMTextEmbedding", dropout=0.1,
                 name="port", **training):
    jp = {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["test"]}
    model = _model_config(arch, text_kind, d_model=32, heads=2, d_feature=1024,
                          dropout=dropout).to_dict()
    model["NAME"] = f"{arch.lower()}_{name}"
    return ConfigNode({
        "TASK": "ClassificationTask",
        "DATASET": {
            "FEATURE_DATASET": {"TYPE": "FeatureClassificationDataset", "BATCH_SIZE": 8,
                                "WORKERS": 2, "MAX_REGIONS": 36,
                                "FEATURE_PATH": {"FEATURES": paths["features"]}},
            "VOCAB": {"TYPE": "ClassificationVocab", "TOKENIZER": None, "MIN_FREQ": 1,
                      "WORD_EMBEDDING": None, "WORD_EMBEDDING_CACHE": None,
                      "PAD_TOKEN": "<pad>", "BOS_TOKEN": "<bos>", "EOS_TOKEN": "<eos>",
                      "UNK_TOKEN": "<unk>", "JSON_PATH": jp},
            "JSON_PATH": jp,
        },
        "TRAINING": {
            "CHECKPOINT_PATH": str(tmp_path / "saved_models"), "LEARNING_RATE": 0.1,
            "WARMUP": 100, "SCORE": "CIDEr", "GET_SCORES": True, "PATIENCE": 2,
            "MAX_EPOCHS": 2, "SEED": 7, **training,
        },
        "MODEL": model,
    })


def _jax_params(task, config):
    """A flax tree of `config`'s model, initialised on the task's first train
    batch, with nonzero padding rows."""
    host = next(iter(task.train_dataloader))
    jax_model = JAX_ARCHITECTURE.get(config.MODEL.ARCHITECTURE)(config=config.MODEL,
                                                                vocab=task.vocab)
    batch = {key: jnp.asarray(value) for key, value in host.arrays().items()}
    variables = jax.jit(lambda r, b: jax_model.init(r, b, train=False))(
        jax.random.PRNGKey(0), batch)
    params = _with_nonzero_padding_rows(variables["params"], np.random.default_rng(0))
    return jax_model, params, host, batch


# The first Adam step moves a weight by lr * g / (|g| + 1e-8): about lr * sign(g),
# where float32 gradients that differ in their last bits move the two sides'
# weights apart by a tiny share of lr (held to 1e-3 * lr).  Where |g| comes
# within a few orders of Adam's 1e-8 (below NEAR_EPS), the same rounding moves
# them apart by a share of lr that grows as |g| shrinks: those elements (a
# GELU unit nearly dead on the batch, the zero-padded region rows, the
# padding row of the table) are held to the step's own bound, lr.
NEAR_EPS = 1e-6


def test_train_step_matches_jax(synthetic_data, tmp_path):
    """One ClassificationTask step on MCAN with its LSTM (mcan.yaml's
    geometry, every dropout rate 0 so that the JAX forward with train=False
    is the same function): the loss within rtol 1e-5 and every weight after
    the first Adam step at the constant schedule (effective rate 0.1^2)
    against the JAX package's ClassificationTask._train_step on the same
    bridged weights and batch.  The key projection biases have no gradient at
    all, nor have the biases of the logits the attention pools' softmaxes
    read, so Adam turns their rounding noise into a step of up to lr either
    way: they are held to that bound."""
    config = _task_config(synthetic_data, tmp_path, dropout=0.0)
    task = build_task(config, "cpu")
    jax_model, params, host, jax_batch = _jax_params(task, config)
    task.model.load_state_dict({k: torch.from_numpy(v)
                                for k, v in params_from_flax(params).items()})
    schedule = joptim.constant_lambda_schedule(config.TRAINING.LEARNING_RATE)
    state = TrainState.create(lambda v, b, train, rngs: jax_model.apply(v, b, train=False),
                              params, {}, joptim.make_optimizer(schedule))
    stub = types.SimpleNamespace(vocab=task.vocab, maybe_remat=lambda fn: fn)
    step = jax.jit(lambda s, b, r: JaxClassificationTask._train_step(stub, s, b, r))
    new_state, jax_loss = step(state, jax_batch, jax.random.PRNGKey(1))

    before = params_from_flax(params)
    loss = task._train_step(task.put_batch(host))
    assert float(loss) == pytest.approx(float(jax_loss), rel=1e-5)
    want = params_from_flax(jax.tree.map(np.asarray, new_state.params))
    grads = {name: p.grad for name, p in task.model.named_parameters()}
    lr = float(schedule(0))
    near_eps = 0
    for name, tensor in task.model.state_dict().items():
        got = tensor.numpy()
        if name.endswith(HELD):  # no gradient on either side: unchanged
            np.testing.assert_array_equal(got, before[name], err_msg=name)
            continue
        small = (np.ones_like(got, bool) if name.endswith(GRADIENT_FREE)
                 else grads[name].abs().numpy() < NEAR_EPS)
        near_eps += int(small.sum()) if not name.endswith(GRADIENT_FREE) else 0
        for after in (got, want[name]):
            assert np.abs(after - before[name])[small].max(initial=0.0) <= 1.01 * lr, name
        np.testing.assert_allclose(got[~small], want[name][~small], atol=1e-3 * lr, rtol=0,
                                   err_msg=name)
    n_weights = sum(t.numel() for t in task.model.state_dict().values())
    assert near_eps < 0.01 * n_weights, near_eps


def test_eval_predictions_and_test_results_match_jax(synthetic_data, tmp_path):
    """The dev split's argmax answers and the written test_results.json
    (answers, ids, filenames, scores) of the port's task equal the JAX
    package's on the same weights (HierarchicalCoAttention; both tasks read a
    prediction checkpoint that holds those weights)."""
    config = _task_config(synthetic_data, tmp_path, arch="HierarchicalCoAttention",
                          text_kind="UsualEmbedding")
    jax_config = config.merged({"TRAINING": {"CHECKPOINT_PATH": str(tmp_path / "jax")}})
    probe = build_task(config, "cpu")
    _, params, _, _ = _jax_params(probe, config)
    task = build_task(config, "cpu", params=params)
    jtask = jax_build_task(jax_config)
    jtask.state = jtask.state.replace(params=jax.tree.map(jnp.asarray, params))
    assert jtask.vocab.itoa == task.vocab.itoa

    _, jax_eval = jtask._compiled()
    got, want = [], []
    for (_, device_batch), (_, jax_batch) in zip(task.device_batches(task.dev_dataloader),
                                                 jtask.device_batches(jtask.dev_dataloader)):
        got.append(task.predict(device_batch))
        want.append(np.asarray(jax_eval(jtask.state, jax_batch)))
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    assert task.evaluate_metrics(task.dev_dataloader) == pytest.approx(
        jtask.evaluate_metrics(jtask.dev_dataloader))

    for t in (task, jtask):  # the weights are already loaded: a checkpoint file stands for them
        open(os.path.join(t.checkpoint_path, "best_model.pth"), "w").close()
        t.load_checkpoint = lambda fname: None
    scores, jax_scores = task.get_predictions(), jtask.get_predictions()
    assert scores == pytest.approx(jax_scores)
    dumped = [json.load(open(os.path.join(t.checkpoint_path, "test_results.json")))
              for t in (task, jtask)]
    assert dumped[0]["results"] == dumped[1]["results"]
    assert len(dumped[0]["results"]) > 0


@pytest.mark.parametrize("arch,text_kind", [("MCAN", "LSTMTextEmbedding"),
                                            ("SAAA", "LSTMTextEmbedding")])
def test_classification_end_to_end(synthetic_data, tmp_path, arch, text_kind):
    """The port's twin of tests/test_classification_e2e.py: two epochs of
    start(), checkpoints, get_predictions() and test_results.json."""
    config = _task_config(synthetic_data, tmp_path, arch=arch, text_kind=text_kind)
    task = build_task(config, "cpu")
    task.start()
    ckpt_dir = os.path.join(config.TRAINING.CHECKPOINT_PATH, config.MODEL.NAME)
    for name in ("best_model.pth", "last_model.pth", "vocab.bin"):
        assert os.path.isfile(os.path.join(ckpt_dir, name)), name
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as handle:
        records = [json.loads(line) for line in handle]
    train = [r for r in records if r["phase"] == "train"]
    assert len(train) == 2
    assert all(len(r["step_losses"]) == len(task.train_dataloader) for r in train)
    assert all(np.isfinite(r["step_losses"]).all() for r in train)
    assert sum(r["phase"] == "validation" for r in records) == 2

    scores = task.get_predictions()
    assert "CIDEr" in scores
    with open(os.path.join(ckpt_dir, "test_results.json")) as handle:
        dumped = json.load(handle)
    assert len(dumped["results"]) > 0
    first = dumped["results"][0]
    assert first["gens"] and all(isinstance(v, str) for v in first["gens"].values())
    assert len(first["id"]) == len(first["filename"]) == len(first["gens"])

    resumed = build_task(config, "cpu")  # resumes from last_model.pth, already at MAX_EPOCHS
    resumed.start()
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as handle:
        assert sum(json.loads(line)["phase"] == "train" for line in handle) == 3


@pytest.mark.parametrize("arch,text_kind", VARIANTS, ids=[f"{a}-{t}" for a, t in VARIANTS])
def test_gradient_step_gives_finite_nonzero_grads(synthetic_data, tmp_path, arch, text_kind):
    """The training route at its 0.1 dropout rates: every trainable parameter
    gets a finite gradient that is not zero (the biases in GRADIENT_FREE, zero
    analytically, only finite); the LSTM's held input bias gets none."""
    task = build_task(_task_config(synthetic_data, tmp_path, arch=arch, text_kind=text_kind),
                      "cpu")
    _, batch = next(task.device_batches(task.train_dataloader))
    task.optimizer.zero_grad(set_to_none=True)
    loss = task.compute_loss(batch)
    assert bool(torch.isfinite(loss))
    loss.backward()
    for name, param in task.model.named_parameters():
        if name.endswith(HELD):
            assert param.grad is None and not param.requires_grad, name
            continue
        assert param.grad is not None, name
        assert bool(torch.isfinite(param.grad).all()), name
        assert name.endswith(GRADIENT_FREE) or float(param.grad.abs().max()) > 0.0, name


def test_loss_ignores_class_zero_and_padding_rows():
    """NLL with ignore_index = padding_idx: class 0 counts for nothing (the
    reference's quirk, kept), nor do batch-padding rows."""
    from openvivqa_tpu_torch.training.train_state import nll_loss

    logprobs = torch.log_softmax(torch.randn(4, 5, generator=torch.Generator().manual_seed(0)),
                                 dim=-1)
    targets = torch.tensor([0, 2, 3, 4])
    valid = torch.tensor([True, True, True, False])
    want = -(logprobs[1, 2] + logprobs[2, 3]) / 2
    assert float(nll_loss(logprobs, targets, 0, weights=valid)) == pytest.approx(float(want))


CONFIGS = {
    "mcan.yaml": ("MCAN", 1024), "mcan_non_lstm.yaml": ("MCAN", 1024),
    "mcan_hierarchical.yaml": ("MCAN", 1024), "saaa.yaml": ("SAAA", 1024),
    "saaa_non_lstm.yaml": ("SAAA", 1024), "saaa_hierarchical.yaml": ("SAAA", 1024),
    "vanilla_transformer.yaml": ("VanillaTransformer", 2048),
    "parallel_attention_transformer.yaml": ("ParallelAttentionTransformer", 2048),
    "hierarchical_co_attention.yaml": ("HierarchicalCoAttention", 2048),
}


def _one_layer(node):
    """Every LAYERS of a MODEL node cut to 1 (widths kept)."""
    if not isinstance(node, dict):
        return node
    return {k: 1 if k == "LAYERS" else _one_layer(v) for k, v in node.items()}


@pytest.mark.parametrize("config_file", sorted(CONFIGS))
def test_config_builds_its_task_in_the_ports_registries(synthetic_data, tmp_path, config_file):
    """Each of the nine configs at its own widths (its depth cut to one layer,
    the data pointed at the synthetic set): ClassificationTask with its
    architecture, the feature width the config names, and its schedule."""
    arch, d_feature = CONFIGS[config_file]
    jp = {"TRAIN": synthetic_data["train"], "DEV": synthetic_data["dev"],
          "TEST": synthetic_data["test"]}
    base = get_config(os.path.join(ROOT, "configs", config_file))
    config = base.merged({
        "DATASET": {"FEATURE_DATASET": {"FEATURE_PATH": {"FEATURES": synthetic_data["features"]}},
                    "JSON_PATH": jp, "VOCAB": {"JSON_PATH": jp}},
        "TRAINING": {"CHECKPOINT_PATH": str(tmp_path / "saved_models")},
        "MODEL": _one_layer(base.MODEL.to_dict()),
    })
    task = build_task(config, "cpu")
    assert type(task).__name__ == "ClassificationTask"
    assert type(task.model).__name__ == arch
    vision = getattr(task.model, "vision", None) or task.model.vision_embedding
    assert vision.proj.in_features == d_feature
    rate = config.TRAINING.LEARNING_RATE
    assert task.optimizer.param_groups[0]["lr"] == pytest.approx(rate * rate)
    assert len(task.train_dataset) > 0 and task.train_dataset[0]["answer"].shape == (1,)
