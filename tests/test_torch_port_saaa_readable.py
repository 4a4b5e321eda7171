"""The port's IterativeSAAA (TrainingSAAATask) and ReadableIterativeMCAN
(OpenEndedTask over the OCR datasets) on the CPU against the JAX package, at
small sizes.

``VisionOcrEmbedding`` and ``TextProcessor`` are held to flax within 1e-5 (the
question table's padding row nonzero, the LayerNorms off their unit scale);
each model (64 wide, 4 heads of 16, 2 layers, IterativeSAAA's decoder one
layer as in its config) on numpy-drawn weights to its log-probs within 1e-4
and its beam-3 ``generate()`` (tokens equal, cumulative log-probs within
1e-4).  The bridges put every flax tensor in exactly one port tensor;
ReadableIterativeMCAN's also goes back through the JAX package's converter for
it, ``convert_iterative_mcan``, which reads every tensor but the vision
embedding's (it maps IterativeMCAN's one-linear embedding).  One Adam step per
model against the JAX task's, the gradients of a dropout-0.1 step,
TrainingSAAATask end to end and both YAMLs at their full widths with flax's
parameter counts.
"""

import copy
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_vlsp_family import D, HEADS, _close, _numpy_params, _t
from test_torch_port_vlsp_training import adam_step_matches_jax

from openvivqa_tpu.builders import META_ARCHITECTURE as JAX_ARCHITECTURE
from openvivqa_tpu.builders import populate as jax_populate
from openvivqa_tpu.models import iterative_saaa as jsaaa
from openvivqa_tpu.models.modules import vision_embeddings as jvision
from openvivqa_tpu.models.modules.torch_conversion import MODEL_CONVERTERS
from openvivqa_tpu.training.tasks.open_ended_task import OpenEndedTask as JaxOpenEndedTask
from openvivqa_tpu.training import decode as jdecode
from openvivqa_tpu_torch import builders
from openvivqa_tpu_torch.builders import META_ARCHITECTURE, META_TASK, build_model, populate
from openvivqa_tpu_torch.config import ConfigNode, get_config
from openvivqa_tpu_torch.models import convert, iterative_saaa
from openvivqa_tpu_torch.models.convert import params_from_flax
from openvivqa_tpu_torch.models.modules import vision_embeddings
from openvivqa_tpu_torch.training import decode
from openvivqa_tpu_torch.training.tasks.open_ended_task import OpenEndedTask

jax_populate()
populate()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE_TOL, MODEL_TOL = 1e-5, 1e-4
REGIONS, D_REGION = 6, 24
OCR, D_DET, D_REC, D_FASTTEXT = 5, 8, 8, 12
# no gradient, analytically: softmax(q . (k + b)) does not depend on b, nor does the
# glimpse softmax over the regions on the bias its logits share (x_conv)
GRADIENT_FREE = ("fc_k.bias", "x_conv.bias")
HELD = "lstm.bias_ih_l0"  # held out of training: flax's cell has one LSTM bias


class _Vocab:
    padding_idx, bos_idx, eos_idx, unk_idx = 0, 1, 2, 3
    max_question_length = 7
    max_answer_length = 5
    word_embeddings = None

    def __len__(self):
        return 40


def _attention(stateful=False, dropout=0.1):
    return {"ARCHITECTURE": "ScaledDotProductAttention", "HEAD": HEADS, "D_MODEL": D,
            "D_KEY": D // HEADS, "D_VALUE": D // HEADS, "D_FF": 2 * D, "USE_AOA": False,
            "CAN_BE_STATEFUL": stateful, "DROPOUT": dropout}


def _model_config(arch, dropout=0.1):
    text = {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": D, "D_EMBEDDING": D,
            "DROPOUT": dropout, "WORD_EMBEDDING": None}
    decoder = {"ARCHITECTURE": "Decoder", "D_MODEL": D, "TEXT_EMBEDDING": text,
               "LAYERS": 1 if arch == "IterativeSAAA" else 2,
               "ATTENTION": {"SELF_ATTENTION": _attention(True, dropout),
                             "ENC_ATTENTION": _attention(False, dropout)}}
    fusion = {"D_MODEL": D, "D_FF": 2 * D, "DROPOUT": dropout}
    node = {"NAME": f"{arch.lower()}_port_test", "ARCHITECTURE": arch, "D_MODEL": D,
            "DECODER": decoder, "MULTIMODAL_FUSION": fusion}
    if arch == "IterativeSAAA":
        node.update(
            VISION_PROCESSOR={"ARCHITECTURE": "FeatureEmbedding", "D_FEATURE": D_REGION,
                              "D_MODEL": D, "DROPOUT": dropout},
            TEXT_PROCESSOR={"D_EMBEDDING": 24, "D_MODEL": D, "DROPOUT": dropout},
            ATTENTION={"ARCHITECTURE": "CoAttention", "D_VISION": D, "D_LANGUAGE": D,
                       "D_MODEL": D, "DROPOUT": dropout, "GLIMPSES": 2})
    else:
        node.update(
            VISION_EMBEDDING={"ARCHITECTURE": "VisionOcrEmbedding", "D_MODEL": D,
                              "DROPOUT": dropout, "D_OBJ_FEATURE": D_REGION,
                              "D_OCR_FEATURE": D_DET + D_REC + D_FASTTEXT},
            TEXT_EMBEDDING=text,
            SELF_ENCODER={"ARCHITECTURE": "Encoder", "D_MODEL": D, "LAYERS": 2,
                          "SELF_ATTENTION": _attention(False, dropout)},
            GUIDED_ENCODER={"ARCHITECTURE": "GuidedAttentionEncoder", "D_MODEL": D, "LAYERS": 2,
                            "SELF_ATTENTION": _attention(False, dropout),
                            "GUIDED_ATTENTION": _attention(False, dropout)})
    return ConfigNode(node)


def _numpy_batch(seed, bs=3, vocab=_Vocab()):
    """Regions and OCR tokens with zero (padding) rows, padded question and
    answer tails."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    batch = {"region_features": normal(bs, REGIONS, D_REGION),
             "region_boxes": rng.uniform(size=(bs, REGIONS, 4)).astype(np.float32),
             "ocr_det_features": normal(bs, OCR, D_DET), "ocr_rec_features": normal(bs, OCR, D_REC),
             "ocr_fasttext_features": normal(bs, OCR, D_FASTTEXT),
             "ocr_boxes": rng.uniform(size=(bs, OCR, 4)).astype(np.float32)}
    batch["region_features"][1, -2:] = 0.0
    for key in ("ocr_det_features", "ocr_rec_features", "ocr_fasttext_features", "ocr_boxes"):
        batch[key][0, -2:] = 0.0  # padded OCR slots: all-zero det features
    questions = rng.integers(4, len(vocab), size=(bs, vocab.max_question_length)).astype(np.int32)
    questions[1, -3:] = vocab.padding_idx
    questions[2, 2:] = vocab.padding_idx
    answers = rng.integers(4, len(vocab), size=(bs, vocab.max_answer_length)).astype(np.int32)
    answers[:, 0] = vocab.bos_idx
    answers[0, -2:] = vocab.padding_idx
    shifted = np.concatenate([answers[:, 1:], np.zeros((bs, 1), np.int32)], axis=1)
    return dict(batch, question_tokens=questions, answer_tokens=answers,
                shifted_right_answer_tokens=shifted, sample_valid=np.ones((bs,), bool))


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -- the modules ----------------------------------------------------------------------------
def test_vision_ocr_embedding_matches_flax():
    """Objects and OCR tokens, each LN(W feat) + LN(W box) through GELU; the
    OCR features [det | rec | fasttext]; the padding bias from the object
    features and the OCR det features."""
    config = _model_config("ReadableIterativeMCAN").VISION_EMBEDDING
    batch = _numpy_batch(1)
    names = ("region_features", "region_boxes", "ocr_det_features", "ocr_rec_features",
             "ocr_fasttext_features", "ocr_boxes")
    args = [jnp.asarray(batch[n]) for n in names]
    flax_module = jvision.VisionOcrEmbedding(config)
    params = _numpy_params(lambda r: flax_module.init(r, *args), seed=2)
    state = {}
    convert._vision_ocr_embedding(state, "m", params)
    port = vision_embeddings.VisionOcrEmbedding(config)
    port.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in state.items()})
    want, want_bias = flax_module.apply({"params": params}, *args)
    got, got_bias = port.eval()(*(_t(batch[n]) for n in names))
    assert got.shape == (3, REGIONS + OCR, D)
    _close(got, want, MODULE_TOL)
    np.testing.assert_array_equal(got_bias.numpy(), np.asarray(want_bias))
    assert (got_bias[0, 0, 0, -2:] != 0).all() and (got_bias[1, 0, 0, -2:REGIONS] != 0).all()


def test_text_processor_matches_flax():
    """The final LSTM cell state (not the hidden state) over the whole padded
    question, the padding row of the table read as zero; flax's one LSTM bias
    on torch's hidden bias."""
    config = _model_config("IterativeSAAA").TEXT_PROCESSOR
    vocab, tokens = _Vocab(), _numpy_batch(3)["question_tokens"]
    flax_module = jsaaa.TextProcessor(config, vocab)
    params = _numpy_params(lambda r: flax_module.init(r, jnp.asarray(tokens)), seed=4)
    assert np.abs(np.asarray(params["embedding"][0])).max() > 0  # a nonzero padding row
    state = {"embedding.weight": np.asarray(params["embedding"])}
    convert._lstm(state, "lstm", params["OptimizedLSTMCell_0"])
    port = iterative_saaa.TextProcessor(config, vocab)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    want = flax_module.apply({"params": params}, jnp.asarray(tokens))
    got = port.eval()(_t(tokens))
    assert got.shape == (3, D)
    _close(got, want, MODULE_TOL)


# -- the models -----------------------------------------------------------------------------
ARCHS = ("IterativeSAAA", "ReadableIterativeMCAN")
_PAIRS = {}


def _pair(arch):
    """(flax model, its numpy-drawn params, the port's model with those
    params), kept per module."""
    if arch not in _PAIRS:
        vocab, config = _Vocab(), _model_config(arch)
        flax_model = JAX_ARCHITECTURE.get(arch)(config=config, vocab=vocab)
        batch = _jb(_numpy_batch(0))
        params = _numpy_params(lambda r: flax_model.init(r, batch, train=False), seed=5)
        port = META_ARCHITECTURE.get(arch)(config, vocab)
        port.load_state_dict({k: torch.from_numpy(v)
                              for k, v in params_from_flax(params, config).items()})
        _PAIRS[arch] = (flax_model, params, port.eval())
    return _PAIRS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_logprobs_match_flax(arch):
    flax_model, params, port = _pair(arch)
    batch = _numpy_batch(6)
    want = jax.jit(lambda p, b: flax_model.apply({"params": p}, b))(params, _jb(batch))
    with torch.no_grad():
        got = port({k: _t(v) for k, v in batch.items()})
    assert got.shape == (3, _Vocab.max_answer_length, len(_Vocab()))
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_beam3_generate_matches_jax(arch):
    """Beam-3 generate() against the JAX package's: tokens equal, cumulative
    log-probs within 1e-4."""
    flax_model, params, port = _pair(arch)
    batch = _numpy_batch(7)
    want_tokens, want_logprobs = jdecode.generate(flax_model, {"params": params}, _jb(batch),
                                                  batch_size=3, beam_size=3)
    got_tokens, got_logprobs = decode.generate(port, {k: _t(v) for k, v in batch.items()}, 3)
    np.testing.assert_array_equal(got_tokens.numpy(), np.asarray(want_tokens))
    _close(got_logprobs, want_logprobs, MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_every_flax_tensor(arch):
    """params_from_flax puts every flax tensor in exactly one port tensor (as
    it is, a Dense kernel transposed, or an LSTM's gate kernels stacked) and
    fills every port parameter at its shape; the LSTM's held input bias is
    zero."""
    _, params, port = _pair(arch)
    state = params_from_flax(params)
    assert set(state) == set(port.state_dict())
    for name, tensor in port.state_dict().items():
        assert tuple(tensor.shape) == state[name].shape, name
    leaves = [(jax.tree_util.keystr(p), np.asarray(x))
              for p, x in jax.tree_util.tree_flatten_with_path(params)[0]]
    unused = dict(state)
    if arch == "IterativeSAAA":
        lstm = params["text"]["OptimizedLSTMCell_0"]
        hidden = D
        for key, prefix, width in (("weight_ih_l0", "i", None), ("weight_hh_l0", "h", None)):
            stacked = unused.pop(f"text.lstm.{key}")
            for g, gate in enumerate("ifgo"):
                np.testing.assert_array_equal(stacked[g * hidden:(g + 1) * hidden],
                                              np.asarray(lstm[f"{prefix}{gate}"]["kernel"]).T)
        bias = unused.pop("text.lstm.bias_hh_l0")
        for g, gate in enumerate("ifgo"):
            np.testing.assert_array_equal(bias[g * hidden:(g + 1) * hidden],
                                          np.asarray(lstm[f"h{gate}"]["bias"]))
        assert not unused.pop("text.lstm.bias_ih_l0").any()
        leaves = [(p, x) for p, x in leaves if "OptimizedLSTMCell_0" not in p]
    assert len(leaves) == len(unused)
    for path, leaf in leaves:
        match = next(name for name, value in unused.items()
                     if value.shape in (leaf.shape, leaf.T.shape)
                     and (np.array_equal(value, leaf) or np.array_equal(value, leaf.T)))
        del unused[match]
    assert not unused


def test_readable_round_trip_through_the_jax_converter():
    """``MODEL_CONVERTERS["ReadableIterativeMCAN"]`` is ``convert_iterative_mcan``:
    on the port's state dict it gives back every flax tensor outside the
    vision embedding.  It reads IterativeMCAN's one-linear embedding
    (``vision_embedding.proj``), which VisionOcrEmbedding does not have: fed
    the object-feature linear under that name, it returns that one Dense and
    none of VisionOcrEmbedding's other seven tensors."""
    flax_model, params, port = _pair("ReadableIterativeMCAN")
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    obj = "vision_embedding.linear_obj_feat_to_mmt_in"
    state.update({f"vision_embedding.proj.{p}": state[f"{obj}.{p}"] for p in ("weight", "bias")})
    back = MODEL_CONVERTERS["ReadableIterativeMCAN"](state, flax_model.config)
    assert MODEL_CONVERTERS["ReadableIterativeMCAN"] is MODEL_CONVERTERS["IterativeMCAN"]
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    vision = {p for p in want if jax.tree_util.keystr(p[:1]) == "['vision_embedding']"}
    assert set(want) - set(got) == {
        p for p in vision if jax.tree_util.keystr(p[1:2]) != "['Dense_0']"}
    assert len(vision) == 16 and set(got) - set(want) == set()
    for path, leaf in got.items():
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(want[path]),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_adam_step_matches_jax(arch):
    """One Adam step of the OpenEndedTask loss against the JAX task's, without
    dropout: IterativeSAAA at TrainingSAAATask's constant rate (0.1: an
    effective 0.01), ReadableIterativeMCAN at the noam schedule; the LSTM's
    held input bias unchanged."""
    flax_model, params, port = _pair(arch)
    adam_step_matches_jax(flax_model, params, copy.deepcopy(port), _numpy_batch(8),
                          JaxOpenEndedTask, OpenEndedTask,
                          rate=0.1 if arch == "IterativeSAAA" else None,
                          gradient_free=GRADIENT_FREE)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradient_step_gives_finite_nonzero_grads(arch):
    """The training route at dropout 0.1: every trainable parameter gets a
    finite gradient that is not zero (the analytically gradient-free biases
    only finite); the LSTM's held input bias gets none."""
    vocab, config = _Vocab(), _model_config(arch)
    port = META_ARCHITECTURE.get(arch)(config, vocab)
    port.init_weights_(torch.Generator().manual_seed(0))
    stub = types.SimpleNamespace(model=port.train(), generator=torch.Generator().manual_seed(3),
                                 vocab=vocab)
    loss = OpenEndedTask.compute_loss(stub, {k: _t(v) for k, v in _numpy_batch(9).items()})
    loss.backward()
    assert bool(torch.isfinite(loss))
    for name, p in port.named_parameters():
        if name.endswith(HELD):
            assert p.grad is None and not p.requires_grad, name
            continue
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        assert name.endswith(GRADIENT_FREE) or float(p.grad.abs().max()) > 0.0, name


def test_readable_reads_copy_ids_as_unk():
    """OcrVocab's answers hold copy ids (len(vocab) + OCR slot) that
    ReadableIterativeMCAN's fixed-vocab decoder cannot read or emit: as
    decoder inputs and as OpenEndedTask targets they count as <unk>."""
    _, _, port = _pair("ReadableIterativeMCAN")
    vocab = _Vocab()
    batch = {k: _t(v) for k, v in _numpy_batch(10).items()}
    copied = dict(batch)
    for key in ("answer_tokens", "shifted_right_answer_tokens"):
        copied[key] = batch[key].clone()
        copied[key][:, 2] = len(vocab) + 3
        batch[key] = batch[key].clone()
        batch[key][:, 2] = vocab.unk_idx
    stub = types.SimpleNamespace(model=port, generator=None, vocab=vocab)
    with torch.no_grad():
        _close(port(copied), port(batch), 0.0)
        want = OpenEndedTask.compute_loss(stub, batch)
        got = OpenEndedTask.compute_loss(stub, copied)
    port.eval()
    assert float(got) == float(want) and bool(torch.isfinite(got))


# -- the task and the configs ------------------------------------------------------------------
def _saaa_task_config(paths, tmp_path):
    dataset = {"BATCH_SIZE": 8, "WORKERS": 1, "MAX_REGIONS": 12,
               "FEATURE_PATH": {"FEATURES": paths["features"]}}
    jp = {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["test"]}
    return ConfigNode({
        "TASK": "TrainingSAAATask",
        "DATASET": {
            "FEATURE_DATASET": dict(dataset, TYPE="FeatureDataset"),
            "DICT_DATASET": dict(dataset, TYPE="DictionaryDataset"),
            "VOCAB": {"TYPE": "Vocab", "TOKENIZER": None, "MIN_FREQ": 1, "WORD_EMBEDDING": None,
                      "WORD_EMBEDDING_CACHE": None, "PAD_TOKEN": "<pad>", "BOS_TOKEN": "<bos>",
                      "EOS_TOKEN": "<eos>", "UNK_TOKEN": "<unk>", "JSON_PATH": jp},
            "JSON_PATH": jp,
        },
        "TRAINING": {"CHECKPOINT_PATH": str(tmp_path / "saved_models"), "LEARNING_RATE": 0.1,
                     "WARMUP": 100, "SCORE": "CIDEr", "TRAINING_BEAM_SIZE": 3,
                     "EVALUATING_BEAM_SIZE": 3, "PATIENCE": 2, "MAX_EPOCHS": 2, "SEED": 11},
        "MODEL": _model_config("IterativeSAAA").to_dict(),
    })


def test_training_saaa_task_end_to_end(synthetic_data, tmp_path):
    """IterativeSAAA under TrainingSAAATask: the constant LambdaLR rate
    (LEARNING_RATE^2 in effect, as LambdaLR over Adam at LEARNING_RATE
    gives), two XE epochs with the beam-3 dev eval, checkpoints,
    get_predictions() and test_results.json; the region width is the
    store's."""
    config = _saaa_task_config(synthetic_data, tmp_path)
    task = builders.build_task(config, "cpu")
    assert type(task).__name__ == "TrainingSAAATask"
    assert task.model.vision.proj.in_features == 1024
    assert task.optimizer.param_groups[0]["lr"] == pytest.approx(0.01)
    task.start()
    assert task.optimizer.param_groups[0]["lr"] == pytest.approx(0.01)
    ckpt_dir = os.path.join(config.TRAINING.CHECKPOINT_PATH, config.MODEL.NAME)
    for name in ("best_model.pth", "last_model.pth", "vocab.bin"):
        assert os.path.isfile(os.path.join(ckpt_dir, name)), name
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as handle:
        records = [json.loads(line) for line in handle]
    train = [r for r in records if r["phase"] == "train"]
    assert len(train) == 2 and all(np.isfinite(r["step_losses"]).all() for r in train)
    scores = task.get_predictions()
    assert np.isfinite(scores["CIDEr"])
    with open(os.path.join(ckpt_dir, "test_results.json")) as handle:
        assert len(json.load(handle)["results"]) > 0


CONFIGS = {"iterative_saaa.yaml": ("IterativeSAAA", "TrainingSAAATask"),
           "readable_iterative_mcan.yaml": ("ReadableIterativeMCAN", "OpenEndedTask")}


@pytest.mark.parametrize("config_file", sorted(CONFIGS))
def test_config_builds_at_its_full_widths_with_flax_parameter_count(synthetic_data, tmp_path,
                                                                    config_file):
    """Each YAML through the port's build_task on the synthetic set (the OCR
    store for ReadableIterativeMCAN: 1024-wide objects, 256 + 256 + 300 OCR
    columns, as flax infers them): its task and architecture at d_model 512, 8
    heads of 64, one teacher-forced loss over a batch, and as many trainable
    parameters as flax's init of the same MODEL node on that batch."""
    arch, task_name = CONFIGS[config_file]
    jp = {"TRAIN": synthetic_data["train"], "DEV": synthetic_data["dev"],
          "TEST": synthetic_data["test"]}
    dataset = {"BATCH_SIZE": 3, "WORKERS": 1, "WORD_EMBEDDING": None,
               "FEATURE_PATH": {"FEATURES": synthetic_data["features"],
                                "SCENE_TEXT": synthetic_data["scene_text"]}}
    config = get_config(os.path.join(ROOT, "configs", config_file)).merged({
        "DATASET": {"FEATURE_DATASET": dataset, "DICT_DATASET": dataset, "JSON_PATH": jp,
                    "VOCAB": {"JSON_PATH": jp}},
        "TRAINING": {"CHECKPOINT_PATH": str(tmp_path / "saved_models")},
    })
    assert META_TASK.get(config.TASK) is not None
    task = builders.build_task(config, "cpu")
    model = task.model
    assert type(task).__name__ == task_name and type(model).__name__ == arch
    core = model.decoder.layers[0].self_attn.attention
    assert (core.d_model, core.h, core.d_k) == (512, 8, 64)
    host, batch = next(task.device_batches(task.train_dataloader))
    with torch.no_grad():
        assert bool(torch.isfinite(task.compute_loss(batch)))
    arrays = {k: jnp.asarray(v) for k, v in host.arrays().items()}
    flax_model = JAX_ARCHITECTURE.get(arch)(config=config.MODEL, vocab=task.vocab)
    shapes = jax.eval_shape(lambda r: flax_model.init(r, arrays, train=False),
                            jax.random.PRNGKey(0))["params"]
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters() if p.requires_grad) == want
    if arch == "ReadableIterativeMCAN":
        ocr = model.vision_embedding.linear_ocr_feat_to_mmt_in
        assert ocr.in_features == 256 + 256 + 300
        assert model.vision_embedding.linear_obj_feat_to_mmt_in.in_features == 1024
    rebuilt = build_model(config.MODEL, task.vocab, task.train_dataset[0])
    assert sum(p.numel() for p in rebuilt.parameters()) == sum(
        p.numel() for p in model.parameters())
