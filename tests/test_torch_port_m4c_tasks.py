"""The tasks and host data of the rest of the M4C family on the CPU: the
standalone M4C under TrainingMMF, IterativeM4C under OcrOpenEndedTask, MMF_LoRRA
under MmfClassificationTask, with OcrClassificationVocab and
OcrClassificationDataset.

Host data: the port's OCR classification vocab and dataset give the JAX
package's arrays batch for batch, and encode an OCR-only answer, or refuse an
unknown one, as it does.  OcrOpenEndedTask decodes (n, k, T) beam samples
against each sample's OCR table as the JAX task does.  One Adam step of M4C
(TrainingMMF, the noam schedule) and of MMF_LoRRA (MmfClassificationTask, BCE,
the constant schedule) against the JAX tasks' ``_train_step`` on the same
bridged weights and batch, every dropout rate 0: loss within rtol 1e-5, every
weight within 1e-3 x lr.  Each task runs ``start()`` and ``get_predictions()``
end to end at hidden 32, and each of the six configs is built through the
port's registries at its own widths, its depth cut to one layer.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvivqa_tpu.data  # noqa: F401  (registers the JAX package's datasets)
from openvivqa_tpu import builders as jax_builders
from openvivqa_tpu.config import ConfigNode as JaxConfigNode
from openvivqa_tpu.data.loader import DataLoader as JaxDataLoader
from openvivqa_tpu.training import optim as joptim
from openvivqa_tpu.training.tasks.ocr_tasks import MmfClassificationTask as JaxMmfClassification
from openvivqa_tpu.training.tasks.ocr_tasks import OcrOpenEndedTask as JaxOcrOpenEndedTask
from openvivqa_tpu.training.tasks.ocr_tasks import TrainingMMF as JaxTrainingMMF
from openvivqa_tpu.training.train_state import TrainState
from openvivqa_tpu_torch import builders
from openvivqa_tpu_torch.builders import build_task
from openvivqa_tpu_torch.config import ConfigNode, get_config
from openvivqa_tpu_torch.data.loader import DataLoader
from openvivqa_tpu_torch.models.convert import params_from_flax
from openvivqa_tpu_torch.training.tasks.ocr_tasks import OcrOpenEndedTask

jax_builders.populate()
builders.populate()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, HEADS, K = 32, 4, 8
# see tests/test_torch_port_classification.py: an element whose gradient lies
# within a few orders of Adam's 1e-8 is held to the step's own bound, lr
NEAR_EPS = 1e-6
GRADIENT_FREE = ("fc_k.bias", "self.key.bias")


def _vocab_config(paths, kind="OcrVocab"):
    return {
        "TYPE": kind, "TOKENIZER": None, "MIN_FREQ": 1, "WORD_EMBEDDING": None,
        "MAX_SCENE_TEXT": K,
        "PAD_TOKEN": "<pad>", "BOS_TOKEN": "<bos>", "EOS_TOKEN": "<eos>", "UNK_TOKEN": "<unk>",
        "IMG_TOKEN": "<img>", "FEAT_TOKEN": "<feat>", "BOX_TOKEN": "<box>", "OCR_TOKEN": "<ocr>",
        "OCR_DET_TOKEN": "<ocr_det>", "OCR_REC_TOKEN": "<ocr_rec>",
        "QUESTION_TOKEN": "<question>", "ANSWER_TOKEN": "<answer>",
        "JSON_PATH": {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["test"]},
    }


def _dataset_config(paths, kind, batch_size=8):
    return {"TYPE": kind, "BATCH_SIZE": batch_size, "WORKERS": 1, "MAX_SCENE_TEXT": K,
            "SCENE_TEXT_THRESHOLD": 0.3, "WORD_EMBEDDING": None,
            "FEATURE_PATH": {"FEATURES": paths["features"], "SCENE_TEXT": paths["scene_text"]}}


# -- host data ----------------------------------------------------------------------------------
@pytest.mark.parametrize("split,shuffle", [("train", True), ("test", False)])
def test_ocr_classification_loader_matches_the_jax_package(synthetic_data, split, shuffle):
    vocab_config = ConfigNode(_vocab_config(synthetic_data, "OcrClassificationVocab"))
    ours = builders.build_vocab(vocab_config)
    theirs = jax_builders.build_vocab(JaxConfigNode(vocab_config.to_dict()))
    assert ours.itoa == theirs.itoa and ours.num_choices == theirs.num_choices
    config = _dataset_config(synthetic_data, "OcrClassificationDataset")

    def epoch(build, loader_class, vocab, node):
        dataset = build(synthetic_data[split], vocab, node(config))
        return list(loader_class(dataset, batch_size=8, shuffle=shuffle, seed=3, num_workers=1))

    got = epoch(builders.build_dataset, DataLoader, ours, ConfigNode)
    want = epoch(jax_builders.build_dataset, JaxDataLoader, theirs, JaxConfigNode)
    assert len(got) == len(want) >= 1
    for batch, expected in zip(got, want):
        arrays, expected_arrays = batch.arrays(), expected.arrays()
        assert sorted(arrays) == sorted(expected_arrays)
        for key, value in expected_arrays.items():
            np.testing.assert_array_equal(arrays[key], value, err_msg=key)
        assert batch.host_fields() == expected.host_fields()


def test_ocr_classification_vocab_encodes_and_decodes_as_the_jax_package(synthetic_data):
    """A class answer, an OCR-only answer (its first matching slot), and an
    answer that is neither (a KeyError on both sides); decoding reads an OCR
    slot from the sample's table and a slot past it as the padding token."""
    vocab_config = _vocab_config(synthetic_data, "OcrClassificationVocab")
    ours = builders.build_vocab(ConfigNode(vocab_config))
    theirs = jax_builders.build_vocab(JaxConfigNode(vocab_config))
    answer = ours.itoa[2].split()
    ocr = ["xa", "lộ", "xa lộ", "lộ"]
    for vocab in (ours, theirs):
        assert vocab.encode_answer(answer, ocr).tolist() == [2]
        assert vocab.encode_answer(["lộ"], ocr).tolist() == [vocab.total_answers + 1]
        with pytest.raises(KeyError):
            vocab.encode_answer(["không", "có"], ocr)
    ids = np.array([2, ours.total_answers + 2, ours.total_answers + 5])
    tables = [ocr, ocr, ocr[:2]]
    assert ours.decode_answer(ids, tables) == theirs.decode_answer(ids, tables)
    assert ours.decode_answer(ids, tables, join_word=False) == theirs.decode_answer(
        ids, tables, join_word=False)


def test_ocr_open_ended_task_decodes_beam_samples_per_sample(synthetic_data):
    """(n, k, T) beam samples: row r of the flattening decodes against sample
    r // k's OCR table, as the JAX task does; (bs, T) ids row by row."""
    vocab_config = _vocab_config(synthetic_data)
    ours = builders.build_vocab(ConfigNode(vocab_config))
    theirs = jax_builders.build_vocab(JaxConfigNode(vocab_config))
    port_task = object.__new__(OcrOpenEndedTask)
    port_task.vocab = ours
    jax_task = types.SimpleNamespace(vocab=theirs)
    base = len(ours.itos)
    tables = [["mèo", "đỏ", "xe"], ["chó", "hoa", "<pad>"]]
    rng = np.random.default_rng(0)
    outs = rng.integers(4, base + 3, size=(2, 3, ours.max_answer_length))
    outs[0, :, 1] = base  # each sample's first OCR token
    batch = {"ocr_tokens": tables}
    got = port_task._decode_batch(outs, batch)
    assert got == JaxOcrOpenEndedTask._decode_batch(jax_task, outs, batch)
    assert len(got) == 6 and all("mèo" in answer for answer in got[:3])
    flat = outs[:, 0]
    assert port_task._decode_batch(flat, batch) == JaxOcrOpenEndedTask._decode_batch(
        jax_task, flat, batch)


# -- the tasks ----------------------------------------------------------------------------------
def _task_config(paths, tmp_path, task, model, feature_type, vocab_type="OcrVocab",
                 dict_type="OcrDictionaryDataset", **training):
    jp = {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["test"]}
    dataset = {"FEATURE_DATASET": _dataset_config(paths, feature_type),
               "VOCAB": _vocab_config(paths, vocab_type), "JSON_PATH": jp}
    if dict_type:
        dataset["DICT_DATASET"] = _dataset_config(paths, dict_type, batch_size=6)
    return ConfigNode({
        "TASK": task, "DATASET": dataset, "MODEL": model,
        "TRAINING": {
            "CHECKPOINT_PATH": str(tmp_path / "saved_models"), "LEARNING_RATE": 1.0,
            "WARMUP": 100, "SCORE": "CIDEr", "TRAINING_BEAM_SIZE": 2, "EVALUATING_BEAM_SIZE": 2,
            "PATIENCE": 2, "MAX_EPOCHS": 1, "SEED": 5, **training,
        },
    })


def _m4c(dropout=0.1):
    attention = {"ARCHITECTURE": "ScaledDotProductAttention", "HEAD": HEADS, "D_MODEL": D,
                 "D_KEY": D // HEADS, "D_VALUE": D // HEADS, "D_FF": 2 * D, "USE_AOA": False,
                 "CAN_BE_STATEFUL": False, "DROPOUT": dropout}
    return {"NAME": "m4c_port_test", "ARCHITECTURE": "M4C", "D_MODEL": D,
            "MMT": {"HIDDEN_SIZE": D, "NUM_ATTENTION_HEADS": HEADS, "NUM_HIDDEN_LAYERS": 1},
            "TEXT_BERT": {"HIDDEN_SIZE": D, "NUM_HIDDEN_LAYERS": 1, "INTERMEDIATE_SIZE": 64},
            "ENCODER": {"ARCHITECTURE": "MultiModalEncoder", "LAYERS": 2, "INTERMEDIATE_SIZE": 64,
                        "SELF_ATTENTION": attention},
            "DYNAMIC_EMBEDDING": {"ARCHITECTURE": "FixedVocabDynamicEmbedding", "D_MODEL": D},
            "OBJECT_EMBEDDING": {"D_FEATURE": 1024, "DROPOUT": dropout},
            "OCR_EMBEDDING": {"D_FEATURE": 256 + 256 + 300, "DROPOUT": dropout}}


def _lorra(dropout=0.1):
    branch = {"HEAD": 1, "D_KEY": 8, "D_VALUE": 8, "D_MODEL": D}
    return {"NAME": "lorra_port_test", "ARCHITECTURE": "MMF_LoRRA", "D_MODEL": D,
            "MAX_SCENE_TEXT": K,
            "TEXT_EMBEDDING": {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": D, "D_EMBEDDING": 16,
                               "DROPOUT": dropout, "WORD_EMBEDDING": None},
            "OBJECT_EMBEDDING": {"D_FEATURE": 1024, "DROPOUT": dropout},
            "OCR_EMBEDDING": {"D_FEATURE": 300, "DROPOUT": dropout},
            "SELF_ATTENTION": branch, "SPATIAL_ATTENTION": branch, "CONTEXT_ATTENTION": branch}


def _iterative_m4c():
    def features(width):
        return {"ARCHITECTURE": "FeatureEmbedding", "D_FEATURE": width, "D_MODEL": D,
                "DROPOUT": 0.1}

    attention = {"ARCHITECTURE": "ScaledDotProductAttention", "HEAD": HEADS, "D_MODEL": D,
                 "D_KEY": D // HEADS, "D_VALUE": D // HEADS, "D_FF": 2 * D, "USE_AOA": False,
                 "CAN_BE_STATEFUL": False, "DROPOUT": 0.1}
    return {"NAME": "iterative_m4c_port_test", "ARCHITECTURE": "M4C", "D_MODEL": D,
            "REGION_EMBEDDING": features(1024), "GRID_EMBEDDING": features(2048),
            "BOX_EMBEDDING": features(4), "OCR_DET_EMBEDDING": features(256),
            "OCR_REC_EMBEDDING": features(256),
            "TEXT_EMBEDDING": {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": D, "D_EMBEDDING": 16,
                               "DROPOUT": 0.1, "WORD_EMBEDDING": None},
            "OCR_TEXT_EMBEDDING": {"ARCHITECTURE": "OcrWordEmbedding", "D_MODEL": D,
                                   "D_EMBEDDING": 300, "DROPOUT": 0.1},
            "DYNAMIC_EMBEDDING": {"ARCHITECTURE": "DynamicEmbedding", "D_MODEL": D},
            "ENCODER": {"ARCHITECTURE": "MultiModalEncoder", "D_MODEL": D, "LAYERS": 1,
                        "SELF_ATTENTION": attention}}


def _no_dropout(task):
    for module in task.model.modules():
        if isinstance(getattr(module, "dropout", None), float):
            module.dropout = 0.0


def _check_adam_step(task, params, new_params, lr):
    """Every weight after the first Adam step against the JAX package's."""
    before = params_from_flax(params)
    want = params_from_flax(jax.tree.map(np.asarray, new_params))
    grads = {name: p.grad for name, p in task.model.named_parameters()}
    for name, tensor in task.model.state_dict().items():
        got = tensor.numpy()
        if grads.get(name) is None:  # no gradient on either side: unchanged
            np.testing.assert_array_equal(got, before[name], err_msg=name)
            np.testing.assert_array_equal(want[name], before[name], err_msg=name)
            continue
        small = (np.ones_like(got, bool) if name.endswith(GRADIENT_FREE)
                 else grads[name].abs().numpy() < NEAR_EPS)
        for after in (got, want[name]):
            assert np.abs(after - before[name])[small].max(initial=0.0) <= 1.01 * lr, name
        np.testing.assert_allclose(got[~small], want[name][~small], atol=1e-3 * lr, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["M4C", "MMF_LoRRA"])
def test_adam_step_matches_the_jax_task(synthetic_data, tmp_path, kind):
    """One step of the port's task against the JAX task's _train_step on the
    same bridged weights and batch (dropout 0; the JAX forward with
    train=False is then the same function)."""
    if kind == "M4C":
        config = _task_config(synthetic_data, tmp_path, "TrainingMMF", _m4c(0.0),
                              "OcrFeatureDataset")
        jax_task, schedule = JaxTrainingMMF, joptim.noam_schedule(1.0, D, 100)
    else:
        config = _task_config(synthetic_data, tmp_path, "MmfClassificationTask", _lorra(0.0),
                              "OcrClassificationDataset", "OcrClassificationVocab", None,
                              LEARNING_RATE=0.1)
        jax_task, schedule = JaxMmfClassification, joptim.constant_lambda_schedule(0.1)
    task = build_task(config, "cpu")
    _no_dropout(task)
    host = next(iter(task.train_dataloader))
    jax_batch = {key: jnp.asarray(value) for key, value in host.arrays().items()}
    jax_model = jax_builders.META_ARCHITECTURE.get(config.MODEL.ARCHITECTURE)(
        JaxConfigNode(config.MODEL.to_dict()), task.vocab)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda r, b: jax_model.init({"params": r, "dropout": r}, b, train=False))(
        jax.random.PRNGKey(0), jax_batch)["params"])
    task.model.load_state_dict({k: torch.from_numpy(v) for k, v in params_from_flax(params).items()})

    state = TrainState.create(lambda v, b, train, rngs: jax_model.apply(v, b, train=False),
                              jax.tree.map(jnp.asarray, params), {},
                              joptim.make_optimizer(schedule))
    stub = types.SimpleNamespace(vocab=task.vocab, maybe_remat=lambda fn: fn)
    new_state, jax_loss = jax.jit(lambda s, b, r: jax_task._train_step(stub, s, b, r))(
        state, jax_batch, jax.random.PRNGKey(1))
    loss = task._train_step(task.put_batch(host))
    assert float(loss) == pytest.approx(float(jax_loss), rel=1e-5)
    _check_adam_step(task, params, new_state.params, float(schedule(0)))


@pytest.mark.parametrize("kind", ["M4C", "IterativeM4C", "MMF_LoRRA"])
def test_task_end_to_end(synthetic_data, tmp_path, kind):
    """start() for one epoch (checkpoints, the dev eval: greedy for M4C, beam 2
    for IterativeM4C, argmax for LoRRA), then get_predictions() from
    best_model.pth and test_results.json."""
    if kind == "M4C":
        config = _task_config(synthetic_data, tmp_path, "TrainingM4C", _m4c(),
                              "OcrFeatureDataset")
    elif kind == "IterativeM4C":
        config = _task_config(synthetic_data, tmp_path, "OcrOpenEndedTask", _iterative_m4c(),
                              "OcrFeatureDataset")
    else:
        config = _task_config(synthetic_data, tmp_path, "MmfClassificationTask", _lorra(),
                              "OcrClassificationDataset", "OcrClassificationVocab", None,
                              LEARNING_RATE=0.1)
    task = build_task(config, "cpu")
    assert type(task.model).__name__ == kind
    task.start()
    ckpt_dir = os.path.join(config.TRAINING.CHECKPOINT_PATH, config.MODEL.NAME)
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as handle:
        records = [json.loads(line) for line in handle]
    losses = [x for r in records if r["phase"] == "train" for x in r["step_losses"]]
    assert losses and all(np.isfinite(losses))
    assert os.path.isfile(os.path.join(ckpt_dir, "best_model.pth"))
    scores = task.get_predictions()
    assert np.isfinite(scores["CIDEr"])
    with open(os.path.join(ckpt_dir, "test_results.json")) as handle:
        assert len(json.load(handle)["results"]) > 0


# -- the six configs ---------------------------------------------------------------------------
CONFIGS = {
    "m4c.yaml": ("TrainingMMF", "M4C"),
    "iterative_m4c.yaml": ("OcrOpenEndedTask", "IterativeM4C"),
    "small_mmf_improved_decoding_m4c.yaml": ("TrainingMMF", "MMF_ImprovedDecodingM4C"),
    "experimental_mmf_m4c.yaml": ("TrainingMMF", "experimental_MMF_M4C"),
    "mmf_lorra.yaml": ("MmfClassificationTask", "MMF_LoRRA"),
    "mmf_iterative_lorra.yaml": ("TrainingMMF", "MMF_IterativeLoRRA"),
}


def _one_layer(node):
    if not isinstance(node, dict):
        return node
    return {k: 1 if k in ("LAYERS", "NUM_HIDDEN_LAYERS") else _one_layer(v)
            for k, v in node.items()}


@pytest.mark.parametrize("config_file", sorted(CONFIGS))
def test_config_builds_and_runs_in_the_ports_registries(synthetic_data, tmp_path, config_file):
    """Each config at its own widths, one layer deep, on the synthetic data:
    the task and architecture its names give, and one eval forward of finite
    outputs of the expected shape on a train batch."""
    task_name, arch = CONFIGS[config_file]
    jp = {"TRAIN": synthetic_data["train"], "DEV": synthetic_data["dev"],
          "TEST": synthetic_data["test"]}
    features = {"WORD_EMBEDDING": None, "FEATURE_PATH": {
        "FEATURES": synthetic_data["features"], "SCENE_TEXT": synthetic_data["scene_text"]}}
    base = get_config(os.path.join(ROOT, "configs", config_file))
    model = _one_layer(base.MODEL.to_dict())
    dataset = {"FEATURE_DATASET": features, "JSON_PATH": jp, "VOCAB": {"JSON_PATH": jp}}
    if "DICT_DATASET" in base.DATASET:
        dataset["DICT_DATASET"] = features
    config = base.merged({
        "DATASET": dataset, "MODEL": model,
        "TRAINING": {"CHECKPOINT_PATH": str(tmp_path / "saved_models")},
    })
    task = build_task(config, "cpu")
    assert type(task).__name__ == task_name and type(task.model).__name__ == arch
    assert task.model.training is False
    batch = task.put_batch(next(iter(task.train_dataloader)))
    bs = batch["question_tokens"].shape[0]
    with torch.no_grad():
        out = task.model(batch)
    if arch == "MMF_LoRRA":
        want = (bs, task.vocab.total_answers + config.MODEL.MAX_SCENE_TEXT)
        out = out["scores"]
    else:
        out = out if arch == "IterativeM4C" else out["scores"]
        want = (bs, task.vocab.max_answer_length,
                len(task.vocab) + batch["ocr_det_features"].shape[1])
    assert tuple(out.shape) == want and bool(torch.isfinite(out).all())
    # the stream widths come from the data, as flax infers them, whatever the
    # config says (experimental_mmf_m4c.yaml names 1024 for its 812-wide OCR input)
    ocr_width = sum(batch[key].shape[-1] for key in (
        ("ocr_fasttext_features",) if "LoRRA" in arch else
        ("ocr_fasttext_features", "ocr_rec_features", "ocr_det_features")))
    if arch != "IterativeM4C":
        assert task.model.linear_ocr_feat_to_mmt_in.in_features == ocr_width
        assert task.model.linear_obj_feat_to_mmt_in.in_features == \
            batch["region_features"].shape[-1]
    if arch == "M4C":  # BertConfig's default intermediate size in both stacks
        assert task.model.encoder.layer[0].intermediate.dense.out_features == 3072
        assert task.model.question_encoder.layer[0].intermediate.dense.out_features == 3072
