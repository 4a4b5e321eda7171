"""The port's JointTransformer slice (configs/joint_transformer_vlsp.yaml under
VlspEvjVqaTask) on the CPU against the JAX package, at small sizes.

The multimodal vocabs and the multilingual feature datasets are held against the
JAX copies on one synthetic EVJVQA set with its VinVL-shaped feature store; a
small JointTransformer (width 32, 2 heads, 2 encoder and 2 decoder layers; 24-,
20- and 4-wide region, grid and box features) against the flax model on bridged
weights: the bridge round trip through ``convert_joint_transformer``,
teacher-forced log-probs, beam-3 ``generate()`` on the layer route and on the
module route (whose attention is the flat attention's plain version here), and
one Adam step; then a gradient step and the task end to end.  Float32 on both
sides: log-probs within 1e-4, tokens equal, the loss within rtol 1e-5.
"""

import inspect
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvivqa_tpu import builders as jax_builders
from openvivqa_tpu.data.loader import DataLoader as JaxDataLoader
from openvivqa_tpu.models.joint_transformer import JointTransformer as JaxJointTransformer
from openvivqa_tpu.models.modules import torch_conversion
from openvivqa_tpu.training import decode as jdecode
from openvivqa_tpu.training import optim as joptim
from openvivqa_tpu.training.tasks.open_ended_task import OpenEndedTask as JaxOpenEndedTask
from openvivqa_tpu.training.train_state import TrainState
from openvivqa_tpu_torch import builders, train
from openvivqa_tpu_torch.config import ConfigNode, get_config
from openvivqa_tpu_torch.data import synthetic
from openvivqa_tpu_torch.data.loader import DataLoader
from openvivqa_tpu_torch.models.convert import params_from_flax
from openvivqa_tpu_torch.training import decode

jax_builders.populate()
builders.populate()

D = 32
# the synthetic VinVL store's widths; regions and grids cut by MAX_REGIONS / MAX_GRIDS
REGIONS, D_REGION, GRIDS, D_GRID = 12, 2048, 9, 1024
GRADIENT_FREE = "fc_k.bias"  # softmax(q . (k + b)) does not depend on b
SPECIALS = {"IMG_TOKEN": "<img>", "FEAT_TOKEN": "<feat>", "BOX_TOKEN": "<box>",
            "QUESTION_TOKEN": "<question>", "ANSWER_TOKEN": "<answer>"}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=1e-5, rtol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def evjvqa(tmp_path_factory):
    return synthetic.generate_evjvqa_dataset(
        str(tmp_path_factory.mktemp("evjvqa_features")), n_images=8, n_questions_per_image=3,
        ja_share=0.4, seed=3)


def _vocab_config(paths, kind="VlspVqaMultiModalVocab"):
    return ConfigNode({
        "TYPE": kind, "TOKENIZER": None, "MIN_FREQ": 1, "WORD_EMBEDDING": None,
        "WORD_EMBEDDING_CACHE": None, "PAD_TOKEN": "<pad>", "BOS_TOKEN": "<bos>",
        "EOS_TOKEN": "<eos>", "UNK_TOKEN": "<unk>", **SPECIALS,
        "JSON_PATH": {"TRAIN": paths["train"], "DEV": paths["dev"],
                      "TEST": paths.get("public_test", paths.get("test"))},
    })


def _assert_same_vocab(ours, theirs, annotations_path):
    assert ours.itos == theirs.itos and ours.stoi == theirs.stoi
    for name in ("padding_idx", "bos_idx", "eos_idx", "unk_idx", "img_idx", "feat_idx",
                 "box_idx", "question_idx", "answer_idx", "max_question_length",
                 "max_answer_length"):
        assert getattr(ours, name) == getattr(theirs, name), name
    with open(annotations_path) as handle:
        annotations = json.load(handle)["annotations"]
    for ann in annotations:
        words = ann["question"].split()
        np.testing.assert_array_equal(ours.encode_question(words), theirs.encode_question(words))
        answer = ann["answers"][0].split()
        np.testing.assert_array_equal(ours.encode_answer(answer), theirs.encode_answer(answer))


def test_vlsp_multimodal_vocab_matches_the_jax_package(evjvqa):
    """VlspVqaMultiModalVocab: train + dev only, the modality specials after
    pad/bos/eos/unk, Japanese by character."""
    ours = builders.build_vocab(_vocab_config(evjvqa))
    theirs = jax_builders.build_vocab(_vocab_config(evjvqa))
    assert [ours.itos[i] for i in range(4, 9)] == [
        "<img>", "<feat>", "<box>", "<question>", "<answer>"]
    assert any(len(word) == 1 and not word.isascii() for word in ours.stoi)  # Japanese chars
    _assert_same_vocab(ours, theirs, evjvqa["public_test"])


@pytest.mark.parametrize("layout", ["VOCAB node", "whole config"])
def test_multimodal_vocab_reads_either_layout(synthetic_data, layout):
    """MultiModalVocab reads its token names from the VOCAB node or from a
    config holding a VOCAB section, as the JAX package's does."""
    config = _vocab_config(synthetic_data, "MultiModalVocab")
    if layout == "whole config":
        config = ConfigNode({"TYPE": "MultiModalVocab", "VOCAB": config.to_dict()})
    ours = builders.build_vocab(config)
    theirs = jax_builders.build_vocab(config)
    assert [ours.itos[i] for i in range(9)] == [
        "<pad>", "<bos>", "<eos>", "<unk>", "<img>", "<feat>", "<box>", "<question>", "<answer>"]
    _assert_same_vocab(ours, theirs, synthetic_data["dev"])


def _dataset_config(paths, kind, batch_size=4):
    return ConfigNode({"TYPE": kind, "BATCH_SIZE": batch_size, "WORKERS": 1,
                       "MAX_REGIONS": REGIONS, "MAX_GRIDS": GRIDS,
                       "FEATURE_PATH": {"FEATURES": paths["features"], "IMAGE": None,
                                        "SCENE_TEXT": None}})


@pytest.mark.parametrize("kind,split,shuffle", [
    ("MultilingualFeatureDataset", "train", True),
    ("MultilingualDictionaryDataset", "dev", False),
    ("MultilingualDictionaryDataset", "private_test", False),
])
def test_feature_datasets_match_the_jax_package(evjvqa, kind, split, shuffle):
    """Loader batches of both packages on the EVJVQA feature store: the
    region, grid and box streams, token arrays and host fields batch for
    batch; regions and grids cut to MAX_REGIONS and MAX_GRIDS."""
    ours_vocab = builders.build_vocab(_vocab_config(evjvqa))
    theirs_vocab = jax_builders.build_vocab(_vocab_config(evjvqa))
    config = _dataset_config(evjvqa, kind)
    got = list(DataLoader(builders.build_dataset(evjvqa[split], ours_vocab, config),
                          batch_size=4, shuffle=shuffle, seed=3, num_workers=1))
    want = list(JaxDataLoader(jax_builders.build_dataset(evjvqa[split], theirs_vocab, config),
                              batch_size=4, shuffle=shuffle, seed=3, num_workers=1))
    assert len(got) == len(want) >= 1
    for batch, expected in zip(got, want):
        assert sorted(batch.arrays()) == sorted(expected.arrays())
        for key, value in expected.arrays().items():
            np.testing.assert_array_equal(batch.arrays()[key], value, err_msg=key)
        assert batch.host_fields() == expected.host_fields()
    arrays = got[0].arrays()
    assert arrays["region_features"].shape == (4, REGIONS, D_REGION)
    assert arrays["region_boxes"].shape == (4, REGIONS, 4)
    assert arrays["grid_features"].shape == (4, GRIDS, D_GRID)
    assert arrays["grid_boxes"].shape == (4, GRIDS, 4)


def test_evjvqa_feature_store_is_vinvl_shaped(evjvqa):
    """Per image 75-100 regions x 2048 and 49 grids x 1024 with their boxes
    (configs/joint_transformer_vlsp.yaml's feature widths)."""
    for name in sorted(os.listdir(evjvqa["features"])):
        store = np.load(os.path.join(evjvqa["features"], name), allow_pickle=True)[()]
        regions = store["region_features"].shape[0]
        assert 75 <= regions <= 100 and store["region_features"].shape[1] == 2048
        assert store["region_boxes"].shape == (regions, 4)
        assert store["grid_features"].shape == (49, 1024) and store["grid_boxes"].shape == (49, 4)
        boxes = store["region_boxes"]
        assert ((0 <= boxes) & (boxes <= 1.01)).all() and (boxes[:, 2:] > boxes[:, :2]).all()


# -- the model ------------------------------------------------------------------------------
class _Vocab:
    padding_idx, bos_idx, eos_idx, unk_idx = 0, 1, 2, 3
    img_idx, feat_idx, box_idx, question_idx, answer_idx = 4, 5, 6, 7, 8
    max_question_length = 9
    max_answer_length = 6
    word_embeddings = None

    def __len__(self):
        return 40


def _attention(stateful=False, dropout=0.1):
    return {"ARCHITECTURE": "ScaledDotProductAttention", "HEAD": 2, "D_MODEL": D, "D_KEY": D // 2,
            "D_VALUE": D // 2, "D_FF": 2 * D, "USE_AOA": False, "CAN_BE_STATEFUL": stateful,
            "DROPOUT": dropout}


def _model_config(dropout=0.1):
    def features(width):
        return {"ARCHITECTURE": "FeatureEmbedding", "D_FEATURE": width, "D_MODEL": D,
                "DROPOUT": dropout}

    text = {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": D, "D_EMBEDDING": D,
            "DROPOUT": dropout, "WORD_EMBEDDING": None}
    return ConfigNode({
        "NAME": "joint_transformer_port_test", "ARCHITECTURE": "JointTransformer", "D_MODEL": D,
        "DROPOUT": dropout, "REGION_EMBEDDING": features(D_REGION),
        "GRID_EMBEDDING": features(D_GRID), "BOX_EMBEDDING": features(4), "TEXT_EMBEDDING": text,
        "ENCODER": {"ARCHITECTURE": "Encoder", "D_MODEL": D, "LAYERS": 2,
                    "SELF_ATTENTION": _attention(False, dropout)},
        "DECODER": {
            "ARCHITECTURE": "Decoder", "D_MODEL": D, "LAYERS": 2,
            "ATTENTION": {"SELF_ATTENTION": _attention(True, dropout),
                          "ENC_ATTENTION": _attention(False, dropout)},
            "TEXT_EMBEDDING": text,
        },
    })


def _numpy_batch(seed, bs, vocab):
    """Feature streams with zero (padding) rows in sample 1, padded question
    and answer tails."""
    rng = np.random.default_rng(seed)
    batch = {
        "region_features": rng.normal(size=(bs, REGIONS, D_REGION)).astype(np.float32),
        "region_boxes": rng.uniform(size=(bs, REGIONS, 4)).astype(np.float32),
        "grid_features": rng.normal(size=(bs, GRIDS, D_GRID)).astype(np.float32),
        "grid_boxes": rng.uniform(size=(bs, GRIDS, 4)).astype(np.float32),
    }
    batch["region_features"][1, -4:] = 0.0
    batch["region_boxes"][1, -4:] = 0.0
    questions = rng.integers(9, len(vocab), size=(bs, vocab.max_question_length)).astype(np.int32)
    questions[1, -4:] = vocab.padding_idx
    answers = rng.integers(9, len(vocab), size=(bs, vocab.max_answer_length)).astype(np.int32)
    answers[:, 0] = vocab.bos_idx
    answers[0, -2:] = vocab.padding_idx
    shifted = np.concatenate([answers[:, 1:], np.zeros((bs, 1), np.int32)], axis=1)
    return dict(batch, question_tokens=questions, answer_tokens=answers,
                shifted_right_answer_tokens=shifted, sample_valid=np.ones((bs,), bool))


@pytest.fixture(scope="module")
def pair():
    """(flax JointTransformer, its params, the port's with those params)."""
    vocab, config = _Vocab(), _model_config()
    flax_model = JaxJointTransformer(config, vocab)
    batch = {k: jnp.asarray(v) for k, v in _numpy_batch(0, 3, vocab).items()}
    params = jax.jit(lambda r, b: flax_model.init(r, b, train=False))(
        jax.random.PRNGKey(0), batch)["params"]
    port = builders.build_model(config, vocab).eval()
    state = params_from_flax(jax.tree.map(np.asarray, params))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return flax_model, params, port


def test_params_round_trip(pair):
    """params_from_flax, then the JAX package's convert_joint_transformer on
    the port's state dict, gives back every flax tensor."""
    flax_model, params, port = pair
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    for name in ("region_embedding.proj.weight", "box_embedding.proj.bias",
                 "text_embedding.components.weight", "encoder.layers.1.mhatt.attention.fc_q.weight",
                 "decoder.layers.0.enc_attn.attention.fc_v.weight"):
        assert name in state, name
    back = torch_conversion.convert_joint_transformer(state, flax_model.config)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want) == len(state)
    for path, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), np.asarray(want),
                                      err_msg=str(path))


def test_teacher_forced_log_probs_match_jax(pair):
    flax_model, params, port = pair
    batch = _numpy_batch(1, 3, flax_model.vocab)
    want = flax_model.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = port({k: _t(v) for k, v in batch.items()})
    _close(got, want, atol=1e-4)


@pytest.mark.parametrize("parts", ["layer", "none"])
def test_beam3_generate_matches_jax(pair, monkeypatch, parts):
    """Beam-3 generate of a numpy batch against the JAX package's: identical
    tokens, log-probs within 1e-4, on the layer route and on the module route
    (every decode step's self- and cross-attention through attend)."""
    flax_model, params, port = pair
    batch = _numpy_batch(2, 3, flax_model.vocab)
    monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL_PARTS", parts)
    want_tokens, want_logprobs = jdecode.generate(
        flax_model, {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
        batch_size=3, beam_size=3)
    got_tokens, got_logprobs = decode.generate(port, {k: _t(v) for k, v in batch.items()}, 3)
    np.testing.assert_array_equal(got_tokens.numpy(), np.asarray(want_tokens))
    _close(got_logprobs, want_logprobs, atol=1e-4)


def test_module_route_attends_through_the_flat_attention(pair, monkeypatch):
    """On the module route each decode step's self- and cross-attention call
    the flat attention once per layer; the layer route calls it never."""
    from openvivqa_tpu_torch.ops import fused_attention

    _, _, port = pair
    batch = {k: _t(v) for k, v in _numpy_batch(3, 2, _Vocab()).items()}
    calls = []
    original = fused_attention.fused_attention
    monkeypatch.setattr(fused_attention, "fused_attention",
                        lambda *a: calls.append(a[0].shape) or original(*a))
    for parts, want in (("layer", 0), ("none", _Vocab.max_answer_length * 2 * 2)):
        calls.clear()
        monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL_PARTS", parts)
        decode.generate(port, batch, 3)
        assert len(calls) == want, parts
    assert all(shape[2] == 1 for shape in calls)  # one query per row and head


# -- the task ----------------------------------------------------------------------------
def _task_config(paths, tmp_path, dropout=0.1, **training):
    def dataset(kind):
        return _dataset_config(paths, kind, batch_size=6).to_dict()

    return ConfigNode({
        "TASK": "VlspEvjVqaTask",
        "DATASET": {
            "FEATURE_DATASET": dataset("MultilingualFeatureDataset"),
            "DICT_DATASET": dataset("MultilingualDictionaryDataset"),
            "VOCAB": _vocab_config(paths).to_dict(),
            "JSON_PATH": {"TRAIN": paths["train"], "DEV": paths["dev"],
                          "PUBLIC_TEST": paths["public_test"],
                          "PRIVATE_TEST": paths["private_test"]},
        },
        "TRAINING": {
            "CHECKPOINT_PATH": str(tmp_path / "saved_models"), "LEARNING_RATE": 1.0,
            "WARMUP": 100, "SCORE": "CIDEr", "TRAINING_BEAM_SIZE": 3, "EVALUATING_BEAM_SIZE": 3,
            "PATIENCE": 2, "MAX_EPOCHS": 1, "SEED": 11, **training,
        },
        "MODEL": _model_config(dropout).to_dict(),
    })


def test_train_step_matches_jax(evjvqa, tmp_path):
    """One VlspEvjVqaTask step, loss and the Adam update, against the JAX
    package's OpenEndedTask._train_step on the same bridged weights and numpy
    batch, every dropout rate 0: loss rtol 1e-5, weights atol 5e-6 (the key
    biases, which get no gradient, held to +-lr)."""
    config = _task_config(evjvqa, tmp_path, dropout=0.0)
    task = builders.build_task(config, "cpu")
    host = next(iter(task.train_dataloader))
    jax_batch = {key: jnp.asarray(value) for key, value in host.arrays().items()}

    jax_model = JaxJointTransformer(config.MODEL, task.vocab)
    params = jax.jit(lambda r, b: jax_model.init(r, b, train=False))(
        jax.random.PRNGKey(0), jax_batch)["params"]
    before = params_from_flax(jax.tree.map(np.asarray, params))
    task.model.load_state_dict({k: torch.from_numpy(v) for k, v in before.items()})

    schedule = joptim.noam_schedule(1.0, config.MODEL.D_MODEL, 100)
    state = TrainState.create(lambda v, b, train, rngs: jax_model.apply(v, b, train=False),
                              params, {}, joptim.make_optimizer(schedule))
    stub = types.SimpleNamespace(vocab=task.vocab, maybe_remat=lambda fn: fn)
    new_state, jax_loss = jax.jit(lambda s, b, r: JaxOpenEndedTask._train_step(stub, s, b, r))(
        state, jax_batch, jax.random.PRNGKey(1))

    loss = task._train_step(task.put_batch(host))
    assert float(loss) == pytest.approx(float(jax_loss), rel=1e-5)
    want = params_from_flax(jax.tree.map(np.asarray, new_state.params))
    lr = float(schedule(0))
    for name, tensor in task.model.state_dict().items():
        if name.endswith(GRADIENT_FREE):
            for after in (tensor.numpy(), want[name]):
                assert np.abs(after - before[name]).max() <= 1.01 * lr, name
        else:
            np.testing.assert_allclose(tensor.numpy(), want[name], atol=5e-6, rtol=0,
                                       err_msg=name)


def test_gradient_step_gives_finite_nonzero_grads(evjvqa, tmp_path):
    """The training route at dropout 0.1: every parameter gets a finite,
    non-zero gradient (the key biases only finite)."""
    task = builders.build_task(_task_config(evjvqa, tmp_path), "cpu")
    _, batch = next(task.device_batches(task.train_dataloader))
    task.optimizer.zero_grad(set_to_none=True)
    task.compute_loss(batch).backward()
    for name, param in task.model.named_parameters():
        assert param.grad is not None and bool(torch.isfinite(param.grad).all()), name
        assert name.endswith(GRADIENT_FREE) or float(param.grad.abs().max()) > 0.0, name


def test_vlsp_evjvqa_task_end_to_end(evjvqa, tmp_path):
    """XE training for one epoch, beam-3 dev eval, checkpoints, then
    get_predictions() writing both test splits' files."""
    config = _task_config(evjvqa, tmp_path)
    task = builders.build_task(config, "cpu")
    task.start()
    ckpt_dir = os.path.join(config.TRAINING.CHECKPOINT_PATH, config.MODEL.NAME)
    assert os.path.isfile(os.path.join(ckpt_dir, "best_model.pth"))
    scores = task.get_predictions()
    assert sorted(scores) == ["private_test", "public_test"]
    for split in ("public_test", "private_test"):
        with open(os.path.join(ckpt_dir, f"{split}_results.json")) as handle:
            dumped = json.load(handle)
        with open(evjvqa[split]) as handle:
            want_ids = sorted(a["id"] for a in json.load(handle)["annotations"])
        assert sorted(i for r in dumped["results"] for i in r["id"]) == want_ids
        assert np.isfinite(scores[split]["CIDEr"])


def test_config_builds_at_its_full_widths(tmp_path):
    """configs/joint_transformer_vlsp.yaml through the port's build_task on
    the CPU, on a small EVJVQA set at the config's feature widths: d_model
    512, 8 heads, 3 + 3 layers; one teacher-forced loss over a batch of 3."""
    paths = synthetic.generate_evjvqa_dataset(str(tmp_path / "data"), n_images=4, seed=1)
    dataset = {"BATCH_SIZE": 3, "FEATURE_PATH": {"FEATURES": paths["features"]}}
    json_paths = {"TRAIN": paths["train"], "DEV": paths["dev"],
                  "PUBLIC_TEST": paths["public_test"], "PRIVATE_TEST": paths["private_test"]}
    config = get_config("configs/joint_transformer_vlsp.yaml").merged({
        "DATASET": {"FEATURE_DATASET": dataset, "DICT_DATASET": dataset, "JSON_PATH": json_paths,
                    "VOCAB": {"JSON_PATH": {"TRAIN": paths["train"], "DEV": paths["dev"],
                                            "TEST": paths["public_test"]}}},
        "TRAINING": {"CHECKPOINT_PATH": str(tmp_path / "saved_models")},
    })
    task = builders.build_task(config, "cpu")
    model = task.model
    assert type(model).__name__ == "JointTransformer"
    assert len(model.encoder.layers) == 3 and len(model.decoder.layers) == 3
    core = model.encoder.layers[0].mhatt.attention
    assert (core.d_model, core.h, model.region_embedding.proj.in_features,
            model.grid_embedding.proj.in_features) == (512, 8, 2048, 1024)
    _, batch = next(task.device_batches(task.train_dataloader))
    with torch.no_grad():
        loss = task.compute_loss(batch)
    assert bool(torch.isfinite(loss))


def test_entry_points_default_to_the_card(monkeypatch):
    """build_task and the command line put the model on cuda unless told
    otherwise."""
    assert inspect.signature(builders.build_task).parameters["device"].default == "cuda"
    seen = {}

    def fake_build_task(config, device):
        seen["device"] = device
        return types.SimpleNamespace(start=lambda: None, get_predictions=lambda: None)

    monkeypatch.setattr(train, "build_task", fake_build_task)
    train.main(["--config-file", "configs/joint_transformer_vlsp.yaml"])
    assert seen["device"] == "cuda"
