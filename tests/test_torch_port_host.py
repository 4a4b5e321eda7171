"""The port's boundary and its own host layers.

The port (``openvivqa_tpu_torch`` and ``chip_smoke.py``) imports torch and never
JAX, flax, optax or anything of the JAX package; it keeps its own copies of the
host layers (config, registry, data, evaluation).  These tests walk its imports
and hold the copies against their originals on the same synthetic data:
loaders give the same arrays batch for batch, and the metric suite the same
scores.
"""

import ast
import pathlib

import numpy as np
import pytest

import openvivqa_tpu.data  # noqa: F401  (registers the JAX package's datasets)
from openvivqa_tpu import builders as jax_builders
from openvivqa_tpu.data.loader import DataLoader as JaxDataLoader
from openvivqa_tpu.evaluation import compute_scores as jax_compute_scores
from openvivqa_tpu_torch import builders
from openvivqa_tpu_torch.config import ConfigNode
from openvivqa_tpu_torch.data.loader import DataLoader
from openvivqa_tpu_torch.evaluation import compute_scores

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "openvivqa_tpu"}
PORT_FILES = sorted((ROOT / "openvivqa_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _absolute_imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_the_jax_package(path):
    roots = {name.split(".")[0] for name in _absolute_imports(path)}
    assert not roots & FORBIDDEN, f"{path.relative_to(ROOT)} imports {sorted(roots & FORBIDDEN)}"


def test_walk_covers_the_scale_out_modules():
    """The walk above reaches the scale-out modules and the migration tool."""
    walked = {str(path.relative_to(ROOT)) for path in PORT_FILES}
    for name in ("parallel/mesh.py", "parallel/multihost.py", "training/profiling.py",
                 "tools/migrate_checkpoint.py"):
        assert f"openvivqa_tpu_torch/{name}" in walked, name


def test_walk_covers_the_tensor_parallel_code():
    """The walk above reads the module that holds tensor parallelism (the
    placement rule, the DTensor placement, whole() and the eval swap) and
    every module that reads a weight through whole()."""
    walked = {str(path.relative_to(ROOT)): path for path in PORT_FILES}
    mesh = walked["openvivqa_tpu_torch/parallel/mesh.py"]
    defined = {node.name for node in ast.walk(ast.parse(mesh.read_text()))
               if isinstance(node, ast.FunctionDef)}
    assert {"param_placement", "apply_tensor_parallel", "whole", "whole_parameters",
            "average_gradients", "data_index", "data_count", "data_shard"} <= defined
    readers = {name for name, path in walked.items()
               if any(isinstance(node, ast.ImportFrom)
                      and (node.module or "").endswith("parallel.mesh")
                      for node in ast.walk(ast.parse(path.read_text())))}
    for name in ("models/modules/bert.py", "models/modules/ffn.py", "models/modules/deberta.py",
                 "models/modules/vit.py", "models/mmf_m4c.py", "models/mmf_variants.py",
                 "models/standalone_m4c.py", "models/modules/text_embeddings.py",
                 "training/train_state.py", "data/loader.py"):
        assert f"openvivqa_tpu_torch/{name}" in readers, name


def test_tensor_parallel_code_imports_no_jax():
    """In a fresh interpreter, the mesh module with tensor parallelism (a
    one-process gloo group, a (1, 1) mesh, a DTensor made whole, the placement
    rule, the eval swap) and the task layer import no jax and nothing of the
    JAX package."""
    import os
    import socket
    import subprocess
    import sys

    code = """
import os, sys
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=sys.argv[1], RANK="0", WORLD_SIZE="1")
import torch
from torch.distributed.tensor import Shard, distribute_tensor
from openvivqa_tpu_torch.parallel import mesh, multihost
from openvivqa_tpu_torch.training.tasks import base_task
from openvivqa_tpu_torch import builders
builders.populate()
multihost.initialize("cpu", required=True)
grid = mesh.get_mesh_2d(1, "cpu")
linear = torch.nn.Linear(8, 4)
linear.weight = torch.nn.Parameter(distribute_tensor(linear.weight.detach(), grid["model"],
                                                     [Shard(0)]))
assert torch.equal(mesh.whole(linear.weight), linear.weight.full_tensor())
with mesh.whole_parameters(linear):
    assert type(linear.weight) is torch.nn.Parameter
assert mesh.param_placement(linear, "weight", linear.weight, 2) == Shard(0)
assert mesh.data_shard() == (1, 0)
multihost.finalize()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "openvivqa_tpu"))
assert not bad, bad
print("clean")
"""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    done = subprocess.run([sys.executable, "-c", code, str(port)], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0 and done.stdout.strip().endswith("clean"), done.stderr[-2000:]


def _dataset_config(paths, kind):
    return ConfigNode({
        "TYPE": kind, "BATCH_SIZE": 8, "MAX_SCENE_TEXT": 8, "SCENE_TEXT_THRESHOLD": 0.3,
        "WORD_EMBEDDING": None,
        "FEATURE_PATH": {"FEATURES": paths["features"], "SCENE_TEXT": paths["scene_text"]},
    })


def _vocab_config(paths, kind="OcrVocab"):
    return ConfigNode({
        "TYPE": kind, "TOKENIZER": None, "MIN_FREQ": 1, "WORD_EMBEDDING": None,
        "PAD_TOKEN": "<pad>", "BOS_TOKEN": "<bos>", "EOS_TOKEN": "<eos>", "UNK_TOKEN": "<unk>",
        "IMG_TOKEN": "<img>", "FEAT_TOKEN": "<feat>", "BOX_TOKEN": "<box>", "OCR_TOKEN": "<ocr>",
        "OCR_DET_TOKEN": "<ocr_det>", "OCR_REC_TOKEN": "<ocr_rec>",
        "QUESTION_TOKEN": "<question>", "ANSWER_TOKEN": "<answer>",
        "JSON_PATH": {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["test"]},
    })


@pytest.mark.parametrize("kind,split,shuffle", [
    ("OcrFeatureDataset", "train", True), ("OcrDictionaryDataset", "dev", False),
    ("FeatureDataset", "train", True), ("DictionaryDataset", "dev", False),
    ("FeatureClassificationDataset", "train", True),
    ("FeatureClassificationDataset", "test", False),
])
def test_loader_batches_match_the_jax_package(synthetic_data, kind, split, shuffle):
    builders.populate()
    vocab_kind = ("OcrVocab" if kind.startswith("Ocr") else "ClassificationVocab"
                  if kind == "FeatureClassificationDataset" else "Vocab")
    vocab_config = _vocab_config(synthetic_data, vocab_kind)
    ours = builders.build_vocab(vocab_config)
    theirs = jax_builders.build_vocab(vocab_config)
    assert ours.itos == theirs.itos
    config = _dataset_config(synthetic_data, kind)

    def epoch(build, loader_class, vocab):
        # an answer word found in several OCR slots picks one with numpy's
        # global generator (the reference's rule): seed it, one worker
        np.random.seed(11)
        dataset = build(synthetic_data[split], vocab, config)
        return list(loader_class(dataset, batch_size=8, shuffle=shuffle, seed=3, num_workers=1))

    got_batches = epoch(builders.build_dataset, DataLoader, ours)
    want_batches = epoch(jax_builders.build_dataset, JaxDataLoader, theirs)
    assert len(got_batches) == len(want_batches) >= 1
    for batch, want in zip(got_batches, want_batches):
        got, expected = batch.arrays(), want.arrays()
        assert sorted(got) == sorted(expected)
        for key in expected:
            np.testing.assert_array_equal(got[key], expected[key], err_msg=key)
        assert batch.host_fields() == want.host_fields()


def test_compute_scores_matches_the_jax_package():
    rng = np.random.default_rng(0)
    words = ["một", "hai", "ba", "bốn", "năm", "xe", "đỏ", "mèo"]

    def sentence():
        return " ".join(rng.choice(words, size=rng.integers(1, 6)))

    gts = {f"q{i}": [sentence() for _ in range(rng.integers(1, 4))] for i in range(30)}
    gens = {key: [sentence()] for key in gts}
    gens["q0"] = [gts["q0"][0]]
    score, per_sample = compute_scores(gts, gens)
    want_score, want_per_sample = jax_compute_scores(gts, gens)
    assert score == want_score
    assert sorted(per_sample) == sorted(want_per_sample)
    for metric, values in want_per_sample.items():
        np.testing.assert_array_equal(np.asarray(per_sample[metric]), np.asarray(values))


def test_classification_vocab_matches_the_jax_package(synthetic_data):
    """The port's ClassificationVocab against the JAX package's: the same
    classes (sorted answers), lengths and specials, the same encoded answer
    of every train annotation, and decode_answer under both spellings."""
    builders.populate()
    vocab_config = _vocab_config(synthetic_data, "ClassificationVocab")
    ours = builders.build_vocab(vocab_config)
    theirs = jax_builders.build_vocab(vocab_config)
    assert type(ours).__name__ == type(theirs).__name__ == "ClassificationVocab"
    assert ours.itoa == theirs.itoa and ours.atoi == theirs.atoi
    assert ours.total_answers == theirs.total_answers == len(ours.itoa) > 1
    assert (ours.max_question_length, ours.max_answer_length, ours.padding_idx) == (
        theirs.max_question_length, theirs.max_answer_length, theirs.padding_idx)
    config = _dataset_config(synthetic_data, "FeatureClassificationDataset")
    got = builders.build_dataset(synthetic_data["train"], ours, config)
    want = jax_builders.build_dataset(synthetic_data["train"], theirs, config)
    assert got.questions == want.questions and got.answers == want.answers
    for answer in got.answers:
        np.testing.assert_array_equal(ours.encode_answer(answer), theirs.encode_answer(answer))
    ids = np.arange(ours.total_answers)
    assert ours.decode_answer(ids, join_word=True) == theirs.decode_answer(ids, join_word=True)
    assert ours.decode_answer(ids) == theirs.decode_answer(ids)


def test_character_vocab_and_image_dataset_match_the_jax_package(tmp_path):
    """CharacterVocab (word-level questions, one answer character per
    position) and ImageDataset (pixels resized bilinearly to 32 and
    normalised, the question's encoding, the teacher-forcing pair) against
    the JAX package's on a synthetic EVJVQA set, loader batch for batch."""
    from openvivqa_tpu_torch.data.synthetic import generate_evjvqa_dataset

    builders.populate()
    paths = generate_evjvqa_dataset(str(tmp_path), n_images=4, n_questions_per_image=2, seed=0)
    vocab_config = ConfigNode({
        "TYPE": "CharacterVocab", "TOKENIZER": None, "MIN_FREQ": 1, "WORD_EMBEDDING": None,
        "PAD_TOKEN": "<pad>", "BOS_TOKEN": "<bos>", "EOS_TOKEN": "<eos>", "UNK_TOKEN": "<unk>",
        "JSON_PATH": {"TRAIN": paths["train"], "DEV": paths["dev"],
                      "TEST": paths["public_test"]},
    })
    ours = builders.build_vocab(vocab_config)
    theirs = jax_builders.build_vocab(vocab_config)
    assert type(ours).__name__ == type(theirs).__name__ == "CharacterVocab"
    assert ours.itos == theirs.itos and ours.stoi == theirs.stoi
    assert (ours.max_question_length, ours.max_answer_length) == (
        theirs.max_question_length, theirs.max_answer_length)
    config = ConfigNode({"TYPE": "ImageDataset", "BATCH_SIZE": 2, "IMAGE_SIZE": 32,
                         "WORD_EMBEDDING": None,
                         "FEATURE_PATH": {"FEATURES": None, "IMAGE": paths["images"],
                                          "SCENE_TEXT": None}})
    got = list(DataLoader(builders.build_dataset(paths["train"], ours, config), batch_size=3,
                          shuffle=True, seed=1, num_workers=1))
    want = list(JaxDataLoader(jax_builders.build_dataset(paths["train"], theirs, config),
                              batch_size=3, shuffle=True, seed=1, num_workers=1))
    assert len(got) == len(want) >= 2
    for batch, expected in zip(got, want):
        arrays, expected_arrays = batch.arrays(), expected.arrays()
        assert sorted(arrays) == sorted(expected_arrays)
        assert arrays["pixel_values"].shape[1:] == (32, 32, 3)
        for key in expected_arrays:
            np.testing.assert_array_equal(arrays[key], expected_arrays[key], err_msg=key)
        answers = arrays["answer_tokens"]
        assert ours.decode_answer(answers) == theirs.decode_answer(answers)
        assert ours.decode_answer(answers, join_word=False) == theirs.decode_answer(
            answers, join_word=False)
