"""The port's VLSP generative family and cross-modality models in training on
the CPU against the JAX package: one Adam step per architecture
(CrossModalityTransformer as a generator, VisiolinguisticTransformer as a
classifier, ExtendedMCAN, UniqueTransformer) of the port's task loss against
the JAX task's ``_train_step`` on the same numpy-drawn weights and batch, and
VlspEvjVqaTask (UniqueTransformer) and ClassificationTask
(CrossModalityTransformer) end to end.  The small models and their data are
``test_torch_port_vlsp_family.py``'s.
"""

import copy
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_port_vlsp_family import (
    D,
    GRADIENT_FREE,
    GRIDS,
    IDS,
    MODELS,
    REGIONS,
    _model_config,
    _numpy_batch,
    _pair,
    _t,
)

from openvivqa_tpu.training import optim as joptim
from openvivqa_tpu.training.tasks.classification_task import (
    ClassificationTask as JaxClassificationTask,
)
from openvivqa_tpu.training.tasks.open_ended_task import OpenEndedTask as JaxOpenEndedTask
from openvivqa_tpu.training.train_state import TrainState
from openvivqa_tpu_torch import builders
from openvivqa_tpu_torch.config import ConfigNode
from openvivqa_tpu_torch.data import synthetic
from openvivqa_tpu_torch.models.convert import params_from_flax
from openvivqa_tpu_torch.training.optim import constant_lambda, make_optimizer, noam_lambda
from openvivqa_tpu_torch.training.tasks.classification_task import ClassificationTask
from openvivqa_tpu_torch.training.tasks.open_ended_task import OpenEndedTask


# The first Adam step moves a weight by lr * g / (|g| + 1e-8), about lr * sign(g):
# float32 gradients that differ in their last bits move the two sides' weights
# apart by a tiny share of lr (held to 1e-3 * lr).  Where |g| falls within a few
# orders of Adam's 1e-8 (below NEAR_EPS: a GELU unit nearly dead on the batch, a
# padded row's weights), the same rounding moves them apart by up to lr: those
# elements, fewer than 1 % of the weights where the gradient is not exactly zero, and
# the analytically gradient-free
# biases, are held to the step's own bound.
NEAR_EPS = 1e-6


def adam_step_matches_jax(flax_model, params, port, batch, jax_task, port_task, rate=None,
                          gradient_free=GRADIENT_FREE):
    """One Adam step of `port_task`'s loss against `jax_task`'s _train_step
    on the same weights and batch, without dropout: at the noam schedule
    (1.0, d_model, warmup 100), or at the constant `rate`.  A parameter
    without a gradient (an LSTM's held input bias) must stay as it was."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if rate is None:
        schedule, base, factor = joptim.noam_schedule(1.0, D, 100), 1.0, noam_lambda(D, 100)
    else:
        schedule, base, factor = joptim.constant_lambda_schedule(rate), rate, \
            constant_lambda(rate)
    state = TrainState.create(lambda v, b, train, rngs: flax_model.apply(v, b, train=False),
                              params, {}, joptim.make_optimizer(schedule))
    stub = types.SimpleNamespace(vocab=flax_model.vocab, maybe_remat=lambda fn: fn)
    new_state, jax_loss = jax.jit(lambda s, b, r: jax_task._train_step(stub, s, b, r))(
        state, jb, jax.random.PRNGKey(1))

    before = params_from_flax(params)
    port.train()
    optimizer, _ = make_optimizer(port.parameters(), base, factor)
    port_stub = types.SimpleNamespace(model=port, generator=None, vocab=flax_model.vocab)
    loss = port_task.compute_loss(port_stub, {k: _t(v) for k, v in batch.items()})
    loss.backward()
    optimizer.step()
    port.eval()
    assert float(loss.detach()) == pytest.approx(float(jax_loss), rel=1e-5)
    want = params_from_flax(jax.tree.map(np.asarray, new_state.params))
    lr = float(schedule(0))
    near_eps = 0
    grads = {name: p.grad for name, p in port.named_parameters()}
    for name, tensor in port.state_dict().items():
        got = tensor.detach().numpy()
        if grads.get(name) is None:
            np.testing.assert_array_equal(got, before[name], err_msg=name)
            continue
        small = (np.ones_like(got, bool) if name.endswith(gradient_free)
                 else grads[name].abs().numpy() < NEAR_EPS)
        if not name.endswith(gradient_free):  # rows no token reads get exactly 0 on both sides
            near_eps += int((small & (grads[name].numpy() != 0)).sum())
        for after in (got, want[name]):
            assert np.abs(after - before[name])[small].max(initial=0.0) <= 1.01 * lr, name
        np.testing.assert_allclose(got[~small], want[name][~small], atol=1e-3 * lr, rtol=0,
                                   err_msg=name)
    assert near_eps < 0.01 * sum(t.numel() for t in port.state_dict().values()), near_eps


# one mode per architecture
ADAM = [("CrossModalityTransformer", True), ("VisiolinguisticTransformer", False),
        ("ExtendedMCAN", True), ("UniqueTransformer", True)]


@pytest.mark.parametrize("arch,generative", ADAM, ids=[IDS[MODELS.index(m)] for m in ADAM])
def test_adam_step_matches_jax(arch, generative):
    """One Adam step (the noam schedule; the classifier at the constant rate)
    of the OpenEndedTask / ClassificationTask loss against the JAX task's,
    without dropout on either side (the port's route without a generator, the
    JAX forward with train=False): loss rtol 1e-5, weights within 1e-3 of the
    rate."""
    flax_model, params, port = _pair(arch, generative)
    tasks = (JaxOpenEndedTask, OpenEndedTask) if generative else \
        (JaxClassificationTask, ClassificationTask)
    adam_step_matches_jax(flax_model, params, copy.deepcopy(port), _numpy_batch(11), *tasks,
                          rate=None if generative else 0.1)




# -- the tasks ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def evjvqa(tmp_path_factory):
    return synthetic.generate_evjvqa_dataset(
        str(tmp_path_factory.mktemp("evjvqa_vlsp")), n_images=6, n_questions_per_image=3,
        ja_share=0.4, seed=5)


def _vlsp_dataset(paths, kind):
    return {"TYPE": kind, "BATCH_SIZE": 6, "WORKERS": 1, "MAX_REGIONS": REGIONS,
            "MAX_GRIDS": GRIDS, "FEATURE_PATH": {"FEATURES": paths["features"], "IMAGE": None,
                                                 "SCENE_TEXT": None}}


def test_vlsp_task_end_to_end(evjvqa, tmp_path):
    """UniqueTransformer under VlspEvjVqaTask: one XE epoch, the beam-3 dev
    eval, checkpoints, then get_predictions() writing both test splits'
    files.  The stream widths come from the feature store (2048-wide regions,
    1024-wide grids), as flax infers them."""
    json_paths = {"TRAIN": evjvqa["train"], "DEV": evjvqa["dev"],
                  "PUBLIC_TEST": evjvqa["public_test"], "PRIVATE_TEST": evjvqa["private_test"]}
    config = ConfigNode({
        "TASK": "VlspEvjVqaTask",
        "DATASET": {
            "FEATURE_DATASET": _vlsp_dataset(evjvqa, "MultilingualFeatureDataset"),
            "DICT_DATASET": _vlsp_dataset(evjvqa, "MultilingualDictionaryDataset"),
            "JSON_PATH": json_paths,
            "VOCAB": {"TYPE": "VlspVqaMultiModalVocab", "TOKENIZER": None, "MIN_FREQ": 1,
                      "WORD_EMBEDDING": None, "WORD_EMBEDDING_CACHE": None,
                      "PAD_TOKEN": "<pad>", "BOS_TOKEN": "<bos>", "EOS_TOKEN": "<eos>",
                      "UNK_TOKEN": "<unk>", "IMG_TOKEN": "<img>", "FEAT_TOKEN": "<feat>",
                      "BOX_TOKEN": "<box>", "QUESTION_TOKEN": "<question>",
                      "ANSWER_TOKEN": "<answer>",
                      "JSON_PATH": {"TRAIN": evjvqa["train"], "DEV": evjvqa["dev"],
                                    "TEST": evjvqa["public_test"]}},
        },
        "TRAINING": {"CHECKPOINT_PATH": str(tmp_path / "saved_models"), "LEARNING_RATE": 1.0,
                     "WARMUP": 100, "SCORE": "CIDEr", "EVALUATING_BEAM_SIZE": 3,
                     "TRAINING_BEAM_SIZE": 3, "PATIENCE": 2,
                     "MAX_EPOCHS": 1, "SEED": 11},
        "MODEL": _model_config("UniqueTransformer").to_dict(),
    })
    task = builders.build_task(config, "cpu")
    assert task.model.region_embedding.proj.in_features == 2048
    assert task.model.grid_embedding.proj.in_features == 1024
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


def test_classification_task_end_to_end(synthetic_data, tmp_path):
    """CrossModalityTransformer as a classifier under ClassificationTask: two
    epochs of start(), checkpoints, get_predictions() and
    test_results.json."""
    jp = {"TRAIN": synthetic_data["train"], "DEV": synthetic_data["dev"],
          "TEST": synthetic_data["test"]}
    model = _model_config("CrossModalityTransformer", generative=False).to_dict()
    config = ConfigNode({
        "TASK": "ClassificationTask",
        "DATASET": {
            "FEATURE_DATASET": {"TYPE": "FeatureClassificationDataset", "BATCH_SIZE": 8,
                                "WORKERS": 1, "MAX_REGIONS": 12,
                                "FEATURE_PATH": {"FEATURES": synthetic_data["features"]}},
            "VOCAB": {"TYPE": "ClassificationVocab", "TOKENIZER": None, "MIN_FREQ": 1,
                      "WORD_EMBEDDING": None, "WORD_EMBEDDING_CACHE": None,
                      "PAD_TOKEN": "<pad>", "BOS_TOKEN": "<bos>", "EOS_TOKEN": "<eos>",
                      "UNK_TOKEN": "<unk>", "JSON_PATH": jp},
            "JSON_PATH": jp,
        },
        "TRAINING": {"CHECKPOINT_PATH": str(tmp_path / "saved_models"), "LEARNING_RATE": 0.1,
                     "WARMUP": 100, "SCORE": "CIDEr", "GET_SCORES": True, "PATIENCE": 2,
                     "MAX_EPOCHS": 2, "SEED": 7},
        "MODEL": model,
    })
    task = builders.build_task(config, "cpu")
    assert task.model.region_embedding.proj.in_features == 1024  # the store's, not the config's
    task.start()
    ckpt_dir = os.path.join(config.TRAINING.CHECKPOINT_PATH, config.MODEL.NAME)
    for name in ("best_model.pth", "last_model.pth", "vocab.bin"):
        assert os.path.isfile(os.path.join(ckpt_dir, name)), name
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as handle:
        records = [json.loads(line) for line in handle]
    train = [r for r in records if r["phase"] == "train"]
    assert len(train) == 2 and all(np.isfinite(r["step_losses"]).all() for r in train)
    scores = task.get_predictions()
    assert "CIDEr" in scores
    with open(os.path.join(ckpt_dir, "test_results.json")) as handle:
        assert len(json.load(handle)["results"]) > 0
