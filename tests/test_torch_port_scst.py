"""Self-critical sequence training (TRAINING.USE_SCST) in the port, on the CPU,
against the JAX package's ``OpenEndedTask.train_scst``, at small sizes.

One ``train_scst()`` batch of IterativeMCAN (OpenEndedTask) and of
ViTmBERTGeneration (VlspEvjVqaTask, from its YAML at small widths) against the
JAX task's on the same bridged weights and host batch: both packages' beam
draws equal, then, on one fixed (n, k, L) sample set given to both (answers,
their first words and random ids, so that the rewards and advantages are not
all zero), the CIDEr reward within 1e-6, the loss within rtol 1e-4 and every
weight after Adam's step at the RL rate as
``test_torch_port_generative.py::test_train_step_matches_jax`` holds them
(atol 5e-6, the gradient-free key biases held to +-lr).  Then the routing: the
XE -> RL switch and the resume (``tests/test_scst_protocol.py::test_scst_switch``),
OcrOpenEndedTask's OCR-copy reward path, TrainingMMF's refusal, and the
re-run's gradient on every trainable parameter of four SCST-capable families
(the MCAN decoder, IterativeSAAA's LSTM, the frozen-backbone ViTmBERTGeneration,
IterativeM4C's dynamic pointer).
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvivqa_tpu import builders as jax_builders
from openvivqa_tpu.config import ConfigNode as JaxConfigNode
from openvivqa_tpu.evaluation import Cider as JaxCider
from openvivqa_tpu.training import decode as jdecode
from openvivqa_tpu.training import optim as joptim
from openvivqa_tpu.training.tasks.open_ended_task import OpenEndedTask as JaxOpenEndedTask
from openvivqa_tpu.training.train_state import TrainState
from openvivqa_tpu_torch import builders
from openvivqa_tpu_torch.config import get_config
from openvivqa_tpu_torch.data import synthetic
from openvivqa_tpu_torch.models.convert import params_from_flax
from openvivqa_tpu_torch.training.tasks.ocr_tasks import TrainingMMF
from test_torch_port_generative import _task_config as _mcan_task_config
from test_torch_port_m4c_tasks import _iterative_m4c
from test_torch_port_m4c_tasks import _task_config as _ocr_task_config
from test_torch_port_saaa_readable import _saaa_task_config

jax_builders.populate()
builders.populate()

RL = 1e-4  # the RL rate of the parity runs: Adam's first step moves a weight by ~RL
GRADIENT_FREE = ("fc_k.bias", "self.key.bias")  # softmax(q . (k + b)) does not depend on b
BERT = {"D_PRETRAINED_FEATURE": 64, "PRETRAINED_LAYERS": 2, "NUM_ATTENTION_HEADS": 2,
        "PRETRAINED_VOCAB_SIZE": 64}


@pytest.fixture(scope="module")
def evjvqa(tmp_path_factory):
    root = tmp_path_factory.mktemp("evjvqa_scst")
    paths = synthetic.generate_evjvqa_dataset(str(root), n_images=8, n_questions_per_image=3,
                                              ja_share=0.3, seed=2)
    paths["vit"] = str(root / "vit")
    synthetic.write_vit_features(paths["vit"], 8, seed=2)
    return paths


def _vit_mbert_config(paths, tmp_path, **training):
    """configs/vit_mbert_generation.yaml on the ViT-shaped store, 32 wide, a
    2-layer BERT of 64, one decoder layer."""
    attention = {"D_MODEL": 32, "HEAD": 2, "D_KEY": 16, "D_VALUE": 16, "D_FF": 64}
    dataset = {"BATCH_SIZE": 12, "WORKERS": 1, "FEATURE_PATH": {"FEATURES": paths["vit"]}}
    return get_config("configs/vit_mbert_generation.yaml").merged({
        "DATASET": {
            "FEATURE_DATASET": dataset, "DICT_DATASET": dataset, "MIN_FREQ": 1,
            "JSON_PATH": {"TRAIN": paths["train"], "DEV": paths["dev"],
                          "PUBLIC_TEST": paths["public_test"],
                          "PRIVATE_TEST": paths["private_test"]},
            "VOCAB": {"MIN_FREQ": 1, "JSON_PATH": {"TRAIN": paths["train"], "DEV": paths["dev"],
                                                   "TEST": paths["public_test"]}},
        },
        "MODEL": {"D_MODEL": 32, "TEXT_EMBEDDING": dict(BERT, D_MODEL=32),
                  "VISION_EMBEDDING": {"D_MODEL": 32},
                  "DECODER": {"D_MODEL": 32, "LAYERS": 1, "TEXT_EMBEDDING": {"D_MODEL": 32},
                              "ATTENTION": {"SELF_ATTENTION": attention,
                                            "ENC_ATTENTION": attention}}},
        "TRAINING": {"CHECKPOINT_PATH": str(tmp_path / "saved_models"), "SEED": 4,
                     "TRAINING_BEAM_SIZE": 3, "RL_LEARNING_RATE": RL, **training},
    })


def _fixed_samples(task, host, seed=0) -> np.ndarray:
    """(n, k, L) ids for the batch: beam 0 each sample's first answer, beam 1
    its first word alone, the others random words then <eos>."""
    vocab, k = task.vocab, task.training_beam_size
    length = vocab.max_answer_length
    rng = np.random.default_rng(seed)
    n = len(host["sample_valid"])
    out = np.full((n, k, length), vocab.padding_idx, np.int32)
    for i in range(n):
        real = min(i, len(host["answers"]) - 1)
        words = host["answers"][real][0].split()
        # an OCR vocab encodes against the sample's OCR table
        table = (list(host["ocr_tokens"][real]),) if "ocr_tokens" in host else ()
        for j, beam in enumerate((words, words[:1])):
            out[i, j] = np.append(vocab.encode_answer(beam, *table)[1:], vocab.padding_idx)
        for j in range(2, k):
            stop = int(rng.integers(1, length))
            out[i, j, :stop] = rng.integers(4, len(vocab), size=stop)
            out[i, j, stop] = vocab.eos_idx
    return out


def _jax_stub(task, config, jax_model, params, host, samples=None):
    """The JAX OpenEndedTask's state for train_scst: its beam draw (or the
    fixed `samples`), CIDEr over the train split's answers, Adam at the RL
    rate, one host batch."""
    vocab = jax_builders.build_vocab(JaxConfigNode(config.DATASET.VOCAB.to_dict()))

    def generate_fn(batch_size, beam_size, out_size=1):
        if samples is not None:
            return lambda variables, batch: (jnp.asarray(samples), None)
        return jax.jit(lambda variables, batch: jdecode.generate(
            jax_model, variables, batch, batch_size=batch_size, beam_size=beam_size,
            out_size=out_size))

    stub = types.SimpleNamespace(
        vocab=vocab, model=jax_model, epoch=0, training_beam_size=task.training_beam_size,
        train_cider=JaxCider({f"{i}": [" ".join(a)]
                              for i, a in enumerate(task.train_dataset.answers)}),
        state=TrainState.create(jax_model.apply, jax.tree.map(jnp.asarray, params), {},
                                joptim.make_optimizer(lambda step: jnp.asarray(RL))),
        train_dict_dataloader=types.SimpleNamespace(batch_size=len(host["sample_valid"])),
        device_batches=lambda loader: iter([(host, {key: jnp.asarray(value) for key, value
                                                    in host.arrays().items()})]),
        _generate_fn=generate_fn,
    )
    stub._decode_batch = lambda outs, batch=None: JaxOpenEndedTask._decode_batch(stub, outs, batch)
    return stub


def _scst_pair(config, example_key):
    """(port task on the CPU, flax model, its params, one train-split dict
    batch), the port's weights bridged from flax's."""
    task = builders.build_task(config, "cpu")
    host = next(iter(task.train_dict_dataloader))
    jax_model = jax_builders.META_ARCHITECTURE.get(config.MODEL.ARCHITECTURE)(
        JaxConfigNode(config.MODEL.to_dict()), task.vocab)
    example = next(iter(task.train_dataloader)).arrays()
    params = jax.tree.map(np.asarray, jax.jit(
        lambda r, b: jax_model.init({"params": r, "dropout": r}, b, train=False))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in example.items()})["params"])
    task.model.load_state_dict({k: torch.from_numpy(v) for k, v in params_from_flax(params).items()})
    assert example_key in example
    return task, jax_model, params, host


SCST_MODELS = ["IterativeMCAN", "ViTmBERTGeneration"]


def _config_of(kind, synthetic_data, evjvqa, tmp_path):
    if kind == "IterativeMCAN":
        return _mcan_task_config(synthetic_data, tmp_path, RL_LEARNING_RATE=RL), "region_features"
    return _vit_mbert_config(evjvqa, tmp_path), "grid_features"


@pytest.mark.parametrize("kind", SCST_MODELS)
def test_scst_step_matches_jax(synthetic_data, evjvqa, tmp_path, kind):
    config, example_key = _config_of(kind, synthetic_data, evjvqa, tmp_path)
    task, jax_model, params, host = _scst_pair(config, example_key)
    device_batch = task.put_batch(host)

    # the beam draws of both packages agree on this batch
    ours = task.scst_samples(device_batch).numpy()
    stub = _jax_stub(task, config, jax_model, params, host)
    theirs, _ = stub._generate_fn(len(host["sample_valid"]), task.training_beam_size,
                                  task.training_beam_size)(stub.state.variables(),
                                                           next(stub.device_batches(None))[1])
    np.testing.assert_array_equal(ours, np.asarray(theirs))

    # one SCST step on a fixed sample set: reward, loss, the weights after Adam
    samples = _fixed_samples(task, host)
    stub = _jax_stub(task, config, jax_model, params, host, samples)
    jax_loss, jax_reward = JaxOpenEndedTask.train_scst(stub)
    task._switch_to_scst()
    assert task.optimizer.param_groups[0]["lr"] == RL
    task.train_dict_dataloader = [host]
    task.scst_samples = lambda batch: torch.from_numpy(samples)
    loss, reward = task.train_scst()
    assert jax_reward > 0.0 and np.isfinite(loss)
    assert reward == pytest.approx(jax_reward, abs=1e-6)
    assert loss == pytest.approx(jax_loss, rel=1e-4)
    before = params_from_flax(params)
    want = params_from_flax(jax.tree.map(np.asarray, stub.state.params))
    moved = 0
    for name, tensor in task.model.state_dict().items():
        if name.endswith(GRADIENT_FREE):
            for after in (tensor.numpy(), want[name]):
                assert np.abs(after - before[name]).max() <= 1.01 * RL, name
            continue
        np.testing.assert_allclose(tensor.numpy(), want[name], atol=5e-6, rtol=0, err_msg=name)
        moved += int(np.abs(tensor.numpy() - before[name]).max() > 0.5 * RL)
    assert moved > 0


def test_scst_switch_and_resume(synthetic_data, tmp_path):
    """USE_SCST with patience 1: the dev score never improves after the first
    epoch, so start() switches at the second (best_model.pth reloaded, Adam
    afresh at RL_LEARNING_RATE) and runs an SCST epoch at the third; use_rl
    is in the metadata.  A resumed task keeps the restored weights and Adam's
    moments and step, takes the RL rate, and its next SCST step continues the
    step count at the RL rate."""
    config = _mcan_task_config(synthetic_data, tmp_path, USE_SCST=True, PATIENCE=1, MAX_EPOCHS=3,
                               RL_LEARNING_RATE=RL)
    task = builders.build_task(config, "cpu")
    task.evaluate_metrics = lambda loader: {"CIDEr": 0.0}
    task.start()
    ckpt_dir = os.path.join(config.TRAINING.CHECKPOINT_PATH, config.MODEL.NAME)
    ckpt = os.path.join(ckpt_dir, "last_model.pth")
    assert torch.load(ckpt, weights_only=False)["metadata"]["use_rl"] is True
    assert task.epoch == 2
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as handle:
        phases = [json.loads(line) for line in handle]
    scst = [r for r in phases if r["phase"] == "scst"]
    assert [r["phase"] for r in phases if r["phase"] != "validation"] == ["train", "train", "scst"]
    assert np.isfinite(scst[0]["step_losses"]).all() and np.isfinite(scst[0]["step_rewards"]).all()
    steps = {p["step"].item() for p in task.optimizer.state.values()}
    assert steps == {len(task.train_dict_dataloader)}  # a fresh Adam at the switch

    resumed = builders.build_task(config, "cpu")
    meta = resumed.load_checkpoint(ckpt)
    assert meta["use_rl"] is True
    weights = {k: v.clone() for k, v in resumed.model.state_dict().items()}
    moments = {i: {k: v.clone() for k, v in s.items()}
               for i, s in enumerate(resumed.optimizer.state.values())}
    resumed._switch_to_scst(resume=True)
    for name, value in resumed.model.state_dict().items():
        assert torch.equal(value, weights[name]), name
    for i, state in enumerate(resumed.optimizer.state.values()):
        for key, value in state.items():
            assert torch.equal(value, moments[i][key]), key
    assert all(g["lr"] == RL for g in resumed.optimizer.param_groups)
    resumed.train_dict_dataloader = [next(iter(resumed.train_dict_dataloader))]
    resumed.train_scst()
    assert {p["step"].item() for p in resumed.optimizer.state.values()} == {
        len(task.train_dict_dataloader) + 1}
    assert all(g["lr"] == RL for g in resumed.optimizer.param_groups)


def test_ocr_scst_copy_reward_path(tmp_path):
    """OcrOpenEndedTask (IterativeM4C): sampled ids past the fixed vocab are
    OCR slots and decode against each sample's own OCR table before the CIDEr
    reward.  With every answer rewritten to its image's first scene-text word
    (as tests/test_scst_protocol.py rewrites them), a beam that copies that
    word's slot decodes to the answer and scores above one that says <unk>;
    then one train_scst() epoch runs with a finite loss and reward."""
    paths = synthetic.generate_synthetic_dataset(str(tmp_path / "data"), n_images=10,
                                                 n_questions_per_image=4, seed=3)
    for split in ("train", "dev", "test"):
        with open(paths[split]) as handle:
            data = json.load(handle)
        for ann in data["annotations"]:
            raw = np.load(os.path.join(paths["scene_text"], f"{ann['image_id']}.npy"),
                          allow_pickle=True)[()]
            ann["answers"] = [str(raw["texts"][0])]
            ann["answer"] = ann["answers"][0]
        with open(paths[split], "w") as handle:
            json.dump(data, handle)
    config = _ocr_task_config(paths, tmp_path, "OcrOpenEndedTask", _iterative_m4c(),
                              "OcrFeatureDataset", USE_SCST=True, RL_LEARNING_RATE=RL)
    task = builders.build_task(config, "cpu")
    host = next(iter(task.train_dict_dataloader))
    k, n_real = task.training_beam_size, int(np.asarray(host["sample_valid"]).sum())
    samples = np.full((len(host["sample_valid"]), k, task.vocab.max_answer_length),
                      task.vocab.padding_idx, np.int32)
    copied = []
    for i in range(n_real):
        table, answer = list(host["ocr_tokens"][i]), host["answers"][i][0]
        if answer in table:
            samples[i, 0, :2] = (len(task.vocab) + table.index(answer), task.vocab.eos_idx)
            copied.append(i)
        samples[i, 1:, :2] = (task.vocab.unk_idx, task.vocab.eos_idx)
    assert copied
    decoded = task._decode_batch(samples[:n_real], host)
    assert all(decoded[i * k] == host["answers"][i][0] for i in copied)
    reward = task.scst_rewards(host, samples)
    assert all(reward[i, 0] > reward[i, 1] for i in copied)
    assert not reward[n_real:].any()
    task._switch_to_scst()
    loss, mean_reward = task.train_scst()
    assert np.isfinite(loss) and np.isfinite(mean_reward)


def test_training_mmf_refuses_scst():
    with pytest.raises(NotImplementedError, match="greedy MMF"):
        TrainingMMF.train_scst(object.__new__(TrainingMMF))


FAMILIES = ["IterativeMCAN", "IterativeSAAA", "ViTmBERTGeneration", "IterativeM4C"]


@pytest.mark.parametrize("family", FAMILIES)
def test_scst_rerun_gradient_reaches_every_trainable_parameter(synthetic_data, evjvqa, tmp_path,
                                                               family):
    """The re-run's route (training mode, no generator: no dropout) carries the
    gradient to every trainable parameter of the family (the gradient-free key
    biases only finite), and none to a frozen one, at dropout 0.1."""
    if family == "IterativeMCAN":
        config = _mcan_task_config(synthetic_data, tmp_path)
    elif family == "IterativeSAAA":
        config = _saaa_task_config(synthetic_data, tmp_path)
    elif family == "ViTmBERTGeneration":
        config = _vit_mbert_config(evjvqa, tmp_path)
    else:
        config = _ocr_task_config(synthetic_data, tmp_path, "OcrOpenEndedTask", _iterative_m4c(),
                                  "OcrFeatureDataset")
    task = builders.build_task(config, "cpu")
    assert type(task.model).__name__ == family
    host, batch = next(task.device_batches(task.train_dict_dataloader))
    samples = torch.from_numpy(_fixed_samples(task, host))
    reward = task.scst_rewards(host, samples.numpy())
    advantages = torch.from_numpy(reward - reward.mean(-1, keepdims=True))
    assert bool(advantages.abs().sum() > 0)
    task.optimizer.zero_grad(set_to_none=True)
    task.scst_loss(batch, advantages, samples).backward()
    frozen = 0
    for name, param in task.model.named_parameters():
        if not param.requires_grad:
            frozen += 1
            assert param.grad is None, name
            continue
        assert param.grad is not None and bool(torch.isfinite(param.grad).all()), name
        assert name.endswith(GRADIENT_FREE) or float(param.grad.abs().max()) > 0.0, name
    assert (frozen > 0) == (family in ("ViTmBERTGeneration", "IterativeSAAA"))
