"""The port's scale-out on the CPU: DDP and FSDP training in two gloo
processes, SCST's re-run under DDP, a model with unread parameters under DDP,
TRAINING.REMAT with dropout on, and the refusal of tensor parallelism, on
narrow MMF_M4C (TrainingMMF) and SAAA (ClassificationTask) tasks.

A data-parallel step over a global batch is the JAX package's one step over
that batch on its data mesh: each rank here takes its round-robin share of
the batches (``batch_size`` rows each), and one process at twice the batch size
reads the same samples, step for step (the 11 train samples make 6 batches of
2, or 3 of 4).  Tolerances are stated where they are used.  The workers
import the port only; the JAX package runs in this process.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from openvivqa_tpu_torch.config import ConfigNode
from test_torch_port_multihost import (
    D,
    build,
    classification_config,
    mmf_m4c_config,
    params_of,
    run_ranks,
)

KINDS = ("MMF_M4C", "SAAA")
NEAR_EPS = 1e-6  # |g| below which Adam's eps (1e-8) makes a step sensitive to the last bits


def _config(kind, paths, root, **kwargs):
    if kind == "MMF_M4C":
        return mmf_m4c_config(paths, root, **kwargs)
    return classification_config(paths, root, **kwargs)


def _no_dropout(task):
    """Every dropout rate 0, the BERT layers' fixed 0.1 and SAAA's classifier
    0.5 included (the latter a module constant: call in a worker, or under
    monkeypatch)."""
    from openvivqa_tpu_torch.models import saaa

    saaa.CLASSIFIER_DROPOUT = 0.0
    for module in task.model.modules():
        if isinstance(getattr(module, "dropout", None), float):
            module.dropout = 0.0


def _first_batch(task):
    return next(task.device_batches(task.train_dataloader))[1]


# -- a DDP epoch ----------------------------------------------------------------------------------
def _ddp_epoch(rank, kind, paths, root):
    task = build(_config(kind, paths, root, batch_size=2, dropout=0.0))
    _no_dropout(task)
    losses = task.train()
    return {"losses": losses, "params": params_of(task), "ddp": type(task.wrapper).__name__,
            "find_unused": task.wrapper.find_unused_parameters}


@pytest.mark.parametrize("kind", KINDS)
def test_two_process_ddp_epoch_equals_one_process_over_the_global_batches(synthetic_data,
                                                                          tmp_path, kind,
                                                                          monkeypatch):
    """One epoch (3 steps) in two processes at 2 rows each, dropout 0,
    against one process at 4 rows: the same per-step global losses (rtol
    1e-5) and the same weights after the three Adam steps, within 1e-3 lr a
    step (the JAX parity tests' rule) and at least 2e-6: the ranks' averaged
    gradients differ from the single backward's in their last bits, and Adam
    moves a weight by about lr * sign(g) (lr up to 1.8e-4 and 1e-2 here).
    Where Adam's second moment puts |g| within a few orders of its 1e-8
    (NEAR_EPS: zero-padded region rows feed such gradients to the vision
    projection), the same last bits move the weight by a share of lr that
    grows as |g| shrinks: those elements, under 2 % of the weights, are held
    to the three steps' bound, 3 lr on each side.  Neither model leaves a
    trainable parameter unread, so DDP runs without find_unused_parameters."""
    from openvivqa_tpu_torch.models import saaa

    monkeypatch.setattr(saaa, "CLASSIFIER_DROPOUT", saaa.CLASSIFIER_DROPOUT)
    results = run_ranks(_ddp_epoch, kind, synthetic_data, tmp_path / "ddp")
    single = build(_config(kind, synthetic_data, tmp_path / "single", batch_size=4,
                           dropout=0.0))
    _no_dropout(single)
    want_losses = single.train()
    want = params_of(single)
    assert len(want_losses) == 3
    lr = max(single.scheduler.get_last_lr())
    beta2 = single.optimizer.param_groups[0]["betas"][1]
    rms = {name: np.sqrt(single.optimizer.state[p]["exp_avg_sq"].numpy() / (1 - beta2 ** 3))
           for name, p in single.model.named_parameters()
           if p in single.optimizer.state}  # a parameter without a gradient has no state
    # an element whose gradient was 0 at every step has not moved on either side
    small = {name: (value > 0) & (value < NEAR_EPS) for name, value in rms.items()}
    assert sum(int(m.sum()) for m in small.values()) < 0.02 * sum(m.size for m in small.values())
    for result in results:
        assert (result["ddp"], result["find_unused"]) == ("DistributedDataParallel", False)
        np.testing.assert_allclose(result["losses"], want_losses, rtol=1e-5)
        for name, value in result["params"].items():
            near = small.get(name, np.zeros(value.shape, bool))
            assert np.abs(value - want[name])[near].max(initial=0.0) <= 6 * lr, name
            np.testing.assert_allclose(value[~near], want[name][~near],
                                       atol=max(2e-6, 3e-3 * lr), rtol=0, err_msg=name)
    for name in want:
        np.testing.assert_array_equal(results[0]["params"][name], results[1]["params"][name])


# -- the DDP step against the JAX package's global step -------------------------------------------
def _ddp_step_from(rank, paths, root, state):
    task = build(mmf_m4c_config(paths, root, batch_size=2, dropout=0.0))
    _no_dropout(task)
    task.model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    loss = task._train_step(_first_batch(task))
    return float(loss), params_of(task)


def test_two_process_ddp_step_equals_the_jax_global_step(synthetic_data, tmp_path):
    """Two processes' DDP step on MMF_M4C (2 rows each, dropout 0) against
    the JAX package's TrainingMMF._train_step over the global batch of 4 on
    one device, at the same bridged weights (the parity harness of
    test_torch_port_train.py, whose tolerances hold here: loss rtol 1e-5,
    weights atol 2e-6 after the first Adam step at lr 1.8e-4)."""
    import types

    import jax
    import jax.numpy as jnp

    from openvivqa_tpu.models.mmf_m4c import MMF_M4C as JaxMMF
    from openvivqa_tpu.training import optim as joptim
    from openvivqa_tpu.training.tasks.ocr_tasks import TrainingMMF as JaxTrainingMMF
    from openvivqa_tpu.training.train_state import TrainState
    from openvivqa_tpu_torch.models.convert import params_from_flax

    config = mmf_m4c_config(synthetic_data, tmp_path / "jax", batch_size=4, dropout=0.0)
    single = build(config)
    host = next(iter(single.train_dataloader))
    jax_batch = {key: jnp.asarray(value) for key, value in host.arrays().items()}
    jax_model = JaxMMF(config.MODEL, single.vocab)
    variables = jax.jit(lambda r, b: jax_model.init({"params": r, "dropout": r}, b, train=False))(
        jax.random.PRNGKey(0), jax_batch)
    params = jax.tree.map(np.asarray, variables["params"])
    state = TrainState.create(
        lambda v, b, train, rngs: jax_model.apply(v, b, train=False), params, {},
        joptim.make_optimizer(joptim.noam_schedule(1.0, D, 100)),
    )
    stub = types.SimpleNamespace(vocab=single.vocab, maybe_remat=lambda fn: fn)
    new_state, jax_loss = jax.jit(lambda s, b, r: JaxTrainingMMF._train_step(stub, s, b, r))(
        state, jax_batch, jax.random.PRNGKey(1))
    want = params_from_flax(jax.tree.map(np.asarray, new_state.params))

    results = run_ranks(_ddp_step_from, synthetic_data, tmp_path / "ddp", params_from_flax(params))
    for loss, got in results:
        assert loss == pytest.approx(float(jax_loss), rel=1e-5)
        for name, value in got.items():
            np.testing.assert_allclose(value, want[name], atol=2e-6, rtol=0, err_msg=name)


# -- an FSDP step ---------------------------------------------------------------------------------
def _local(tensor):
    return tensor.to_local() if hasattr(tensor, "to_local") else tensor


def _fsdp_step(rank, paths, root):
    from openvivqa_tpu_torch.training.checkpoint import full_state

    fsdp_config = mmf_m4c_config(paths, root, batch_size=2, dropout=0.0, name="fsdp",
                                 MESH={"FSDP": True})
    task = build(fsdp_config)
    _no_dropout(task)
    batch = _first_batch(task)
    loss = float(task._train_step(batch))
    named = dict(task.model.named_parameters())
    sharded = {name: (tuple(p.shape), tuple(_local(p).shape), str(p.placements))
               for name, p in named.items()}
    moments = {name: tuple(_local(task.optimizer.state[p]["exp_avg"]).shape)
               for name, p in named.items()}
    full, _ = full_state(task.wrapper, task.optimizer, task._parameter_names())
    with task.eval_weights():
        whole = {name: type(p).__name__ for name, p in task.model.named_parameters()}
        scores = task.model(batch)["scores"].detach().numpy()
    task.epoch = 2
    task.save_checkpoint({"best_val_score": 0.5, "patience": 1})

    ddp = build(mmf_m4c_config(paths, root, batch_size=2, dropout=0.0, name="ddp", MESH={}))
    _no_dropout(ddp)
    ddp_loss = float(ddp._train_step(batch))
    ddp_scores = ddp.model.eval()(batch)["scores"].detach().numpy()

    resumed = build(fsdp_config)
    metadata = resumed.load_checkpoint(f"{task.checkpoint_path}/last_model.pth")
    same = all(
        str(p.placements) == str(named[name].placements)
        and torch.equal(_local(p), _local(named[name]))
        and all(torch.equal(_local(resumed.optimizer.state[p][key]),
                            _local(task.optimizer.state[named[name]][key]))
                for key in ("exp_avg", "exp_avg_sq", "step"))
        for name, p in resumed.model.named_parameters())
    # the sharded backend: each rank writes and reads its own shards
    os.environ["OPENVIVQA_CKPT_BACKEND"] = "orbax"
    task.save_checkpoint({"best_val_score": 0.5, "patience": 1})
    from_shards = build(fsdp_config)
    from_shards.load_checkpoint(f"{task.checkpoint_path}/last_model.pth")
    same_from_shards = all(
        torch.equal(_local(p), _local(named[name]))
        and torch.equal(_local(from_shards.optimizer.state[p]["exp_avg_sq"]),
                        _local(task.optimizer.state[named[name]]["exp_avg_sq"]))
        for name, p in from_shards.model.named_parameters())
    return {"loss": loss, "ddp_loss": ddp_loss, "sharded": sharded, "moments": moments,
            "full": {k: v.numpy() for k, v in full.items()}, "ddp": params_of(ddp),
            "whole": whole, "scores": scores, "ddp_scores": ddp_scores,
            "metadata": metadata, "resumed_same": same, "from_shards": same_from_shards}


def test_two_process_fsdp_step_shards_updates_as_ddp_and_resumes(synthetic_data, tmp_path):
    """TRAINING.MESH.FSDP in two processes on MMF_M4C (dropout 0): every
    parameter of two or more rows and its Adam moments are stored as shards
    over the data axis, half the rows on each rank; the full weights after
    one step (gathered as the checkpoint gathers them) equal a DDP step's on
    the same batches (atol 1e-6: the same reduction, in another order); eval
    inside eval_weights reads whole tensors and gives DDP's scores (atol
    1e-5); a fresh task resumes the saved checkpoint into the same
    placements, shards and Adam moments, with its metadata, both from the
    gathered single file and from the sharded backend's per-rank shards."""
    results = run_ranks(_fsdp_step, synthetic_data, tmp_path)
    split = 0
    for rank, result in enumerate(results):
        assert result["loss"] == pytest.approx(result["ddp_loss"], rel=1e-6)
        for name, (full_shape, local_shape, placements) in result["sharded"].items():
            assert placements == "(Shard(dim=0),)", name
            if full_shape[0] >= 2:
                assert local_shape[0] == -(-full_shape[0] // 2) or rank == 1, name
                assert local_shape[0] < full_shape[0], name
                assert result["moments"][name] == local_shape, name
                split += 1
        assert set(result["whole"].values()) == {"Parameter"}
        np.testing.assert_allclose(result["scores"], result["ddp_scores"], atol=1e-5)
        assert result["metadata"] == {"epoch": 2, "step": 1, "best_val_score": 0.5,
                                      "patience": 1}
        assert result["resumed_same"] and result["from_shards"]
    assert split > 0
    full, ddp = results[0]["full"], results[0]["ddp"]
    assert results[1]["full"] == {}
    assert sorted(full) == sorted(ddp)
    for name in ddp:
        np.testing.assert_allclose(full[name], ddp[name], atol=1e-6, rtol=0, err_msg=name)


# -- SCST's re-run under DDP ----------------------------------------------------------------------
def iterative_mcan_config(paths, root, **training):
    attn = {"ARCHITECTURE": "ScaledDotProductAttention", "HEAD": 2, "D_MODEL": D, "D_KEY": 16,
            "D_VALUE": 16, "D_FF": 2 * D, "USE_AOA": False, "CAN_BE_STATEFUL": False,
            "DROPOUT": 0.1}
    text = {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": D, "D_EMBEDDING": D, "DROPOUT": 0.1,
            "WORD_EMBEDDING": None, "WORD_EMBEDDING_CACHE": None}
    dataset = {"BATCH_SIZE": 4, "WORKERS": 1, "MAX_REGIONS": 36,
               "FEATURE_PATH": {"FEATURES": paths["features"]}}
    jp = {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["test"]}
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
        "TRAINING": {"CHECKPOINT_PATH": str(root), "LEARNING_RATE": 1.0, "WARMUP": 100,
                     "SCORE": "CIDEr", "TRAINING_BEAM_SIZE": 2, "EVALUATING_BEAM_SIZE": 2,
                     "PATIENCE": 2, "MAX_EPOCHS": 1, "SEED": 11, **training},
        "MODEL": {
            "NAME": "iterative_mcan_scale_out", "ARCHITECTURE": "IterativeMCAN", "D_MODEL": D,
            "VISION_EMBEDDING": {"ARCHITECTURE": "FeatureEmbedding", "D_FEATURE": 1024,
                                 "D_MODEL": D, "DROPOUT": 0.1},
            "TEXT_EMBEDDING": text,
            "SELF_ENCODER": {"ARCHITECTURE": "Encoder", "D_MODEL": D, "LAYERS": 1,
                             "SELF_ATTENTION": attn},
            "GUIDED_ENCODER": {"ARCHITECTURE": "GuidedAttentionEncoder", "D_MODEL": D,
                               "LAYERS": 1, "SELF_ATTENTION": attn, "GUIDED_ATTENTION": attn},
            "MULTIMODAL_FUSION": {"D_MODEL": D, "D_FF": 2 * D, "DROPOUT": 0.1},
            "DECODER": {"ARCHITECTURE": "Decoder", "D_MODEL": D, "LAYERS": 1,
                        "ATTENTION": {"SELF_ATTENTION": dict(attn, CAN_BE_STATEFUL=True),
                                      "ENC_ATTENTION": attn},
                        "TEXT_EMBEDDING": text},
        },
    })


def _scst_rerun(rank, paths, root):
    task = build(iterative_mcan_config(paths, root))
    batch = _first_batch(task)
    rng = np.random.default_rng(rank)
    n, k, length = batch["region_features"].shape[0], 2, task.vocab.max_answer_length
    outs = torch.from_numpy(rng.integers(4, len(task.vocab), (n, k, length)))
    advantages = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))

    def grads():
        out = {name: p.grad.clone().numpy() for name, p in task.model.named_parameters()
               if p.grad is not None}
        task.optimizer.zero_grad(set_to_none=True)
        return out

    # the bare model's gradient of this rank's loss (no collective), then train_scst's route
    task.scst_loss(batch, advantages, outs).backward()
    local = grads()
    task.train_forward(task.scst_loss, batch, advantages, outs).backward()
    return local, grads(), type(task.wrapper).__name__


def test_scst_rerun_under_ddp_averages_gradients_across_ranks(synthetic_data, tmp_path):
    """SCST's teacher-forced re-run (IterativeMCAN, OpenEndedTask) in two
    processes, each on its own batch, samples and advantages: train_scst runs
    the re-run inside the DDP wrapper's forward, so both ranks end with the
    mean of the two ranks' own gradients (atol 1e-6), where a re-run that
    bypassed the wrapper would leave each rank its own."""
    results = run_ranks(_scst_rerun, synthetic_data, tmp_path)
    (local0, ddp0, kind), (local1, ddp1, _) = results
    assert kind == "DistributedDataParallel"
    assert sorted(ddp0) == sorted(ddp1) == sorted(local0)
    differ = 0
    for name in local0:
        mean = (local0[name] + local1[name]) / 2
        np.testing.assert_allclose(ddp0[name], mean, atol=1e-6, rtol=0, err_msg=name)
        np.testing.assert_allclose(ddp1[name], mean, atol=1e-6, rtol=0, err_msg=name)
        differ += not np.allclose(local0[name], local1[name])
    assert differ > 0


# -- a model with unread parameters under DDP -------------------------------------------------------
def lorra_config(paths, root):
    branch = {"HEAD": 1, "D_KEY": 8, "D_VALUE": 8, "D_MODEL": D}
    config = mmf_m4c_config(paths, root, batch_size=2, LEARNING_RATE=0.1).to_dict()
    config["TASK"] = "MmfClassificationTask"
    config["DATASET"]["FEATURE_DATASET"]["TYPE"] = "OcrClassificationDataset"
    config["DATASET"]["VOCAB"].update(TYPE="OcrClassificationVocab", MAX_SCENE_TEXT=8)
    del config["DATASET"]["DICT_DATASET"]
    config["MODEL"] = {
        "NAME": "lorra_scale_out", "ARCHITECTURE": "MMF_LoRRA", "D_MODEL": D, "MAX_SCENE_TEXT": 8,
        "TEXT_EMBEDDING": {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": D, "D_EMBEDDING": 16,
                           "DROPOUT": 0.1, "WORD_EMBEDDING": None},
        "OBJECT_EMBEDDING": {"D_FEATURE": 1024, "DROPOUT": 0.1},
        "OCR_EMBEDDING": {"D_FEATURE": 300, "DROPOUT": 0.1},
        "SELF_ATTENTION": branch, "SPATIAL_ATTENTION": branch, "CONTEXT_ATTENTION": branch}
    return ConfigNode(config)


def _lorra_steps(rank, paths, root):
    task = build(lorra_config(paths, root))
    losses = [float(task._train_step(batch)) for _, batch in task.device_batches(
        task.train_dataloader)]
    unread = sorted(name for name, p in task.model.named_parameters() if p.grad is None)
    return losses, task.wrapper.find_unused_parameters, unread


def test_lorra_under_ddp_trains_with_its_unread_parameters(synthetic_data, tmp_path):
    """MMF_LoRRA's spatial and context attentions never read their value and
    output projections: the probe of the first step finds them, DDP runs with
    find_unused_parameters, and a whole epoch (3 steps) trains, finite, where
    DDP without it raises at the second step."""
    for losses, find_unused, unread in run_ranks(_lorra_steps, synthetic_data, tmp_path):
        assert len(losses) == 3 and all(np.isfinite(losses))
        assert find_unused
        assert unread and all(".fc_v." in name or ".fc_o." in name for name in unread)


# -- TRAINING.REMAT -------------------------------------------------------------------------------
def _grads_and_stream(task, batch, calls):
    task.generator.manual_seed(1234)
    task.optimizer.zero_grad(set_to_none=True)
    calls.clear()
    task.compute_loss(batch).backward()
    grads = {name: p.grad.clone() for name, p in task.model.named_parameters()
             if p.grad is not None}
    return grads, task.generator.get_state(), len(calls)


@pytest.mark.parametrize("kind", ["MMF_M4C", "MCAN"])
def test_remat_keeps_gradients_and_the_generator_stream(synthetic_data, tmp_path, kind,
                                                        monkeypatch):
    """TRAINING.REMAT with dropout 0.1 (MMF_M4C's dropout attention and BERT
    dropouts, MCAN's dropouts): each layer's forward runs again in the
    backward (its attention is called twice as often), and the gradients and
    the generator's state after the step equal the run without REMAT bit for
    bit.  With torch.utils.checkpoint's own RNG handling alone (the task's
    generator not restored for the recomputation) the gradients differ: the
    recomputation draws new masks."""
    from openvivqa_tpu_torch.training.tasks import base_task

    def config(**training):
        if kind == "MMF_M4C":
            return mmf_m4c_config(synthetic_data, tmp_path / str(training), **training)
        return classification_config(synthetic_data, tmp_path / str(training), arch="MCAN",
                                     **training)

    plain, remat = build(config()), build(config(REMAT=True))
    batch = _first_batch(plain)
    calls = []
    for task in (plain, remat):
        first = base_task.layer_modules(task.model)[0]
        attention = next(m for m in first.children() if next(m.parameters(), None) is not None)
        attention.register_forward_hook(lambda *args: calls.append(1))
    want, want_state, n_plain = _grads_and_stream(plain, batch, calls)
    got, got_state, n_remat = _grads_and_stream(remat, batch, calls)
    assert n_plain >= 1 and n_remat == 2 * n_plain
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert torch.equal(got_state, want_state)

    monkeypatch.setattr(base_task, "_generator_contexts",
                        lambda generator: (contextlib.nullcontext(), contextlib.nullcontext()))
    careless = build(config(REMAT=True))
    careless_grads, _, _ = _grads_and_stream(careless, batch, calls)
    assert any(not torch.equal(careless_grads[name], want[name]) for name in want)


# -- tensor parallelism -----------------------------------------------------------------------------
def test_model_parallel_mesh_is_refused(synthetic_data, tmp_path):
    """MESH.MODEL_PARALLEL 2 raises NotImplementedError naming ROADMAP,
    before anything needs a process group: no run falls back to data
    parallelism."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build(mmf_m4c_config(synthetic_data, tmp_path, MESH={"MODEL_PARALLEL": 2}))


def test_mesh_without_a_process_group_is_refused(synthetic_data, tmp_path):
    with pytest.raises(RuntimeError, match="process group"):
        build(mmf_m4c_config(synthetic_data, tmp_path, MESH={"FSDP": True}))
