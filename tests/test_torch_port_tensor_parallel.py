"""Tensor parallelism of the port on the CPU: ``TRAINING.MESH.MODEL_PARALLEL``
over gloo processes, against the JAX package's mesh and against the same
model on one model rank.

The placement rule (``parallel.mesh.param_placement``) is held to the JAX
package's ``param_partition_spec`` on a grid of shapes and, through the
bridge's name map, on the flax trees of three models.  Two spawned ranks at
``(data 1, model 2)`` then run MMF_M4C (a train step against the JAX step
under ``get_mesh_2d(2, 2)``, incremental greedy eval, a dropout step, both
checkpoint directions), IterativeMCAN's beam eval, and every model family
whose weights a kernel bundle or a direct read takes through
``parallel.mesh.whole`` (the M4C variants, the standalone M4C, LoRRA,
ALBERT, DeBERTa, ViT); four ranks at ``(data 2, model 2)`` train SAAA under
FSDP and resume.  Every worker imports the port only (``run_ranks``); the
JAX package runs in this process.  Tolerances are stated where they are
used.
"""

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
from test_torch_port_scale_out import _first_batch, iterative_mcan_config

TP = {"MODEL_PARALLEL": 2}
INCREMENTAL = {"MODEL": {"DECODING_MODE": "incremental"}}


def _zero_dropout(task):
    for module in task.model.modules():
        if isinstance(getattr(module, "dropout", None), float):
            module.dropout = 0.0


def _whole_params(model):
    from openvivqa_tpu_torch.parallel.mesh import whole

    return {name: whole(p).detach().clone().numpy() for name, p in model.named_parameters()}


def _load_whole(model, state):
    """A one-process state dict (numpy arrays or tensors) into `model`,
    distributed onto its DTensors' placements."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions, set_model_state_dict

    set_model_state_dict(model, {k: torch.as_tensor(v) for k, v in state.items()},
                         options=StateDictOptions(full_state_dict=True))


def _placements(model):
    return {name: str(getattr(p, "placements", "whole")) for name, p in model.named_parameters()}


def _whole_moments(task):
    """{parameter name: (exp_avg, exp_avg_sq)}, whole, of the task's Adam state."""
    from openvivqa_tpu_torch.parallel.mesh import whole

    out = {}
    for name, p in task.model.named_parameters():
        state = task.optimizer.state.get(p)
        if state:
            out[name] = tuple(whole(state[key]).detach().clone().numpy()
                              for key in ("exp_avg", "exp_avg_sq"))
    return out


# -- (i) the placement rule ---------------------------------------------------------------------
SHAPES = [(a, b) for a in (1, 4, 7, 8, 9, 16, 33, 64) for b in (1, 2, 3, 4, 6, 8, 12, 30, 32)]


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("layout", ["Linear", "Embedding"])
def test_param_placement_agrees_with_the_jax_rule(mp, layout):
    """Every 2-D shape of the grid at `mp` model ranks: the port splits an
    nn.Linear weight (out, in) along dim 0 and an nn.Embedding table (num,
    dim) along dim 1 exactly where the JAX rule splits the flax leaf ((in,
    out) for a Dense kernel, (num, dim) for an Embed table) along its last
    dim; 1-D and 3-D leaves stay whole on both sides, and nn.LSTM's weights
    stay whole in the port (its cuDNN buffer)."""
    from jax.sharding import PartitionSpec

    from openvivqa_tpu.parallel.mesh import get_mesh_2d as jax_mesh_2d
    from openvivqa_tpu.parallel.mesh import param_partition_spec
    from openvivqa_tpu_torch.parallel.mesh import param_placement
    from torch.distributed.tensor import Replicate, Shard

    mesh = jax_mesh_2d(n_devices=mp, model_parallel=mp)
    split_dim = 0 if layout == "Linear" else 1
    for flax_shape in SHAPES:
        leaf = np.zeros(flax_shape, np.float32)
        jax_splits = param_partition_spec(leaf, mesh) == PartitionSpec(None, "model")
        if layout == "Linear":
            module = torch.nn.Linear(flax_shape[0], flax_shape[1])
        else:
            module = torch.nn.Embedding(*flax_shape)
        got = param_placement(module, "weight", module.weight, mp)
        assert got == (Shard(split_dim) if jax_splits else Replicate()), flax_shape
    for shape in ((8,), (4, 8, 16)):
        assert param_partition_spec(np.zeros(shape), mesh) == PartitionSpec()
        assert param_placement(torch.nn.Module(), "w", torch.zeros(shape), mp) == Replicate()
    lstm = torch.nn.LSTM(16, 32)
    assert param_placement(lstm, "weight_ih_l0", lstm.weight_ih_l0, mp) == Replicate()


def _flax_origins(task, config):
    """{port parameter name: set of flax leaf paths it is made of}, through
    ``params_from_flax``: each flax leaf (shapes from ``jax.eval_shape``) is
    filled with its own index, and the bridged tensors say which leaves they
    hold."""
    import jax
    import jax.numpy as jnp

    from openvivqa_tpu.builders import META_ARCHITECTURE as JAX_ARCHITECTURE
    from openvivqa_tpu.builders import populate as populate_jax
    from openvivqa_tpu_torch.models.convert import params_from_flax

    populate_jax()
    host = next(iter(task.train_dataloader))
    batch = {key: jnp.asarray(value) for key, value in host.arrays().items()}
    jax_model = JAX_ARCHITECTURE.get(config.MODEL.ARCHITECTURE)(config=config.MODEL,
                                                               vocab=task.vocab)
    shapes = jax.eval_shape(
        lambda r: jax_model.init({"params": r, "dropout": r}, batch, train=False),
        jax.random.PRNGKey(0))["params"]
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    marked = jax.tree_util.tree_unflatten(treedef, [
        np.full(leaf.shape, i + 1, np.float32) for i, (_, leaf) in enumerate(flat)])
    paths = ["/".join(str(getattr(k, "key", k)) for k in path) for path, _ in flat]
    state = params_from_flax(marked, config.MODEL)
    origins = {}
    for name, value in state.items():
        ids = {int(v) for v in np.unique(value) if v > 0}
        origins[name] = {(paths[i - 1], flat[i - 1][1].shape) for i in ids}
    return origins


@pytest.mark.parametrize("arch", ["SAAA", "IterativeMCAN", "MMF_M4C"])
def test_split_parameters_are_the_flax_leaves_the_jax_rule_splits(synthetic_data, tmp_path,
                                                                  arch):
    """At 2 model ranks, each parameter of the test-size model that the
    port's rule splits is bridged from one flax leaf that the JAX rule splits,
    and each flax leaf that the JAX rule splits lands in a parameter the port
    splits, with one exception, named: nn.LSTM's weights, which the bridge
    assembles from the flax cell's gate kernels and which stay whole in the
    port.  A split Linear's bias is a DTensor whole over ``model``, as JAX
    keeps 1-D leaves whole."""
    from jax.sharding import PartitionSpec

    from openvivqa_tpu.parallel.mesh import get_mesh_2d as jax_mesh_2d
    from openvivqa_tpu.parallel.mesh import param_partition_spec
    from openvivqa_tpu_torch.parallel.mesh import param_placement
    from torch.distributed.tensor import Shard

    if arch == "SAAA":
        config = classification_config(synthetic_data, tmp_path)
    elif arch == "IterativeMCAN":
        config = iterative_mcan_config(synthetic_data, tmp_path)
    else:
        config = mmf_m4c_config(synthetic_data, tmp_path)
    task = build(config)
    origins = _flax_origins(task, config)
    mesh = jax_mesh_2d(n_devices=2, model_parallel=2)
    owners = dict(task.model.named_modules())
    port_splits, lstm = set(), set()
    for name, p in task.model.named_parameters():
        owner = owners[name.rpartition(".")[0]]
        if isinstance(owner, torch.nn.LSTM):
            lstm.add(name)
        elif isinstance(param_placement(owner, name.rpartition(".")[2], p, 2), Shard):
            port_splits.add(name)
    jax_splits = {leaf for leaves in origins.values() for leaf in leaves
                  if param_partition_spec(np.zeros(leaf[1]), mesh) == PartitionSpec(None, "model")}
    assert port_splits
    for name in port_splits:
        assert len(origins[name]) == 1 and origins[name] <= jax_splits, name
    reached = {leaf for name in port_splits | lstm for leaf in origins[name]}
    assert jax_splits <= reached, sorted(jax_splits - reached)
    assert bool(lstm) == (arch == "SAAA")


# -- (ii), (iii), (vi), (vii): MMF_M4C at (data 1, model 2) ---------------------------------------
def _state_dict(task):
    return {k: v.detach().clone() for k, v in task.model.state_dict().items()}


def _mmf_ranks(rank, paths, root, jax_state, mp1_checkpoint):
    from openvivqa_tpu_torch.models.modules import bert
    from openvivqa_tpu_torch.parallel.mesh import data_shard

    out = {}
    config = mmf_m4c_config(paths, root / "tp", batch_size=4, dropout=0.0, MESH=TP)
    incremental = build(config.merged(INCREMENTAL))
    _load_whole(incremental.model, jax_state)
    _, dev = next(incremental.device_batches(incremental.dev_dict_dataloader))
    with torch.no_grad():
        with incremental.eval_weights():
            out["eval_types"] = {type(p).__name__ for p in incremental.model.parameters()}
            out["greedy"] = incremental.model.greedy_decode(dev)["prev_inds"].numpy()
        # outside eval_weights: column-parallel Linears and whole() in the bundles
        out["greedy_sharded"] = incremental.model.greedy_decode(dev)["prev_inds"].numpy()

    task = build(config)
    _zero_dropout(task)
    _load_whole(task.model, jax_state)
    out["placements"] = _placements(task.model)
    out["shard"] = data_shard()
    batch = _first_batch(task)
    out["loss"] = float(task._train_step(batch))
    out["params"] = _whole_params(task.model)
    out["moments"] = _whole_moments(task)
    task.epoch = 1
    task.save_checkpoint({"best_val_score": 0.25, "patience": 0})
    out["checkpoint"] = f"{task.checkpoint_path}/last_model.pth"

    # dropout on: one step's masks, gradients and generator stream
    from openvivqa_tpu_torch.parallel.mesh import whole

    for module in task.model.modules():
        if isinstance(getattr(module, "dropout", None), float):
            module.dropout = 0.1
    state = task.generator.get_state()
    probe = torch.Generator().manual_seed(0)
    probe.set_state(state)
    out["mask"] = bert.dropout(torch.ones(4096), 0.5, probe).numpy()
    out["dropout_loss"] = float(task._train_step(batch))
    out["dropout_params"] = {name: whole(p).detach().clone().numpy()
                             for name, p in task.model.named_parameters()
                             if not hasattr(p, "placements")}
    out["generator"] = task.generator.get_state().numpy()

    # TRAINING.REMAT at two model ranks: the same gradients and generator stream
    def grads_of(remat):
        fresh = build(config.merged({"TRAINING": {"REMAT": remat, "CHECKPOINT_PATH": str(
            root / f"remat_{remat}")}}))
        _load_whole(fresh.model, jax_state)
        for module in fresh.model.modules():
            if isinstance(getattr(module, "dropout", None), float):
                module.dropout = 0.1
        fresh.generator.manual_seed(1234)
        fresh.compute_loss(_first_batch(fresh)).backward()
        return ({name: whole(p.grad).detach().clone() for name, p in
                 fresh.model.named_parameters() if p.grad is not None},
                fresh.generator.get_state())

    (plain, plain_state), (remat, remat_state) = grads_of(False), grads_of(True)
    out["remat_equal"] = (sorted(plain) == sorted(remat) and torch.equal(plain_state, remat_state)
                          and all(torch.equal(plain[k], remat[k]) for k in plain))

    # the other direction: a checkpoint written at model parallel 1 resumes at 2
    resumed = build(config.merged({"TRAINING": {"CHECKPOINT_PATH": str(root / "from_mp1")}}))
    out["from_mp1_meta"] = resumed.load_checkpoint(mp1_checkpoint)
    out["from_mp1_placements"] = _placements(resumed.model)
    out["from_mp1_params"] = _whole_params(resumed.model)
    out["from_mp1_moments"] = _whole_moments(resumed)
    return out


def _beam_ranks(rank, paths, root, state):
    from openvivqa_tpu_torch.training.decode import generate

    task = build(iterative_mcan_config(paths, root / "beam_tp", MESH=TP))
    _load_whole(task.model, state)
    _, dev = next(task.device_batches(task.dev_dict_dataloader))
    task.model.eval()
    with torch.no_grad():
        with task.eval_weights():
            tokens, logprobs = generate(task.model, dev, 2)
        sharded_tokens, sharded_logprobs = generate(task.model, dev, 2)
    return {"tokens": tokens.numpy(), "logprobs": logprobs.numpy(),
            "sharded_tokens": sharded_tokens.numpy(),
            "sharded_logprobs": sharded_logprobs.numpy(),
            "split": sum(hasattr(p, "placements") for p in task.model.parameters())}


def _mmf_and_beam(rank, paths, root, jax_state, mp1_checkpoint, beam_state):
    return (_mmf_ranks(rank, paths, root, jax_state, mp1_checkpoint),
            _beam_ranks(rank, paths, root, beam_state))


@pytest.fixture(scope="module")
def one_by_two(synthetic_data, tmp_path_factory):
    """Both ranks' results at (data 1, model 2), the JAX package's step on its
    own (1, 2) mesh from the same bridged weights, and the one-rank
    references (the model-parallel-1 checkpoint written first)."""
    import jax
    import jax.numpy as jnp

    from openvivqa_tpu.models.mmf_m4c import MMF_M4C as JaxMMF
    from openvivqa_tpu.parallel.mesh import get_mesh_2d as jax_mesh_2d
    from openvivqa_tpu.parallel.mesh import shard_batch, shard_state
    from openvivqa_tpu.training import optim as joptim
    from openvivqa_tpu.training.tasks.ocr_tasks import TrainingMMF as JaxTrainingMMF
    from openvivqa_tpu.training.train_state import TrainState
    from openvivqa_tpu_torch.models.convert import params_from_flax

    import types

    root = tmp_path_factory.mktemp("tensor_parallel")
    config = mmf_m4c_config(synthetic_data, root / "jax", batch_size=4, dropout=0.0)
    single = build(config)
    host = next(iter(single.train_dataloader))
    jax_model = JaxMMF(config.MODEL, single.vocab)
    batch = {key: jnp.asarray(value) for key, value in host.arrays().items()}
    variables = jax.jit(lambda r, b: jax_model.init({"params": r, "dropout": r}, b, train=False))(
        jax.random.PRNGKey(0), batch)
    params = jax.tree.map(np.asarray, variables["params"])
    mesh = jax_mesh_2d(n_devices=2, model_parallel=2)
    state = shard_state(TrainState.create(
        lambda v, b, train, rngs: jax_model.apply(v, b, train=False), params, {},
        joptim.make_optimizer(joptim.noam_schedule(1.0, D, 100))), mesh)
    stub = types.SimpleNamespace(vocab=single.vocab, maybe_remat=lambda fn: fn)
    new_state, jax_loss = jax.jit(lambda s, b, r: JaxTrainingMMF._train_step(stub, s, b, r))(
        state, shard_batch(batch, mesh), jax.random.PRNGKey(1))
    jax_split = sum("model" in str(leaf.sharding.spec)
                    for leaf in jax.tree_util.tree_leaves(new_state.params))
    jax_state = params_from_flax(params)

    # one model rank: the same weights, incremental greedy, one step, a checkpoint
    one = build(mmf_m4c_config(synthetic_data, root / "mp1", batch_size=4, dropout=0.0))
    _zero_dropout(one)
    one.model.load_state_dict({k: torch.from_numpy(v) for k, v in jax_state.items()})
    one_incremental = build(one.config.merged(INCREMENTAL))
    one_incremental.model.load_state_dict(one.model.state_dict())
    _, dev = next(one_incremental.device_batches(one_incremental.dev_dict_dataloader))
    with torch.no_grad():
        greedy = one_incremental.model.greedy_decode(dev)["prev_inds"].numpy()
    one_loss = float(one._train_step(_first_batch(one)))
    one.epoch = 3
    one.save_checkpoint({"best_val_score": 0.5, "patience": 1})

    beam_one = build(iterative_mcan_config(synthetic_data, root / "beam_mp1"))
    _, beam_dev = next(beam_one.device_batches(beam_one.dev_dict_dataloader))
    from openvivqa_tpu_torch.training.decode import generate

    beam_one.model.eval()
    with torch.no_grad():
        beam_tokens, beam_logprobs = generate(beam_one.model, beam_dev, 2)

    results = run_ranks(_mmf_and_beam, synthetic_data, root, jax_state,
                        f"{one.checkpoint_path}/last_model.pth", _state_dict(beam_one))
    return {
        "ranks": results, "jax_loss": float(jax_loss), "jax_split": jax_split,
        "jax_params": params_from_flax(jax.tree.map(np.asarray, new_state.params)),
        "greedy": greedy, "one_loss": one_loss, "one_params": params_of(one),
        "one_moments": _whole_moments(one), "config": config, "root": root,
        "beam_tokens": beam_tokens.numpy(), "beam_logprobs": beam_logprobs.numpy(),
    }


def test_mmf_m4c_step_at_one_by_two_equals_the_jax_step_on_its_mesh(one_by_two):
    """One MMF_M4C step (4 rows, dropout 0) at (data 1, model 2) against the
    JAX package's TrainingMMF._train_step with its state placed by
    shard_state on get_mesh_2d(2, model_parallel=2): the same loss (rtol
    1e-5) and weights within 2e-6 after the first Adam step, the tolerance of
    the data-parallel step's JAX parity test.  Both sides split some weights
    over ``model``; both ranks read the whole batch (one data group)."""
    assert one_by_two["jax_split"] > 0
    for result, _ in one_by_two["ranks"]:
        assert result["shard"] == (1, 0)
        assert any("Shard" in p for p in result["placements"].values())
        assert result["loss"] == pytest.approx(one_by_two["jax_loss"], rel=1e-5)
        for name, value in result["params"].items():
            np.testing.assert_allclose(value, one_by_two["jax_params"][name], atol=2e-6, rtol=0,
                                       err_msg=name)


def test_mmf_m4c_incremental_greedy_at_two_model_ranks_equals_one(one_by_two):
    """Incremental greedy decode of one dev batch on the same weights: inside
    eval_weights (every parameter whole) and outside it (the column-parallel
    Linears, and whole() in every kernel bundle and tied read) the tokens
    equal the one-rank run's; the train step's loss too (rtol 1e-6)."""
    for result, _ in one_by_two["ranks"]:
        assert result["eval_types"] == {"Parameter"}
        np.testing.assert_array_equal(result["greedy"], one_by_two["greedy"])
        np.testing.assert_array_equal(result["greedy_sharded"], one_by_two["greedy"])
        assert result["loss"] == pytest.approx(one_by_two["one_loss"], rel=1e-6)


def test_model_ranks_draw_the_same_masks_and_keep_equal_replicated_parameters(one_by_two):
    """Dropout 0.1 on, one more step: the two model ranks of the data group
    hold the same generator stream (its first 4096 keep bits equal, and the
    states after the step), report the same loss and end with bit-equal
    replicated (not split) parameters.  Under TRAINING.REMAT at two model
    ranks the recomputation replays the generator: gradients and the state
    after the step equal the run without it bit for bit."""
    (first, _), (second, _) = one_by_two["ranks"]
    assert first["remat_equal"] and second["remat_equal"]
    np.testing.assert_array_equal(first["mask"], second["mask"])
    np.testing.assert_array_equal(first["generator"], second["generator"])
    assert first["dropout_loss"] == second["dropout_loss"]
    assert first["dropout_params"]
    for name, value in first["dropout_params"].items():
        np.testing.assert_array_equal(value, second["dropout_params"][name], err_msg=name)


def test_checkpoints_move_between_one_and_two_model_ranks(one_by_two):
    """The checkpoint written at model parallel 2 (whole state, primary
    only) resumes in one process at model parallel 1 with the ranks' whole
    weights and Adam moments, bit for bit, and its metadata; the checkpoint
    written at 1 resumes at 2 into the same placements as a fresh task's,
    with the one-rank weights and moments bit for bit."""
    (result, _), _ = one_by_two["ranks"]
    config = one_by_two["config"].merged({"TRAINING": {
        "CHECKPOINT_PATH": str(one_by_two["root"] / "mp2_to_mp1")}})
    resumed = build(config)
    meta = resumed.load_checkpoint(result["checkpoint"])
    assert meta == {"epoch": 1, "step": 1, "best_val_score": 0.25, "patience": 0}
    for name, value in params_of(resumed).items():
        np.testing.assert_array_equal(value, result["params"][name], err_msg=name)
    for name, moments in _whole_moments(resumed).items():
        for got, want in zip(moments, result["moments"][name]):
            np.testing.assert_array_equal(got, want, err_msg=name)

    assert result["from_mp1_meta"] == {"epoch": 3, "step": 1, "best_val_score": 0.5,
                                       "patience": 1}
    assert result["from_mp1_placements"] == result["placements"]
    for name, value in result["from_mp1_params"].items():
        np.testing.assert_array_equal(value, one_by_two["one_params"][name], err_msg=name)
    for name, moments in result["from_mp1_moments"].items():
        for got, want in zip(moments, one_by_two["one_moments"][name]):
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_iterative_mcan_beam_at_two_model_ranks_equals_one(one_by_two):
    """IterativeMCAN's beam-2 eval of one dev batch on the same weights at 2
    model ranks, inside and outside eval_weights: the sequences equal the
    one-rank run's and their log-probs agree within 1e-5."""
    for _, beam in one_by_two["ranks"]:
        assert beam["split"] > 0
        for key in ("", "sharded_"):
            np.testing.assert_array_equal(beam[key + "tokens"], one_by_two["beam_tokens"])
            np.testing.assert_allclose(beam[key + "logprobs"], one_by_two["beam_logprobs"],
                                       atol=1e-5, rtol=0)


# -- every family whose weights go through whole() ---------------------------------------------------
H, HEADS, VOCAB, MAXA = 32, 4, 24, 6
N_OBJ, N_OCR, N_GRID, QLEN = 4, 3, 5, 5


class Vocab:
    """A vocab of 24 words, 8 of them answers: the tied answer tables are
    even, so that two model ranks split them."""
    padding_idx, bos_idx, eos_idx, unk_idx = 0, 1, 2, 3
    img_idx, feat_idx, box_idx, ocr_idx, ocr_det_idx, ocr_rec_idx = 4, 5, 6, 7, 8, 9
    question_idx, answer_idx = 10, 11
    max_answer_length = MAXA
    total_answers = 8
    word_embeddings = None

    def __len__(self):
        return VOCAB


def _attention():
    return {"ARCHITECTURE": "ScaledDotProductAttention", "HEAD": HEADS, "D_MODEL": H,
            "D_KEY": H // HEADS, "D_VALUE": H // HEADS, "D_FF": 2 * H, "USE_AOA": False,
            "CAN_BE_STATEFUL": False, "DROPOUT": 0.1}


def _features(width):
    return {"ARCHITECTURE": "FeatureEmbedding", "D_FEATURE": width, "D_MODEL": H, "DROPOUT": 0.1}


_MMT = {"HIDDEN_SIZE": H, "NUM_HIDDEN_LAYERS": 2, "NUM_ATTENTION_HEADS": HEADS}
_MMF = {
    "D_MODEL": H, "MMT": _MMT, "TEXT_BERT": {"HIDDEN_SIZE": H, "NUM_HIDDEN_LAYERS": 1},
    "OBJECT_EMBEDDING": {"D_FEATURE": 12, "DROPOUT": 0.1},
    "OCR_EMBEDDING": {"D_FEATURE": 314, "DROPOUT": 0.1},
    "OCR_PTR_NET": {"HIDDEN_SIZE": H, "QUERY_KEY_SIZE": 16},
}
_USUAL = {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": H, "D_EMBEDDING": 16, "DROPOUT": 0.1,
          "WORD_EMBEDDING": None}
_BRANCH = {"HEAD": 1, "D_KEY": 8, "D_VALUE": 8, "D_MODEL": H}
FAMILIES = {
    "MMF_ImprovedDecodingM4C": _MMF,
    "MMF_IterativeM4C": {**_MMF, "ENCODER": {"LAYERS": 1, "HEAD": HEADS},
                         "DECODER": {"LAYERS": 2, "HEAD": HEADS}},
    "MMF_LanguageAdaptiveM4C": {**_MMF, "TEXT_BERT": {
        "HIDDEN_SIZE": H, "NUM_HIDDEN_LAYERS": 1, "D_LANGUAGE": 48, "PRETRAINED_LAYERS": 1,
        "PRETRAINED_HEADS": 2, "PRETRAINED_VOCAB_SIZE": VOCAB + 8}},
    "M4C": {
        "D_MODEL": H, "MMT": _MMT,
        "TEXT_BERT": {"HIDDEN_SIZE": H, "NUM_HIDDEN_LAYERS": 1, "INTERMEDIATE_SIZE": 48},
        "ENCODER": {"LAYERS": 2, "INTERMEDIATE_SIZE": 48, "SELF_ATTENTION": _attention()},
        "DYNAMIC_EMBEDDING": {"ARCHITECTURE": "FixedVocabDynamicEmbedding", "D_MODEL": H},
        "OBJECT_EMBEDDING": {"D_FEATURE": 12, "DROPOUT": 0.1},
        "OCR_EMBEDDING": {"D_FEATURE": 314, "DROPOUT": 0.1},
    },
    "IterativeM4C": {
        "D_MODEL": H, "REGION_EMBEDDING": _features(12), "GRID_EMBEDDING": _features(12),
        "BOX_EMBEDDING": _features(4), "OCR_DET_EMBEDDING": _features(6),
        "OCR_REC_EMBEDDING": _features(8), "TEXT_EMBEDDING": _USUAL,
        "OCR_TEXT_EMBEDDING": {"ARCHITECTURE": "OcrWordEmbedding", "D_MODEL": H,
                               "D_EMBEDDING": 300, "DROPOUT": 0.1},
        "DYNAMIC_EMBEDDING": {"ARCHITECTURE": "DynamicEmbedding", "D_MODEL": H},
        "ENCODER": {"ARCHITECTURE": "MultiModalEncoder", "D_MODEL": H, "LAYERS": 2,
                    "SELF_ATTENTION": _attention()},
    },
    "MMF_LoRRA": {
        "D_MODEL": H, "MAX_SCENE_TEXT": N_OCR, "TEXT_EMBEDDING": _USUAL,
        "OBJECT_EMBEDDING": {"D_FEATURE": 12, "DROPOUT": 0.1},
        "OCR_EMBEDDING": {"D_FEATURE": 300, "DROPOUT": 0.1},
        "SELF_ATTENTION": _BRANCH, "SPATIAL_ATTENTION": _BRANCH, "CONTEXT_ATTENTION": _BRANCH,
    },
    # the BERT-family backbones, built as modules
    "ALBERT": None, "DeBERTa": None, "ViT": None,
}


def _m4c_batch(bs=3, seed=13):
    rng = np.random.default_rng(seed)

    def feats(*shape):
        return rng.normal(size=shape).astype(np.float32)

    q = rng.integers(12, VOCAB, (bs, QLEN)).astype(np.int32)
    q[:, -1] = 0
    answers = rng.integers(12, VOCAB + N_OCR, (bs, MAXA)).astype(np.int32)
    answers[:, 0] = Vocab.bos_idx
    answers[0, -2:] = Vocab.padding_idx
    batch = {
        "question_tokens": q,
        "region_features": feats(bs, N_OBJ, 12), "region_boxes": feats(bs, N_OBJ, 4),
        "grid_features": feats(bs, N_GRID, 12), "grid_boxes": feats(bs, N_GRID, 4),
        "ocr_fasttext_features": feats(bs, N_OCR, 300), "ocr_rec_features": feats(bs, N_OCR, 8),
        "ocr_det_features": feats(bs, N_OCR, 6), "ocr_boxes": feats(bs, N_OCR, 4),
        "answer_tokens": answers,
        "answer": np.array([[1], [8], [VOCAB - 1]], np.int32)[:bs] % (Vocab.total_answers + N_OCR),
    }
    batch["shifted_right_answer_tokens"] = np.concatenate(
        [answers[:, 1:], np.zeros((bs, 1), np.int32)], axis=1)
    batch["region_features"][0, -1] = 0.0
    for key in ("ocr_fasttext_features", "ocr_rec_features", "ocr_det_features"):
        batch[key][1, -1] = 0.0
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _family_model(family):
    """(model, inputs) of `family`, its weights drawn from a fixed seed."""
    from openvivqa_tpu_torch.builders import META_ARCHITECTURE, populate
    from openvivqa_tpu_torch.models.modules import albert, deberta, vit

    populate()
    torch.manual_seed(3)
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(1, 40, (2, 7)))
    if family == "ALBERT":
        model = albert.AlbertEncoderStack(40, H, 2, HEADS, embedding_size=16,
                                          intermediate_size=64)
    elif family == "DeBERTa":
        model = deberta.DebertaV2EncoderStack(40, H, 2, HEADS, intermediate_size=64,
                                              position_buckets=4, max_relative_positions=8,
                                              share_att_key=True, norm_rel_ebd="layer_norm")
    elif family == "ViT":
        model = vit.ViTBackbone(H, 2, HEADS, 64, patch=8, image_size=16)
        ids = torch.from_numpy(rng.normal(size=(2, 16, 16, 3)).astype(np.float32))
    else:
        model = META_ARCHITECTURE.get(family)(ConfigNode({**FAMILIES[family],
                                                          "ARCHITECTURE": family}), Vocab())
        return model, _m4c_batch()
    if hasattr(model, "init_weights_"):
        model.init_weights_(torch.Generator().manual_seed(5))
    return model, ids


def _family_run(family, model, inputs):
    """The family's training loss (dropout 0.1 from a seeded generator) with
    its whole gradients, and its eval outputs, on `model` as it is (at 2
    model ranks: split, outside any eval_weights)."""
    from openvivqa_tpu_torch.parallel.mesh import whole
    from openvivqa_tpu_torch.training import decode
    from openvivqa_tpu_torch.training.train_state import bce_with_logits_loss

    out = {}
    if FAMILIES[family] is not None:
        batch = inputs
        model.train()
        scores = model(batch, generator=torch.Generator().manual_seed(7))
        if family == "MMF_LoRRA":
            loss = bce_with_logits_loss(scores["scores"], batch["answer"].reshape(-1))
        else:
            logprobs = scores if family == "IterativeM4C" else torch.log_softmax(
                scores["scores"], -1)
            loss = torch.nn.functional.nll_loss(
                logprobs.reshape(-1, logprobs.shape[-1]),
                batch["shifted_right_answer_tokens"].long().reshape(-1), ignore_index=0)
        loss.backward()
        out["loss"] = float(loss.detach())
        out["grads"] = {name: whole(p.grad).detach().clone().numpy()
                        for name, p in model.named_parameters() if p.grad is not None}
        model.eval()
    with torch.no_grad():
        if family == "IterativeM4C":
            tokens, logprobs = decode.generate(model, inputs, 2)
            out["eval"] = {"tokens": tokens.numpy(), "logprobs": logprobs.numpy()}
        elif family == "MMF_LoRRA":
            out["eval"] = {"scores": model(inputs)["scores"].numpy()}
        elif FAMILIES[family] is not None:
            out["eval"] = {k: v.numpy() for k, v in model.greedy_decode(inputs).items()}
        else:
            model.eval()
            out["eval"] = {"hidden": model(inputs).numpy()}
    return out


def _families_ranks(rank, states):
    from openvivqa_tpu_torch.parallel.mesh import apply_tensor_parallel, get_mesh_2d

    mesh = get_mesh_2d(2, "cpu")
    out = {}
    for family, state in states.items():
        model, inputs = _family_model(family)
        model.load_state_dict(state)
        split = apply_tensor_parallel(model, mesh)
        out[family] = {"split": split, **_family_run(family, model, inputs)}
    return out


@pytest.fixture(scope="module")
def families():
    want, states = {}, {}
    for family in FAMILIES:
        model, inputs = _family_model(family)
        states[family] = {k: v.clone() for k, v in model.state_dict().items()}
        want[family] = _family_run(family, model, inputs)
    ranks = run_ranks(_families_ranks, states)
    return want, ranks


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_at_two_model_ranks_computes_as_at_one(families, family):
    """Each family with split weights at 2 model ranks, outside eval_weights,
    so that each kernel bundle and tied or direct weight read goes through
    whole() on DTensors (a missed site raises: torch refuses to mix tensors
    and DTensors): the eval outputs (greedy ids or beam sequences equal;
    scores, log-probs and hidden states within 1e-5) and, for the task
    models, the training loss with dropout 0.1 drawn from one seed (rtol
    1e-6) and every gradient (within 1e-5 of the model's largest gradient element) equal the
    one-rank model's on the same weights."""
    want, ranks = families
    for result in [r[family] for r in ranks]:
        assert result["split"], "no parameter was split"
        for key, value in want[family]["eval"].items():
            if value.dtype.kind in "iub":
                np.testing.assert_array_equal(result["eval"][key], value, err_msg=key)
            else:
                np.testing.assert_allclose(result["eval"][key], value, atol=1e-5, rtol=0,
                                           err_msg=key)
        if "loss" in want[family]:
            assert result["loss"] == pytest.approx(want[family]["loss"], rel=1e-6)
            assert sorted(result["grads"]) == sorted(want[family]["grads"])
            scale = max(float(np.abs(g).max()) for g in want[family]["grads"].values())
            for name, grad in want[family]["grads"].items():
                np.testing.assert_allclose(result["grads"][name], grad, atol=1e-5 * scale,
                                           rtol=0, err_msg=name)


def test_split_linears_and_tied_reads_of_each_family(families):
    """The families above split what the rule picks: the tied answer tables
    (MMF classifier, M4C vocab projection), IterativeM4C's raw fixed-vocab
    table and DeBERTa's relative embeddings among them."""
    _, ranks = families
    split = {family: set(result["split"]) for family, result in ranks[0].items()}
    assert "classifier.weight" in split["MMF_ImprovedDecodingM4C"]
    assert "classifier.weight" in split["MMF_IterativeM4C"]
    assert "vocab_proj.weight" in split["M4C"]
    assert "dynamic_embedding.fixed_weights" in split["IterativeM4C"]
    assert "encoder.rel_embeddings.weight" in split["DeBERTa"]


# -- collectives through host memory ------------------------------------------------------------
def _staged_ranks(rank):
    import torch.distributed._functional_collectives as funcol

    from openvivqa_tpu_torch.parallel import mesh as port_mesh

    grid = port_mesh.get_mesh_2d(2, "cpu")

    def step():
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Embedding(10, 16), torch.nn.Linear(16, 32),
                                    torch.nn.Tanh(), torch.nn.Linear(32, 8))
        port_mesh.apply_tensor_parallel(model, grid)
        out = model(torch.tensor([[1, 2, 3], [4, 5, 9]]))
        out.square().sum().backward()
        with port_mesh.whole_parameters(model):
            again = model(torch.tensor([[1, 2, 3], [4, 5, 9]]))
        return ([out.detach(), again.detach()]
                + [port_mesh.whole(p.grad) for p in model.parameters()]
                + [port_mesh.whole(p).detach() for p in model.parameters()])

    direct = step()
    originals = {name: getattr(funcol, name) for name in port_mesh.STAGED_COLLECTIVES
                 if hasattr(funcol, name)}
    names = port_mesh.stage_collectives_through_host("cpu")
    staged = {name: getattr(funcol, name) for name in names}
    assert port_mesh.stage_collectives_through_host("cpu") == names
    calls = []
    for name, collective in staged.items():
        def counting(*args, _collective=collective, _name=name, **kwargs):
            calls.append(_name)
            return _collective(*args, **kwargs)

        setattr(funcol, name, counting)
    through_host = step()
    return {"names": names, "calls": sorted(set(calls)), "n_calls": len(calls),
            "wrapped": all(staged[n] is not originals[n] and staged[n].__wrapped__ is originals[n]
                           for n in names),
            "equal": all(torch.equal(a, b) for a, b in zip(direct, through_host))}


def test_collectives_through_host_memory_compute_as_direct_ones():
    """``stage_collectives_through_host`` (the route of a gloo group over
    CUDA devices, whose functional collectives crash on CUDA tensors) staged
    here for CPU tensors, so that every DTensor collective of a TP forward,
    backward, whole() and the eval swap runs on a host copy: the outputs,
    whole gradients and weights equal the direct collectives' bit for bit,
    the all-gathers and all-reduces went through the staged wrappers, and
    staging twice changes nothing."""
    for result in run_ranks(_staged_ranks):
        assert result["wrapped"] and result["equal"]
        assert {"all_reduce"} <= set(result["calls"]) and result["n_calls"] > 0
        assert any(name.startswith("all_gather") for name in result["calls"])


# -- (v), (vi): SAAA at (data 2, model 2) under FSDP ---------------------------------------------------
def _lorra_ranks(paths, root):
    """MMF_LoRRA at (data 2, model 2) without FSDP: one epoch; its unread
    projections, and a checksum of its whole weights after the steps."""
    from test_torch_port_scale_out import lorra_config

    config = lorra_config(paths, root / "lorra").to_dict()
    config["TRAINING"]["MESH"] = {"MODEL_PARALLEL": 2}
    task = build(ConfigNode(config))
    losses = [float(task._train_step(batch)) for _, batch in task.device_batches(
        task.train_dataloader)]
    unread = sorted(name for name, p in task.model.named_parameters() if p.grad is None)
    checksum = float(sum(w.astype(np.float64).sum() for w in _whole_params(task.model).values()))
    return {"losses": losses, "unread": unread, "checksum": checksum,
            "split": sum(hasattr(p, "placements") for p in task.model.parameters())}


def _saaa_ranks(rank, paths, root):
    from openvivqa_tpu_torch.models.modules import bert
    from openvivqa_tpu_torch.parallel.mesh import data_shard
    from openvivqa_tpu_torch.training import train_state

    config = classification_config(paths, root, batch_size=2, MESH={"MODEL_PARALLEL": 2,
                                                                    "FSDP": True})
    task = build(config)
    counts = []

    class Recording:
        def __getattr__(self, name):
            return getattr(torch.distributed, name)

        def all_reduce(self, tensor, *args, **kwargs):
            local = float(tensor[1])
            work = torch.distributed.all_reduce(tensor, *args, **kwargs)
            counts.append((local, float(tensor[1])))
            return work

    train_state.dist = Recording()
    probe = torch.Generator().manual_seed(0)
    probe.set_state(task.generator.get_state())
    mask = bert.dropout(torch.ones(4096), 0.5, probe).numpy()
    try:
        losses = task.train()
    finally:
        train_state.dist = torch.distributed
    placements = _placements(task.model)
    task.save_checkpoint({"best_val_score": 0.0, "patience": 0})
    resumed = build(config)
    meta = resumed.load_checkpoint(f"{task.checkpoint_path}/last_model.pth")
    named = dict(task.model.named_parameters())

    def same_as_saved(other):
        return all(str(p.placements) == str(named[name].placements)
                   and torch.equal(p.to_local(), named[name].to_local())
                   for name, p in other.model.named_parameters())

    same = same_as_saved(resumed)
    # the sharded backend: each rank writes and reads its own DTensor shards
    os.environ["OPENVIVQA_CKPT_BACKEND"] = "orbax"
    try:
        task.save_checkpoint({"best_val_score": 0.0, "patience": 0})
        from_shards = build(config)
        from_shards.load_checkpoint(f"{task.checkpoint_path}/last_model.pth")
    finally:
        del os.environ["OPENVIVQA_CKPT_BACKEND"]
    return {"shard": data_shard(), "losses": losses, "counts": counts, "mask": mask,
            "placements": placements, "resumed_placements": _placements(resumed.model),
            "same": same, "from_shards": same_as_saved(from_shards), "meta": meta,
            "generator": task.generator.get_state().numpy(), "lorra": _lorra_ranks(paths, root)}


def test_saaa_trains_and_resumes_at_two_by_two_under_fsdp(synthetic_data, tmp_path):
    """SAAA (its LSTM, dropout 0.1) at (data 2, model 2) with FSDP, four
    ranks: one epoch; every parameter is a DTensor (a split Linear weight in
    JAX's combined (data, model) layout, its bias whole over model, the rest
    FSDP's shards over data), the loader gives each
    data group its own batches (shard (2, d)); each loss denominator is the
    global count, the sum of the two data groups' counts (not of the four
    ranks'); the model ranks of a data group draw the same dropout masks, end
    with the same generator state and report the same losses, the two data
    groups draw different masks; a fresh task resumes the checkpoint into the
    same placements and local shards, from the whole-state file and from the
    sharded backend's per-rank shards.  MMF_LoRRA at (data 2, model 2) without
    FSDP (gradients averaged over the data groups before each step) trains an
    epoch with its unread projections left without gradients, and the four
    ranks end with the same whole weights (float64 checksums equal)."""
    results = run_ranks(_saaa_ranks, synthetic_data, tmp_path, world=4)
    assert [r["shard"] for r in results] == [(2, 0), (2, 0), (2, 1), (2, 1)]
    for group in ((0, 1), (2, 3)):
        a, b = (results[i] for i in group)
        np.testing.assert_array_equal(a["mask"], b["mask"])
        np.testing.assert_array_equal(a["generator"], b["generator"])
        assert a["losses"] == b["losses"] and a["counts"] == b["counts"]
    assert not np.array_equal(results[0]["mask"], results[2]["mask"])
    first, other = results[0]["counts"], results[2]["counts"]
    assert first and len(first) == len(other)
    for (local0, total0), (local1, total1) in zip(first, other):
        assert total0 == total1 == local0 + local1
    for result in results:
        assert len(result["losses"]) == 3 and all(np.isfinite(result["losses"]))
        placements = set(result["placements"].values())
        # a split Linear (out, in): in over data, out over model (JAX's P(data, model)
        # of the flax kernel (in, out)); its bias whole over model, split over data
        assert {"(Shard(dim=1), Shard(dim=0))", "(Shard(dim=0), Replicate())"} <= placements
        assert "whole" not in placements
        assert result["resumed_placements"] == result["placements"]
        assert result["same"] and result["from_shards"]
        assert result["meta"]["epoch"] == 0
        lorra = result["lorra"]
        assert len(lorra["losses"]) == 3 and all(np.isfinite(lorra["losses"]))
        assert lorra["split"] > 0 and lorra["unread"]
        assert all(".fc_v." in name or ".fc_o." in name for name in lorra["unread"])
        assert lorra["checksum"] == results[0]["lorra"]["checksum"]
