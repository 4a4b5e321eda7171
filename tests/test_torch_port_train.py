"""The port's training slice (dropout attention, packed-attention gradient,
optimizer, loss, checkpoints, TrainingMMF.start / get_predictions) on the CPU
against the JAX package, at small sizes.

On the CPU the dropout attention runs its plain versions, whose mask is the
same Philox4x32-10 the CUDA kernels draw (csrc/common.cuh).  The JAX package's
interpret mode stubs the TPU PRNG, so it is compared only at rate 0; at rate
0.1 the plain versions are held against autograd and against the mask's
contract.  Tolerances are stated where they are used.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openvivqa_tpu.models.mmf_m4c import MMF_M4C as JaxMMF
from openvivqa_tpu.ops import fused_attention as jattn
from openvivqa_tpu.training import optim as joptim
from openvivqa_tpu.training.tasks.ocr_tasks import TrainingMMF as JaxTrainingMMF
from openvivqa_tpu.training.train_state import TrainState
from openvivqa_tpu.training.train_state import nll_loss as jax_nll_loss
from openvivqa_tpu_torch.builders import build_task, populate
from openvivqa_tpu_torch.config import ConfigNode
from openvivqa_tpu_torch.models.convert import params_from_flax
from openvivqa_tpu_torch.ops import fused_attention as fa
from openvivqa_tpu_torch.training.optim import constant_lambda, noam_lambda
from openvivqa_tpu_torch.training.train_state import nll_loss

populate()

HD, HEADS = 32, 2
MASK = -10e4
D, K = 32, 8


def _bf16_normal(rng, *shape):
    """N(0, 1) values that bf16 represents exactly, so that operand rounding
    is the identity on both sides."""
    x = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _attention_inputs(seed, b=2, sq=11, sk=11, bias_shape=(2, 1, 11, 11)):
    rng = np.random.default_rng(seed)
    q, k, v, g = (_bf16_normal(rng, b, s, HD) for s in (sq, sk, sk, sq))
    bias = np.where(rng.random(bias_shape) < 0.25, MASK, 0.0).astype(np.float32)
    return q, k, v, g, bias


def _t(x):
    return torch.from_numpy(np.array(x))


SCALE = 1.0 / np.sqrt(HD // HEADS)
_BIASES = {"per-sample full": (2, 1, 11, 11), "key-only": (2, 1, 1, 11)}


# -- the dropout attention -------------------------------------------------------------
@pytest.mark.parametrize("bias_kind", list(_BIASES))
def test_dropout_attention_rate0_matches_jax_kernel_interpret(bias_kind):
    """Output and gradients against the Pallas forward and backward kernels in
    interpret mode.  Both round dot operands and weights to bf16 (the plain
    version runs with op_dtype bf16, on bf16-representable inputs and
    upstream gradient).  Outputs: atol 1e-5.  Gradients: the backward rounds
    each softmax-logit gradient to bf16, and the two frameworks' float32 sums
    may land on either side of a rounding boundary, one bf16 ulp (2^-8
    relative) of a term of dq or dk apart: atol 2e-3 on values of order 1."""
    q, k, v, g, bias = _attention_inputs(seed=1, bias_shape=_BIASES[bias_kind])
    seed = jnp.zeros((1,), jnp.int32)

    def jax_loss(q_, k_, v_):
        out = jattn.fused_attention_packed_dropout(
            q_, k_, v_, jnp.asarray(bias), seed, SCALE, HEADS, 0.0)
        return jnp.sum(out * jnp.asarray(g)), out

    with pltpu.force_tpu_interpret_mode():
        (_, want), want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    port_seed = torch.zeros(1, dtype=torch.int64)
    got = fa.fused_attention_packed_dropout_plain(
        _t(q), _t(k), _t(v), _t(bias), port_seed, SCALE, HEADS, 0.0, op_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    got_grads = fa.fused_attention_packed_dropout_backward_plain(
        _t(q), _t(k), _t(v), _t(bias), port_seed, _t(g), SCALE, HEADS, 0.0,
        op_dtype=torch.bfloat16)
    for got_grad, want_grad in zip(got_grads, want_grads):
        np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), atol=2e-3, rtol=0)


@pytest.mark.parametrize("bias_kind", list(_BIASES))
def test_dropout_plain_backward_equals_autograd_at_rate_01(bias_kind):
    """In float32 (the CPU's op_dtype) the plain analytic backward is the exact
    gradient of the plain forward under the same Philox mask; the two differ
    only in summation order: atol 1e-5."""
    q, k, v, g, bias = _attention_inputs(seed=2, bias_shape=_BIASES[bias_kind])
    seed = torch.tensor([987654321], dtype=torch.int64)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = fa.fused_attention_packed_dropout(*leaves, _t(bias), seed, SCALE, HEADS, 0.1)
    (out * _t(g)).sum().backward()
    want = fa.fused_attention_packed_dropout_backward_plain(
        _t(q), _t(k), _t(v), _t(bias), seed, _t(g), SCALE, HEADS, 0.1)
    for leaf, want_grad in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), want_grad.numpy(), atol=1e-5, rtol=0)
    # and the function's own backward is autograd through the plain forward
    leaves2 = [_t(x).requires_grad_() for x in (q, k, v)]
    ref = fa.fused_attention_packed_dropout_plain(*leaves2, _t(bias), seed, SCALE, HEADS, 0.1)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=0, rtol=0)
    (ref * _t(g)).sum().backward()
    for leaf, leaf2 in zip(leaves, leaves2):
        np.testing.assert_allclose(leaf.grad.numpy(), leaf2.grad.numpy(), atol=1e-5, rtol=0)


def test_dropout_keep_fraction_within_4_sigma():
    factors = fa.dropout_factors(torch.tensor([7], dtype=torch.int64), 2, 8, 215, 215, 0.1)
    n = factors.numel()
    kept = float((factors > 0).float().mean())
    sigma = (0.9 * 0.1 / n) ** 0.5
    assert abs(kept - 0.9) <= 4 * sigma, (kept, sigma)
    values = torch.unique(factors).tolist()
    assert values == [0.0, pytest.approx(1 / 0.9)]


def test_dropout_mask_does_not_depend_on_the_row_tiling():
    """A 64-row tile's mask, drawn from its own absolute row counters, is the
    slice of the whole sequence's mask: the forward and backward kernels tile
    rows and keys differently and still draw the same mask."""
    seed = torch.tensor([31337], dtype=torch.int64)
    whole = fa.dropout_factors(seed, 2, 8, 215, 215, 0.1)
    for row0, rows in ((0, 64), (64, 64), (192, 23)):
        i = torch.arange(row0, row0 + rows).reshape(1, 1, rows, 1)
        col4 = torch.arange(54).reshape(1, 1, 1, 54)
        words = fa.philox4x32_10(col4, i, torch.arange(8).reshape(1, 8, 1, 1),
                                 torch.arange(2).reshape(2, 1, 1, 1), seed & 0xFFFFFFFF, seed >> 32)
        bits = torch.stack(torch.broadcast_tensors(*words), -1).reshape(2, 8, rows, -1)[..., :215]
        tile = (bits >> 9) >= fa.dropout_threshold(0.1)
        assert torch.equal(tile, whole[:, :, row0:row0 + rows] > 0)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
@pytest.mark.parametrize("sk", [1, 31, 33, 215])
def test_dropout_mask_bits_hold_dropout_factors(seed, sk):
    """dropout_mask_bits, the layout in which the forward kernel leaves the
    mask for the backward kernels, against dropout_factors: bit j % 32 of word
    j // 32 is set exactly where key j is kept, and the bits past Sk (keys
    not a multiple of 32) are clear."""
    seed_t = torch.tensor([seed], dtype=torch.int64)
    b, heads, sq = 2, 3, 9
    bits = fa.dropout_mask_bits(seed_t, b, heads, sq, sk, 0.1)
    n_words = -(-sk // 32)
    assert bits.dtype == torch.int32 and tuple(bits.shape) == (b, heads, sq, n_words)
    words = bits.to(torch.int64) & 0xFFFFFFFF
    unpacked = ((words[..., None] >> torch.arange(32)) & 1).reshape(b, heads, sq, 32 * n_words)
    keep = fa.dropout_factors(seed_t, b, heads, sq, sk, 0.1) > 0
    assert torch.equal(unpacked[..., :sk].bool(), keep)
    assert not bool(unpacked[..., sk:].any())


def test_dropout_mask_follows_the_seed():
    draw = lambda s: fa.dropout_factors(torch.tensor([s], dtype=torch.int64), 2, 2, 9, 13, 0.1)  # noqa: E731
    assert torch.equal(draw(5), draw(5))
    assert not torch.equal(draw(5), draw(6))


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """The Random123 known-answer vectors of Philox4x32-10."""
    as_tensor = lambda x: torch.tensor([x], dtype=torch.int64)  # noqa: E731
    got = fa.philox4x32_10(*map(as_tensor, counter), *map(as_tensor, key))
    assert tuple(int(w) for w in got) == want


# -- the packed attention's gradient ---------------------------------------------------------
@pytest.mark.parametrize("bias_kind", list(_BIASES) + ["none"])
def test_packed_attention_gradient_matches_jax(bias_kind):
    """jax.grad through fused_attention_packed (Pallas forward in interpret
    mode, the XLA analytic backward) against the port's autograd function:
    both backwards are float32, atol 1e-5."""
    q, k, v, g, bias = _attention_inputs(seed=3, bias_shape=_BIASES.get(bias_kind, (1, 1, 1, 11)))
    jbias = None if bias_kind == "none" else jnp.asarray(bias)
    tbias = None if bias_kind == "none" else _t(bias)

    def jax_loss(q_, k_, v_):
        return jnp.sum(jattn.fused_attention_packed(q_, k_, v_, jbias, SCALE, HEADS) * jnp.asarray(g))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    (fa.fused_attention_packed(*leaves, tbias, SCALE, HEADS) * _t(g)).sum().backward()
    for leaf, want_grad in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want_grad), atol=1e-5, rtol=0)


# -- optimizer and loss ---------------------------------------------------------------------
def test_schedules_match_jax():
    noam, jnoam = noam_lambda(32, 100), joptim.noam_schedule(1.0, 32, 100)
    const, jconst = constant_lambda(0.01), joptim.constant_lambda_schedule(0.01)
    for step in (0, 1, 50, 99, 100, 1000):
        # LambdaLR multiplies the base rate by the lambda
        assert 1.0 * noam(step) == pytest.approx(float(jnoam(step)), rel=1e-6)
        assert 0.01 * const(step) == pytest.approx(float(jconst(step)), rel=1e-6)


def test_nll_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(12, 7)).astype(np.float32)
    logprobs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    targets = rng.integers(0, 7, 12).astype(np.int32)
    targets[:3] = 0
    weights = (rng.random(12) < 0.8).astype(np.float32)
    want = jax_nll_loss(jnp.asarray(logprobs), jnp.asarray(targets), 0, jnp.asarray(weights))
    got = nll_loss(_t(logprobs), _t(targets), 0, _t(weights))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


# -- the task ------------------------------------------------------------------------------------
def _config(paths, tmp_path, **training):
    common = {
        "MAX_REGIONS": 36, "SCENE_TEXT_THRESHOLD": 0.3, "MAX_SCENE_TEXT": K, "WORD_EMBEDDING": None,
        "FEATURE_PATH": {"FEATURES": paths["features"], "SCENE_TEXT": paths["scene_text"]},
    }
    jp = {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["test"]}
    return ConfigNode({
        "TASK": "TrainingMMF",
        "DATASET": {
            "FEATURE_DATASET": dict(common, TYPE="OcrFeatureDataset", BATCH_SIZE=8, WORKERS=2),
            "DICT_DATASET": dict(common, TYPE="OcrDictionaryDataset", BATCH_SIZE=8, WORKERS=2),
            "VOCAB": {
                "TYPE": "OcrVocab", "TOKENIZER": None, "MIN_FREQ": 1, "WORD_EMBEDDING": None,
                "PAD_TOKEN": "<pad>", "BOS_TOKEN": "<bos>", "EOS_TOKEN": "<eos>",
                "UNK_TOKEN": "<unk>", "IMG_TOKEN": "<img>", "FEAT_TOKEN": "<feat>",
                "BOX_TOKEN": "<box>", "OCR_TOKEN": "<ocr>", "OCR_DET_TOKEN": "<ocr_det>",
                "OCR_REC_TOKEN": "<ocr_rec>", "QUESTION_TOKEN": "<question>",
                "ANSWER_TOKEN": "<answer>", "JSON_PATH": jp,
            },
            "JSON_PATH": jp,
        },
        "TRAINING": {
            "CHECKPOINT_PATH": str(tmp_path / "saved_models"), "LEARNING_RATE": 1.0,
            "WARMUP": 100, "SCORE": "CIDEr", "TRAINING_BEAM_SIZE": 2, "EVALUATING_BEAM_SIZE": 2,
            "PATIENCE": 2, "MAX_EPOCHS": 2, "SEED": 5, **training,
        },
        "MODEL": {
            "NAME": "mmf_m4c_port_train_test", "ARCHITECTURE": "MMF_M4C", "D_MODEL": D,
            "MMT": {"HIDDEN_SIZE": D, "NUM_HIDDEN_LAYERS": 2, "NUM_ATTENTION_HEADS": 2},
            "TEXT_BERT": {"HIDDEN_SIZE": D, "NUM_HIDDEN_LAYERS": 1, "LOAD_PRETRAINED": False},
            "OBJECT_EMBEDDING": {"D_FEATURE": 1024, "DROPOUT": 0.1},
            "OCR_EMBEDDING": {"D_FEATURE": 300 + 256 + 256, "DROPOUT": 0.1},
            "OCR_PTR_NET": {"HIDDEN_SIZE": D, "QUERY_KEY_SIZE": D},
        },
    })


def _without_dropout(config):
    return config.merged({"MODEL": {"OBJECT_EMBEDDING": {"DROPOUT": 0.0},
                                    "OCR_EMBEDDING": {"DROPOUT": 0.0}}})


def test_train_step_matches_jax(synthetic_data, tmp_path):
    """One TrainingMMF step, loss and the Adam update, against the JAX
    package's TrainingMMF._train_step on the same bridged weights and numpy
    batch, every dropout rate 0.  The JAX package fixes its BERT dropout at
    0.1 and dispatches its Pallas attention only on a TPU, so its forward runs
    with train=False: at rate 0 on the CPU that is the same function (XLA
    attention, no dropout), while the port's training route takes the packed
    attention's autograd function.  Loss rtol 1e-5.  The first Adam step
    moves each weight by about lr * sign(grad) (lr 1.8e-4 here); float32
    gradients that differ in their last bits move it by far less than
    lr / 100: atol 2e-6."""
    config = _without_dropout(_config(synthetic_data, tmp_path))
    task = build_task(config, "cpu")
    for module in task.model.modules():
        if hasattr(module, "dropout"):
            module.dropout = 0.0
    host = next(iter(task.train_dataloader))
    arrays = host.arrays()
    jax_batch = {key: jnp.asarray(value) for key, value in arrays.items()}

    jax_model = JaxMMF(config.MODEL, task.vocab)
    variables = jax.jit(lambda r, b: jax_model.init({"params": r, "dropout": r}, b, train=False))(
        jax.random.PRNGKey(0), jax_batch)
    params = jax.tree.map(np.asarray, variables["params"])
    task.model.load_state_dict({k: torch.from_numpy(v) for k, v in params_from_flax(params).items()})

    state = TrainState.create(
        lambda v, b, train, rngs: jax_model.apply(v, b, train=False), params, {},
        joptim.make_optimizer(joptim.noam_schedule(1.0, D, 100)),
    )
    stub = types.SimpleNamespace(vocab=task.vocab, maybe_remat=lambda fn: fn)
    step = jax.jit(lambda s, b, r: JaxTrainingMMF._train_step(stub, s, b, r))
    new_state, jax_loss = step(state, jax_batch, jax.random.PRNGKey(1))

    loss = task._train_step(task.put_batch(host))
    assert float(loss) == pytest.approx(float(jax_loss), rel=1e-5)
    want = params_from_flax(jax.tree.map(np.asarray, new_state.params))
    for name, tensor in task.model.state_dict().items():
        np.testing.assert_allclose(tensor.numpy(), want[name], atol=2e-6, rtol=0, err_msg=name)


def test_gradient_step_gives_finite_nonzero_grads(synthetic_data, tmp_path):
    """The training route at its 0.1 dropout rates: every trainable parameter
    gets a finite gradient that is not zero.  The OCR branch of the
    previous-token embedding gets one only from an answer that copies an OCR
    token.  An answer word found both in the vocab and among the OCR tokens
    takes either index by numpy's global generator (the reference's rule), and
    the eleven training samples need not hold a single copy: the generator is
    seeded, the loader has one worker, and the gradients of the whole train
    split are accumulated."""
    config = _config(synthetic_data, tmp_path)
    config = config.merged({"DATASET": {"FEATURE_DATASET": {"WORKERS": 1}}})
    np.random.seed(11)
    task = build_task(config, "cpu")
    task.optimizer.zero_grad(set_to_none=True)
    for _, batch in task.device_batches(task.train_dataloader):
        task.compute_loss(batch).backward()
    for name, param in task.model.named_parameters():
        assert param.grad is not None, name
        assert bool(torch.isfinite(param.grad).all()), name
        assert float(param.grad.abs().max()) > 0.0, name


def test_checkpoint_round_trip_resumes_params_optimizer_and_generator(synthetic_data, tmp_path):
    config = _config(synthetic_data, tmp_path)
    task = build_task(config, "cpu")
    _, batch = next(task.device_batches(task.train_dataloader))
    task._train_step(batch)
    task.epoch = 3
    task.save_checkpoint({"best_val_score": 0.25, "patience": 1})
    expected_draws = torch.rand(4, generator=task.generator)

    resumed = build_task(config, "cpu")
    metadata = resumed.load_checkpoint(os.path.join(task.checkpoint_path, "last_model.pth"))
    assert metadata == {"epoch": 3, "step": 1, "best_val_score": 0.25, "patience": 1}
    for (name, p), (_, q) in zip(task.model.state_dict().items(),
                                 resumed.model.state_dict().items()):
        assert torch.equal(p, q), name
    for p, q in zip(task.optimizer.state_dict()["state"].values(),
                    resumed.optimizer.state_dict()["state"].values()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(p[key], q[key]), key
    assert resumed.scheduler.get_last_lr() == task.scheduler.get_last_lr()
    assert torch.equal(torch.rand(4, generator=resumed.generator), expected_draws)


def test_train_end_to_end(synthetic_data, tmp_path):
    """The port's twin of tests/test_mmf_e2e.py::test_mmf_end_to_end: train,
    greedy-eval, checkpoint, predictions with provenance."""
    config = _config(synthetic_data, tmp_path)
    task = build_task(config, "cpu")
    task.start()
    ckpt_dir = os.path.join(config.TRAINING.CHECKPOINT_PATH, config.MODEL.NAME)
    assert os.path.isfile(os.path.join(ckpt_dir, "best_model.pth"))
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as handle:
        phases = [line for line in handle if '"phase": "train"' in line]
    assert len(phases) == 2

    scores = task.get_predictions()
    assert "CIDEr" in scores
    import json

    with open(os.path.join(ckpt_dir, "test_results.json")) as handle:
        dumped = json.load(handle)
    assert len(dumped["results"]) > 0
    assert "in_fixed_vocab" in dumped["results"][0]


def test_transfer_dtype_halves_the_copy_and_casts_back(synthetic_data, tmp_path):
    """TRAINING.TRANSFER_DTYPE: float32 arrays cross in bfloat16 and arrive as
    float32 holding the bf16-rounded values; integer arrays are untouched."""
    task = build_task(_config(synthetic_data, tmp_path, TRANSFER_DTYPE="bfloat16"), "cpu")
    host = next(iter(task.dev_dict_dataloader))
    batch = task.put_batch(host)
    for key, value in host.arrays().items():
        want = torch.from_numpy(np.ascontiguousarray(value))
        if want.dtype == torch.float32:
            want = want.to(torch.bfloat16).float()
        assert batch[key].dtype == want.dtype, key
        assert torch.equal(batch[key], want), key


def test_cli_trains_and_predicts(synthetic_data, tmp_path):
    """python -m openvivqa_tpu_torch.train on a YAML config, on the CPU."""
    import yaml

    from openvivqa_tpu_torch import train

    config_file = tmp_path / "config.yaml"
    config_file.write_text(yaml.safe_dump(_config(synthetic_data, tmp_path).to_dict()))
    train.main(["--config-file", str(config_file), "--device", "cpu",
                "--opts", "TRAINING.MAX_EPOCHS=1", "MODEL.NAME=cli"])
    ckpt_dir = tmp_path / "saved_models" / "cli"
    assert (ckpt_dir / "best_model.pth").is_file()
    assert (ckpt_dir / "test_results.json").is_file()
