"""The port's VLSP generative family and cross-modality models on the CPU
against the JAX package, at small sizes: CrossModalityEncoder,
CrossModalityTransformer and VisiolinguisticTransformer in both modes (a
classifier without DECODER, a generator with it), ExtendedMCAN and
UniqueTransformer.

Flax modules and models (64 wide, 4 heads of 16, 2 layers; 24-, 20- and 4-wide
region, grid and box features) take parameters drawn from numpy with a seed,
a nonzero padding row in every embedding table among them, bridged into the port with
``params_from_flax`` and run on the same numpy batch in float32: the encoder
within 1e-5, each model's log-probs within 1e-4, beam-3 ``generate()`` with
equal tokens (cumulative log-probs within 1e-4), UniqueTransformer's
``decode_teacher_forced`` within 1e-4.  Each bridge puts every flax tensor in
exactly one port tensor.  The gradients of a dropout-0.1 step, and the six YAMLs
at their full widths with flax's parameter counts.  The Adam steps against the
JAX tasks and the tasks end to end are in ``test_torch_port_vlsp_training.py``
(a file of their own, so that xdist's loadfile spreads the two).  The port runs each kernel's plain version on CPU
tensors, the JAX package its XLA paths.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvivqa_tpu.builders import META_ARCHITECTURE as JAX_ARCHITECTURE
from openvivqa_tpu.builders import populate as jax_populate
from openvivqa_tpu.models.modules import encoders as jencoders
from openvivqa_tpu.training import decode as jdecode
from openvivqa_tpu_torch.builders import META_ARCHITECTURE, META_TASK, build_model, populate
from openvivqa_tpu_torch.config import ConfigNode, get_config
from openvivqa_tpu_torch.models import convert
from openvivqa_tpu_torch.models.convert import params_from_flax
from openvivqa_tpu_torch.models.modules import encoders
from openvivqa_tpu_torch.training import decode
from openvivqa_tpu_torch.training.tasks.classification_task import ClassificationTask
from openvivqa_tpu_torch.training.tasks.open_ended_task import OpenEndedTask

jax_populate()
populate()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, HEADS, LAYERS = 64, 4, 2
REGIONS, D_REGION, GRIDS, D_GRID = 6, 24, 4, 20
MASK = -10e4
MODULE_TOL, MODEL_TOL = 1e-5, 1e-4
# no gradient, analytically: softmax(q . (k + b)) does not depend on b, nor does
# the attention-reduce pooling's softmax over tokens on its logits' shared bias
GRADIENT_FREE = ("fc_k.bias", "attr_reduce.fc2.bias")


class _Vocab:
    padding_idx, bos_idx, eos_idx, unk_idx = 0, 1, 2, 3
    img_idx, feat_idx, box_idx, question_idx, answer_idx = 4, 5, 6, 7, 8
    max_question_length = 7
    max_answer_length = 5
    total_answers = 11
    word_embeddings = None

    def __len__(self):
        return 40


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _attention(dropout=0.1):
    return {"ARCHITECTURE": "ScaledDotProductAttention", "HEAD": HEADS, "D_MODEL": D,
            "D_KEY": D // HEADS, "D_VALUE": D // HEADS, "D_FF": 2 * D, "USE_AOA": False,
            "CAN_BE_STATEFUL": False, "DROPOUT": dropout}


def _dual_encoder(kind, dropout=0.1):
    return {"ARCHITECTURE": kind, "D_MODEL": D, "LAYERS": LAYERS,
            **{k: _attention(dropout) for k in (
                "VISION_LANGUAGE_ATTENTION", "LANGUAGE_VISION_ATTENTION",
                "VISION_SELF_ATTENTION", "LANGUAGE_SELF_ATTENTION")}}


def _model_config(arch, generative=True, dropout=0.1):
    """The MODEL node of `arch` at small widths; the dual-stream models as
    generators (a DECODER section) or classifiers."""
    def features(width):
        return {"ARCHITECTURE": "FeatureEmbedding", "D_FEATURE": width, "D_MODEL": D,
                "DROPOUT": dropout}

    text = {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": D, "D_EMBEDDING": D,
            "DROPOUT": dropout, "WORD_EMBEDDING": None}
    decoder = {"ARCHITECTURE": "Decoder", "D_MODEL": D, "LAYERS": LAYERS, "TEXT_EMBEDDING": text,
               "ATTENTION": {"SELF_ATTENTION": {**_attention(dropout), "CAN_BE_STATEFUL": True},
                             "ENC_ATTENTION": _attention(dropout)}}
    streams = {"REGION_EMBEDDING": features(D_REGION), "GRID_EMBEDDING": features(D_GRID),
               "BOX_EMBEDDING": features(4)}
    node = {"NAME": f"{arch.lower()}_port_test", "ARCHITECTURE": arch, "D_MODEL": D,
            "DROPOUT": dropout, "TEXT_EMBEDDING": text}
    if arch in ("CrossModalityTransformer", "VisiolinguisticTransformer"):
        kind = "CrossModalityEncoder" if arch == "CrossModalityTransformer" else \
            "CoAttentionEncoder"
        node["ENCODER"] = _dual_encoder(kind, dropout)
        if generative:  # no MULTIMODAL_FUSION: the 4 x d_model fallback
            node.update(streams, DECODER=decoder)
        else:
            reduce = {"D_MODEL": D, "DROPOUT": dropout}
            node.update(REGION_EMBEDDING=features(D_REGION), VISION_ATTR_REDUCE=reduce,
                        TEXT_ATTR_REDUCE=reduce)
    elif arch == "ExtendedMCAN":
        del node["D_MODEL"]  # as in extended_mcan_vlsp.yaml: the fusion's width
        node.update(streams, DECODER=decoder, MULTIMODAL_FUSION={
            "D_MODEL": D, "D_FF": 2 * D, "DROPOUT": dropout},
            SELF_ENCODER={"ARCHITECTURE": "Encoder", "D_MODEL": D, "LAYERS": LAYERS,
                          "SELF_ATTENTION": _attention(dropout)},
            GUIDED_ENCODER={"ARCHITECTURE": "GuidedAttentionEncoder", "D_MODEL": D,
                            "LAYERS": LAYERS, "SELF_ATTENTION": _attention(dropout),
                            "GUIDED_ATTENTION": _attention(dropout)})
    else:  # UniqueTransformer; its DECODER section is not built
        node.update(streams, DECODER=decoder, ENCODER={
            "ARCHITECTURE": "MultiModalEncoder", "D_MODEL": D, "LAYERS": LAYERS,
            "SELF_ATTENTION": _attention(dropout)})
    return ConfigNode(node)


def _numpy_batch(seed, bs=3, vocab=_Vocab()):
    """Feature streams with zero (padding) rows, padded question and answer
    tails, class ids and shifted answers."""
    rng = np.random.default_rng(seed)
    batch = {
        "region_features": rng.normal(size=(bs, REGIONS, D_REGION)).astype(np.float32),
        "region_boxes": rng.uniform(size=(bs, REGIONS, 4)).astype(np.float32),
        "grid_features": rng.normal(size=(bs, GRIDS, D_GRID)).astype(np.float32),
        "grid_boxes": rng.uniform(size=(bs, GRIDS, 4)).astype(np.float32),
    }
    batch["region_features"][1, -2:] = 0.0
    batch["grid_features"][2, -1:] = 0.0
    questions = rng.integers(9, len(vocab), size=(bs, vocab.max_question_length)).astype(np.int32)
    questions[1, -3:] = vocab.padding_idx
    answers = rng.integers(9, len(vocab), size=(bs, vocab.max_answer_length)).astype(np.int32)
    answers[:, 0] = vocab.bos_idx
    answers[0, -2:] = vocab.padding_idx
    shifted = np.concatenate([answers[:, 1:], np.zeros((bs, 1), np.int32)], axis=1)
    return dict(batch, question_tokens=questions, answer_tokens=answers,
                shifted_right_answer_tokens=shifted,
                answer=rng.integers(1, vocab.total_answers, size=(bs, 1)).astype(np.int32),
                sample_valid=np.ones((bs,), bool))


def _numpy_params(init, seed):
    """A parameter tree of the structure `init(rng)` gives (traced, not
    compiled) drawn from numpy: Dense kernels N(0, 1 / fan_in), biases N(0, 0.1^2),
    LayerNorm scales 1 + N(0, 0.1^2), embedding tables N(0, 1) (their
    padding rows nonzero: both sides must read them as zero), the LSTM's
    kernels as Dense ones."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        normal = rng.normal(size=leaf.shape).astype(np.float32)
        if "scale" in name:
            return jnp.asarray(1.0 + 0.1 * normal)
        if "bias" in name:
            return jnp.asarray(0.1 * normal)
        if "kernel" in name:
            return jnp.asarray(normal / np.sqrt(leaf.shape[0]))
        return jnp.asarray(normal)

    return jax.tree_util.tree_map_with_path(draw, shapes)


# (architecture, generative) of the six configs
MODELS = [("CrossModalityTransformer", False), ("CrossModalityTransformer", True),
          ("VisiolinguisticTransformer", False), ("VisiolinguisticTransformer", True),
          ("ExtendedMCAN", True), ("UniqueTransformer", True)]
IDS = [f"{arch}-{'generator' if gen else 'classifier'}" for arch, gen in MODELS]
GENERATORS = [(arch, gen) for arch, gen in MODELS if gen]
_PAIRS = {}


def _pair(arch, generative):
    """(flax model, its numpy-drawn params, the port's model with those
    params), kept per module."""
    key = (arch, generative)
    if key not in _PAIRS:
        vocab, config = _Vocab(), _model_config(arch, generative)
        flax_model = JAX_ARCHITECTURE.get(arch)(config=config, vocab=vocab)
        batch = {k: jnp.asarray(v) for k, v in _numpy_batch(0).items()}
        params = _numpy_params(lambda r: flax_model.init(r, batch, train=False), seed=1)
        port = META_ARCHITECTURE.get(arch)(config, vocab)
        port.load_state_dict({k: torch.from_numpy(v)
                              for k, v in params_from_flax(params, config).items()})
        _PAIRS[key] = (flax_model, params, port.eval())
    return _PAIRS[key]


def _jax_logprobs(flax_model, params, batch):
    # compiled: cheaper than the first eager run of a new model's ops
    return jax.jit(lambda p, b: flax_model.apply({"params": p}, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})


# -- the module ---------------------------------------------------------------------------
def test_cross_modality_encoder_matches_flax():
    """Both streams after two LXMERT layers (cross, then self over the cross
    output, then FFN; the language stream cross-attends the vision stream as
    it entered the layer) under padding biases on both streams."""
    config = ConfigNode(_dual_encoder("CrossModalityEncoder"))
    rng = np.random.default_rng(7)
    v, t = (rng.normal(size=(3, n, D)).astype(np.float32) for n in (6, 9))
    v_bias = np.where(rng.random((3, 1, 1, 6)) < 0.3, MASK, 0.0).astype(np.float32)
    t_bias = np.where(rng.random((3, 1, 1, 9)) < 0.3, MASK, 0.0).astype(np.float32)
    v_bias[..., 0] = t_bias[..., 0] = 0.0
    flax_module = jencoders.CrossModalityEncoder(config)
    args = tuple(jnp.asarray(a) for a in (v, v_bias, t, t_bias))
    params = _numpy_params(lambda r: flax_module.init(r, *args), seed=0)
    state = {}
    convert._cross_modality_encoder(state, "m", params)
    port = encoders.CrossModalityEncoder(config)
    port.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in state.items()})
    want_v, want_t = jax.jit(lambda p, *a: flax_module.apply({"params": p}, *a))(params, *args)
    got_v, got_t = port.eval()(*(_t(a) for a in (v, v_bias, t, t_bias)))
    _close(got_v, want_v, MODULE_TOL)
    _close(got_t, want_t, MODULE_TOL)


# -- the models ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,generative", MODELS, ids=IDS)
def test_logprobs_match_flax(arch, generative):
    """Teacher-forced (or class) log-probs of a numpy batch in eval within
    1e-4; the classifiers build no grid, box, fusion or norm module, the
    generators no head."""
    flax_model, params, port = _pair(arch, generative)
    batch = _numpy_batch(9)
    with torch.no_grad():
        got = port({k: _t(v) for k, v in batch.items()})
    want = _jax_logprobs(flax_model, params, batch)
    width = _Vocab.total_answers if not generative else len(_Vocab())
    assert got.shape[-1] == width
    _close(got, want, MODEL_TOL)
    names = {name.split(".")[0] for name, _ in port.named_parameters()}
    head = {"vision_attr_reduce", "classify"}
    streams = {"grid_embedding", "box_embedding"}
    if generative:
        assert streams <= names and not head & names
    else:
        assert head <= names and not (streams | {"fusion", "norm", "decoder"}) & names


@pytest.mark.parametrize("arch,generative", MODELS, ids=IDS)
def test_bridge_round_trips_every_flax_tensor(arch, generative):
    """params_from_flax puts every flax tensor in exactly one port tensor (as
    it is, or a Dense kernel transposed) and fills every port parameter at
    its shape; UniqueTransformer's ``streams/*`` land at the top of the
    port's names beside the shared text embedding."""
    _, params, port = _pair(arch, generative)
    state = params_from_flax(params)
    assert set(state) == set(port.state_dict())
    for name, tensor in port.state_dict().items():
        assert tuple(tensor.shape) == state[name].shape, name
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) == len(state)
    unused = dict(state)
    for path, leaf in leaves:
        leaf = np.asarray(leaf)
        match = next(name for name, value in unused.items()
                     if value.shape in (leaf.shape, leaf.T.shape)
                     and (np.array_equal(value, leaf) or np.array_equal(value, leaf.T)))
        del unused[match]
    assert not unused
    if arch == "UniqueTransformer":
        assert "streams" in params and "region_embedding.proj.weight" in state
        assert "fc.bias" not in state


@pytest.mark.parametrize("arch,generative", GENERATORS, ids=[a for a, _ in GENERATORS])
def test_beam3_generate_matches_jax(arch, generative):
    """Beam-3 generate() against the JAX package's: the tokens equal, the
    cumulative log-probs within 1e-4 (UniqueTransformer: its token buffer in
    the decode cache, reordered by beam search, one encoder run a step)."""
    flax_model, params, port = _pair(arch, generative)
    batch = _numpy_batch(2)
    want_tokens, want_logprobs = jdecode.generate(
        flax_model, {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
        batch_size=3, beam_size=3)
    got_tokens, got_logprobs = decode.generate(port, {k: _t(v) for k, v in batch.items()}, 3)
    np.testing.assert_array_equal(got_tokens.numpy(), np.asarray(want_tokens))
    _close(got_logprobs, want_logprobs, MODEL_TOL)


def test_unique_transformer_decode_teacher_forced_matches_jax():
    """decode_teacher_forced on an encode() prefix: the training layout with
    answer_tokens := tokens."""
    flax_model, params, port = _pair("UniqueTransformer", True)
    batch = _numpy_batch(4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tokens = jb["answer_tokens"]

    def jax_fn(module):
        prefix, bias = module.encode(jb)
        return module.decode_teacher_forced(tokens, prefix, bias)

    want = flax_model.apply({"params": params}, method=jax_fn)
    with torch.no_grad():
        prefix, bias = port.encode({k: _t(v) for k, v in batch.items()})
        got = port.decode_teacher_forced(_t(tokens).long(), prefix, bias)
    _close(got, want, MODEL_TOL)


def test_unique_transformer_decode_step_reads_its_buffer():
    """Each step writes its token into the cache's buffer, advances the int
    step index and returns one row of log-probs; the buffer is a (rows,
    max_len) tensor that beam search reorders."""
    _, _, port = _pair("UniqueTransformer", True)
    batch = {k: _t(v) for k, v in _numpy_batch(5).items()}
    with torch.no_grad():
        prefix, bias = port.encode(batch)
        prep = port.prepare_decode(prefix, bias)
        cache = port.init_decode_cache(3, "cpu")
        token = torch.full((3, 1), _Vocab.bos_idx)
        first = port.decode_step(token, cache, prep)
        second = port.decode_step(torch.full((3, 1), 12), cache, prep)
    assert first.shape == second.shape == (3, 1, len(_Vocab()))
    assert cache["step"] == 2 and isinstance(cache["step"], int)
    np.testing.assert_array_equal(cache["tokens"][:, :2].numpy(), [[1, 12]] * 3)
    assert cache["tokens"].shape == (3, _Vocab.max_answer_length)


@pytest.mark.parametrize("arch,generative", MODELS, ids=IDS)
def test_gradient_step_gives_finite_nonzero_grads(arch, generative):
    """The training route at dropout 0.1: every parameter gets a finite
    gradient that is not zero (the analytically gradient-free biases only
    finite)."""
    vocab, config = _Vocab(), _model_config(arch, generative)
    port = META_ARCHITECTURE.get(arch)(config, vocab)
    port.init_weights_(torch.Generator().manual_seed(0))
    stub = types.SimpleNamespace(model=port.train(), generator=torch.Generator().manual_seed(3),
                                 vocab=vocab)
    task = OpenEndedTask if generative else ClassificationTask
    loss = task.compute_loss(stub, {k: _t(v) for k, v in _numpy_batch(12).items()})
    loss.backward()
    assert bool(torch.isfinite(loss))
    for name, p in port.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        assert name.endswith(GRADIENT_FREE) or float(p.grad.abs().max()) > 0.0, name


# -- the six configs at their full widths ---------------------------------------------------
class _FullVocab(_Vocab):
    max_question_length = 26
    max_answer_length = 8

    def __len__(self):
        return 300


CONFIGS = {
    "unique_transformer.yaml": ("UniqueTransformer", "VlspEvjVqaTask"),
    "cross_modality_transformer_vlsp.yaml": ("CrossModalityTransformer", "VlspEvjVqaTask"),
    "visiolinguistic_transformer_vlsp.yaml": ("VisiolinguisticTransformer", "VlspEvjVqaTask"),
    "extended_mcan_vlsp.yaml": ("ExtendedMCAN", "VlspEvjVqaTask"),
    "cross_modality_transformer.yaml": ("CrossModalityTransformer", "ClassificationTask"),
    "visiolinguistic_transformer.yaml": ("VisiolinguisticTransformer", "ClassificationTask"),
}


def _full_width_example(vocab):
    """One sample at the EVJVQA store's widths (2048-wide regions, 1024-wide
    grids, 4-wide boxes)."""
    rng = np.random.default_rng(0)
    return {"region_features": rng.normal(size=(1, 10, 2048)).astype(np.float32),
            "region_boxes": rng.uniform(size=(1, 10, 4)).astype(np.float32),
            "grid_features": rng.normal(size=(1, 49, 1024)).astype(np.float32),
            "grid_boxes": rng.uniform(size=(1, 49, 4)).astype(np.float32),
            "question_tokens": np.full((1, vocab.max_question_length), 9, np.int32),
            "answer_tokens": np.full((1, vocab.max_answer_length), 9, np.int32)}


@pytest.mark.parametrize("config_file", sorted(CONFIGS))
def test_config_builds_at_its_full_widths_with_flax_parameter_count(config_file):
    """Each YAML's MODEL node in the port's registries at its full widths
    (d_model 512, 8 heads of 64, FFN 2048): its architecture and task, and as
    many trainable parameters as flax's init of the same node on the same
    input widths (UniqueTransformer without its unused DECODER, the
    dual-stream models in the mode their config asks for)."""
    arch, task = CONFIGS[config_file]
    config = get_config(os.path.join(ROOT, "configs", config_file))
    vocab = _FullVocab()
    example = _full_width_example(vocab)
    model = build_model(config.MODEL, vocab, {k: v[0] for k, v in example.items()})
    assert type(model).__name__ == arch and config.TASK == task
    assert META_TASK.get(config.TASK) is not None
    core = next(m for m in model.modules() if type(m).__name__ == "ScaledDotProductAttention")
    assert (core.d_model, core.h, core.d_k) == (512, 8, 64)
    flax_model = JAX_ARCHITECTURE.get(arch)(config=config.MODEL, vocab=vocab)
    shapes = jax.eval_shape(lambda r: flax_model.init(r, {k: jnp.asarray(v) for k, v in
                                                          example.items()}, train=False),
                            jax.random.PRNGKey(0))["params"]
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    got = sum(p.numel() for p in model.parameters() if p.requires_grad)
    assert got == want
    if arch == "UniqueTransformer":
        assert not hasattr(model, "decoder") and "decoder" not in shapes
