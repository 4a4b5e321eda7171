"""The port's ViTmT5 slice (configs/vit_mt5.yaml under VlspEvjVqaTask) on the
CPU against the JAX package, at small sizes.

The two-bias attention's plain version is held against the JAX package's
Pallas kernel in interpret mode (bf16 operands on both sides) and its shape
checks; the T5 and ViT backbones against the flax modules, with the port's
weights bridged through ``hf_conversion`` (which reads the port's HF-named state
dict directly); the multilingual vocab and the image datasets against the JAX
copies on one synthetic EVJVQA set with Japanese questions; a small ViTmT5 (1-2
layers of 48, patch 16 on 32 x 32 images; T5 at 6 heads of 64 as mT5-small) by
teacher-forced log-probs, beam-3 ``generate()`` and one Adam step against the
JAX model on bridged weights; the task end to end.  Float32 on both sides:
modules within 1e-5 (the frameworks sum in other orders), whole decodes token
for token with log-probs within 1e-4.
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
from jax.experimental.pallas import tpu as pltpu

from openvivqa_tpu import builders as jax_builders
from openvivqa_tpu.data.loader import DataLoader as JaxDataLoader
from openvivqa_tpu.models.modules import hf_conversion
from openvivqa_tpu.models.modules import t5 as jt5
from openvivqa_tpu.models.modules import torch_conversion
from openvivqa_tpu.models.modules import vit as jvit
from openvivqa_tpu.models.modules.pretrained_embeddings import ViTEmbedding as JaxViTEmbedding
from openvivqa_tpu.models.vit_models import ViTmT5 as JaxViTmT5
from openvivqa_tpu.ops import fused_attention as jattn
from openvivqa_tpu.training import decode as jdecode
from openvivqa_tpu.training import optim as joptim
from openvivqa_tpu.training.tasks.open_ended_task import OpenEndedTask as JaxOpenEndedTask
from openvivqa_tpu.training.train_state import TrainState
from openvivqa_tpu_torch import builders, train
from openvivqa_tpu_torch.config import ConfigNode
from openvivqa_tpu_torch.data import synthetic
from openvivqa_tpu_torch.data.loader import DataLoader
from openvivqa_tpu_torch.data.multilingual import multilingual_tokenize
from openvivqa_tpu_torch.models.convert import params_from_flax
from openvivqa_tpu_torch.models.modules.pretrained_embeddings import ViTEmbedding
from openvivqa_tpu_torch.models.modules.t5 import T5EncoderStack, encoder_bucket_table
from openvivqa_tpu_torch.models.modules.vit import ViTBackbone
from openvivqa_tpu_torch.ops import fused_attention
from openvivqa_tpu_torch.training import decode

jax_builders.populate()
builders.populate()

MASK = -10e4
ATOL, RTOL = 1e-5, 1e-4
D = 32  # model width
HIDDEN = 48  # both backbones' width
T5_HEADS, T5_D_KV = 6, 64  # mT5-small's heads: inner width 384, not the model's


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _bf16(x):
    """Round to bf16-representable float32 values, so both sides round alike."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _key_bias(rng, bs, n, masked_sample=None):
    bias = np.where(rng.random((bs, 1, 1, n)) < 0.25, MASK, 0.0).astype(np.float32)
    bias[..., 0] = 0.0
    if masked_sample is not None:
        bias[masked_sample] = MASK
    return bias


# -- the two-bias attention ---------------------------------------------------------------
@pytest.mark.parametrize("bias_kind", ["none", "key padding"])
@pytest.mark.parametrize("head_bias_kind", ["shared table", "per sample"])
def test_two_bias_plain_matches_jax_kernel_interpret(bias_kind, head_bias_kind):
    """fused_attention_packed_2bias_plain at bf16 against the Pallas kernel in
    interpret mode: Sq != Sk, hd 384 over 6 heads, scale 1 (T5), both head-bias
    forms, with no head-shared bias or a (b, 1, 1, Sk) padding bias."""
    rng = np.random.default_rng(1)
    b, sq, sk = 3, 7, 11
    hd = T5_HEADS * T5_D_KV
    q, k, v = (_bf16(rng.normal(size=(b, s, hd)).astype(np.float32)) for s in (sq, sk, sk))
    head_bias = rng.normal(size=(1 if head_bias_kind == "shared table" else b,
                                 T5_HEADS, sq, sk)).astype(np.float32)
    bias = None if bias_kind == "none" else _key_bias(rng, b, sk)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.fused_attention_packed_2bias(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if bias is None else jnp.asarray(bias), jnp.asarray(head_bias), 1.0, T5_HEADS)
    got = fused_attention.fused_attention_packed_2bias_plain(
        _t(q), _t(k), _t(v), None if bias is None else _t(bias), _t(head_bias), 1.0, T5_HEADS,
        op_dtype=torch.bfloat16)
    _close(got, want)


def test_two_bias_forms_and_a_fully_masked_sample():
    """The padding as the head-shared operand beside the shared table equals
    the two added into one (b, h, L, L) head bias (the JAX package's T5 form);
    a sample with every key masked stays finite."""
    rng = np.random.default_rng(2)
    b, n, hd = 3, 9, T5_HEADS * T5_D_KV
    q, k, v = (_t(rng.normal(size=(b, n, hd)).astype(np.float32)) for _ in range(3))
    padding = _key_bias(rng, b, n, masked_sample=0)
    table = rng.normal(size=(1, T5_HEADS, n, n)).astype(np.float32)
    shared = fused_attention.fused_attention_packed_2bias(
        q, k, v, _t(padding), _t(table), 1.0, T5_HEADS)
    summed = fused_attention.fused_attention_packed_2bias(
        q, k, v, None, _t(table + padding), 1.0, T5_HEADS)
    assert bool(torch.isfinite(shared).all())
    _close(shared, summed.numpy())


def test_two_bias_shape_checks_raise_value_error():
    q = torch.zeros(2, 5, 384)
    table = torch.zeros(1, 6, 5, 5)
    fused_attention.fused_attention_packed_2bias(q, q, q, None, table, 1.0, 6)
    bad = [
        (q, q, q, None, torch.zeros(1, 4, 5, 5), "head_bias"),
        (q, q, q, None, torch.zeros(3, 6, 5, 5), "head_bias"),
        (q, q, q, None, torch.zeros(1, 6, 5, 5, dtype=torch.float64), "float32"),
        (q, q[:, :, :192], q, None, table, "q must be"),
        (q, q, q, torch.zeros(2, 6, 5, 5), table, "bias"),
    ]
    for *args, match in bad:
        with pytest.raises(ValueError, match=match):
            fused_attention.fused_attention_packed_2bias(*args, 1.0, 6)
    with pytest.raises(ValueError, match="heads"):
        fused_attention.fused_attention_packed_2bias(q, q, q, None, table, 1.0, 7)


def test_two_bias_plain_has_gradients_on_the_cpu():
    rng = np.random.default_rng(3)
    q = _t(rng.normal(size=(2, 4, 384)).astype(np.float32)).requires_grad_()
    out = fused_attention.fused_attention_packed_2bias(
        q, q.detach(), q.detach(), None, torch.zeros(1, 6, 4, 4), 1.0, 6)
    out.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


# -- the backbones against flax, bridged through hf_conversion ---------------------------
def _t5_stack(layers=2):
    stack = T5EncoderStack(vocab_size=40, d_model=HIDDEN, num_layers=layers, num_heads=T5_HEADS,
                           d_kv=T5_D_KV, d_ff=96)
    stack.init_weights_(torch.Generator().manual_seed(0))
    return stack.eval()


def test_t5_encoder_stack_matches_flax():
    """Token ids with padded tails through both stacks; the flax parameters
    are hf_conversion.convert_t5_encoder_weights of the port's state dict."""
    stack = _t5_stack()
    state = stack.state_dict()
    assert torch.equal(state["shared.weight"], state["encoder.embed_tokens.weight"])
    params = hf_conversion.convert_t5_encoder_weights(state, 2)
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, 40, size=(3, 10)).astype(np.int32)
    tokens[1, 6:] = 0
    tokens[2, 3:] = 0
    bias = np.where(tokens == 0, MASK, 0.0).astype(np.float32)[:, None, None, :]
    flax_stack = jt5.T5EncoderStack(vocab_size=40, d_model=HIDDEN, num_layers=2,
                                    num_heads=T5_HEADS, d_kv=T5_D_KV, d_ff=96)
    want = flax_stack.apply({"params": params}, jnp.asarray(tokens), jnp.asarray(bias))
    with torch.no_grad():
        got = stack(_t(tokens), _t(bias))
    _close(got, want)
    np.testing.assert_array_equal(encoder_bucket_table(10), jt5.encoder_bucket_table(10))


def test_t5_layer_norm_and_gated_ffn_match_flax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, HIDDEN)).astype(np.float32) * 3.0
    block = _t5_stack(1).encoder.block[0]
    ln, ff = block.layer[1].layer_norm, block.layer[1].DenseReluDense
    with torch.no_grad():
        ln.weight.copy_(_t(rng.normal(size=HIDDEN).astype(np.float32)))
    want_ln = jt5.T5LayerNorm().apply({"params": {"weight": ln.weight.detach().numpy()}},
                                      jnp.asarray(x))
    kernel = {name: {"kernel": getattr(ff, name).weight.detach().numpy().T}
              for name in ("wi_0", "wi_1", "wo")}
    want_ff = jt5.T5FF(HIDDEN, 96).apply({"params": kernel}, jnp.asarray(x))
    with torch.no_grad():
        _close(ln(_t(x)), want_ln)
        _close(ff(_t(x)), want_ff)


def _vit_backbone():
    """A small ViT under the port's initialisers (LayerNorm biases drawn, see
    ViTBackbone.init_weights_)."""
    backbone = ViTBackbone(hidden_size=HIDDEN, num_layers=2, num_heads=3, patch=16, image_size=32)
    backbone.init_weights_(torch.Generator().manual_seed(1))
    return backbone.eval()


def test_vit_encoder_matches_flax():
    """The layer stack and final LayerNorm against flax ViTEncoder, with the
    parameters from hf_conversion.convert_vit_weights of the port's state
    dict."""
    backbone = _vit_backbone()
    tree = hf_conversion.convert_vit_weights(backbone.state_dict(), 2)
    x = np.random.default_rng(6).normal(size=(2, 5, HIDDEN)).astype(np.float32)
    want = jvit.ViTEncoder(hidden_size=HIDDEN, num_layers=2, num_heads=3).apply(
        {"params": tree["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        _close(backbone.layernorm(backbone.encoder(_t(x))), want)


@pytest.mark.parametrize("inputs", ["pixels", "features"])
def test_vit_embedding_matches_flax(inputs):
    """ViTEmbedding over (b, 32, 32, 3) pixels (patch convolution, class token,
    positions, backbone) or over (b, L, D) features (backbone skipped; an
    all-zero row is padding)."""
    config = ConfigNode({"ARCHITECTURE": "ViTEmbedding", "D_MODEL": D, "DROPOUT": 0.1,
                         "D_PRETRAINED_FEATURE": HIDDEN, "PATCH_SIZE": 16,
                         "PRETRAINED_LAYERS": 2, "PRETRAINED_HEADS": 3, "IMAGE_SIZE": 32})
    port = ViTEmbedding(config).eval()
    port.backbone.load_state_dict(_vit_backbone().state_dict())
    tree = hf_conversion.convert_vit_weights(port.backbone.state_dict(), 2)
    tree["Dense_0"] = torch_conversion.linear(torch_conversion.StateDict(port.state_dict()), "proj")
    rng = np.random.default_rng(7)
    if inputs == "pixels":
        x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    else:
        x = rng.normal(size=(2, 6, HIDDEN)).astype(np.float32)
        x[1, 4:] = 0.0
        del tree["patch_embed"], tree["cls_token"], tree["position_embedding"], tree["backbone"]
    want, want_mask = JaxViTEmbedding(config).apply({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        got, mask = port(_t(x))
    _close(got, want)
    _close(mask, want_mask, atol=0, rtol=0)


# -- data: the EVJVQA set, vocab and image datasets ----------------------------------------
@pytest.fixture(scope="module")
def evjvqa(tmp_path_factory):
    return synthetic.generate_evjvqa_dataset(
        str(tmp_path_factory.mktemp("evjvqa")), n_images=8, n_questions_per_image=3,
        ja_share=0.4, seed=3)


def test_synthetic_images_are_the_jax_generators(tmp_path):
    from openvivqa_tpu.data.synthetic import generate_synthetic_dataset as jax_generate

    ours = synthetic.generate_synthetic_dataset(str(tmp_path / "port"), n_images=3, seed=5)
    theirs = jax_generate(str(tmp_path / "jax"), n_images=3, seed=5)
    for i in range(3):
        with open(os.path.join(ours["images"], f"{i}.jpg"), "rb") as a, \
                open(os.path.join(theirs["images"], f"{i}.jpg"), "rb") as b:
            assert a.read() == b.read()


def test_evjvqa_layout_has_four_splits_and_japanese_questions(evjvqa):
    counts, japanese = {}, 0
    for split in ("train", "dev", "public_test", "private_test"):
        with open(evjvqa[split]) as handle:
            data = json.load(handle)
        counts[split] = len(data["annotations"])
        japanese += sum(multilingual_tokenize(a["question"], None) == list(a["question"])
                        for a in data["annotations"])
        assert {a["image_id"] for a in data["annotations"]} <= {i["id"] for i in data["images"]}
    assert sum(counts.values()) == 24 and min(counts.values()) >= 3
    assert japanese > 0


def _vocab_config(paths):
    return ConfigNode({
        "TYPE": "VlspEvjVqaVocab", "TOKENIZER": None, "MIN_FREQ": 1, "WORD_EMBEDDING": None,
        "WORD_EMBEDDING_CACHE": None, "PAD_TOKEN": "<pad>", "BOS_TOKEN": "<bos>",
        "EOS_TOKEN": "<eos>", "UNK_TOKEN": "<unk>", "USE_MAPPING": False,
        "JSON_PATH": {"TRAIN": paths["train"], "DEV": paths["dev"],
                      "TEST": paths["public_test"]},
    })


def _image_dataset_config(paths, kind):
    return ConfigNode({
        "TYPE": kind, "BATCH_SIZE": 4, "IMAGE_SIZE": 32, "WORKERS": 1,
        "FEATURE_PATH": {"FEATURES": None, "IMAGE": paths["images"], "SCENE_TEXT": None},
    })


def test_vlsp_vocab_matches_the_jax_package(evjvqa):
    ours = builders.build_vocab(_vocab_config(evjvqa))
    theirs = jax_builders.build_vocab(_vocab_config(evjvqa))
    assert ours.itos == theirs.itos
    assert (ours.max_question_length, ours.max_answer_length) == \
        (theirs.max_question_length, theirs.max_answer_length)
    assert any(len(word) == 1 and not word.isascii() for word in ours.stoi)  # Japanese chars
    with open(evjvqa["public_test"]) as handle:
        unseen = {w for a in json.load(handle)["annotations"]
                  for w in multilingual_tokenize(a["question"], None)}
    assert unseen - set(ours.stoi) == unseen - set(theirs.stoi)


@pytest.mark.parametrize("kind,split,shuffle", [
    ("MultilingualImageQuestionDataset", "train", True),
    ("MultilingualImageQuestionDictionaryDataset", "dev", False),
    ("ImageQuestionDataset", "train", True),
    ("ImageQuestionDictionaryDataset", "public_test", False),
])
def test_image_datasets_match_the_jax_package(evjvqa, kind, split, shuffle):
    """Loader batches of both packages on the EVJVQA set: the same pixels,
    token arrays and host fields (raw questions, answers) batch for batch."""
    ours_vocab = builders.build_vocab(_vocab_config(evjvqa))
    theirs_vocab = jax_builders.build_vocab(_vocab_config(evjvqa))
    config = _image_dataset_config(evjvqa, kind)
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
    assert got[0]["pixel_values"].shape == (4, 32, 32, 3)


@pytest.mark.parametrize("kind,split", [
    ("MultilingualFeatureDataset", "train"), ("MultilingualDictionaryDataset", "dev"),
    ("RawQuestionFeatureDataset", "train"), ("RawQuestionDictionaryDataset", "test"),
])
def test_multilingual_feature_datasets_match_the_jax_package(synthetic_data, kind, split):
    vocab_config = _vocab_config(synthetic_data | {"public_test": synthetic_data["test"]})
    ours = builders.build_vocab(vocab_config)
    theirs = jax_builders.build_vocab(vocab_config)
    config = ConfigNode({"TYPE": kind, "BATCH_SIZE": 4,
                         "FEATURE_PATH": {"FEATURES": synthetic_data["features"]}})
    got = list(DataLoader(builders.build_dataset(synthetic_data[split], ours, config),
                          batch_size=4, num_workers=1))
    want = list(JaxDataLoader(jax_builders.build_dataset(synthetic_data[split], theirs, config),
                              batch_size=4, num_workers=1))
    assert len(got) == len(want)
    for batch, expected in zip(got, want):
        for key, value in expected.arrays().items():
            np.testing.assert_array_equal(batch.arrays()[key], value, err_msg=key)
        assert batch.host_fields() == expected.host_fields()


def test_hf_tokenizer_raises_until_its_files_exist(evjvqa, tmp_path):
    """A configured tokenizer whose files do not resolve locally fails the
    dataset's build; it never falls back to the vocab's ids."""
    vocab = builders.build_vocab(_vocab_config(evjvqa))
    config = _image_dataset_config(evjvqa, "MultilingualImageQuestionDataset").merged(
        {"HF_TOKENIZER": str(tmp_path / "no_tokenizer_here")})
    with pytest.raises(FileNotFoundError, match="tokenizer files"):
        builders.build_dataset(evjvqa["train"], vocab, config)


# -- the model ------------------------------------------------------------------------------
class _Vocab:
    padding_idx, bos_idx, eos_idx, unk_idx = 0, 1, 2, 3
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
    return ConfigNode({
        "NAME": "vit_mt5_port_test", "ARCHITECTURE": "ViTmT5", "D_MODEL": D, "DROPOUT": dropout,
        "VISION_EMBEDDING": {
            "ARCHITECTURE": "ViTEmbedding", "D_MODEL": D, "DROPOUT": dropout,
            "D_PRETRAINED_FEATURE": HIDDEN, "PATCH_SIZE": 16, "PRETRAINED_LAYERS": 1,
            "PRETRAINED_HEADS": 3, "IMAGE_SIZE": 32,
        },
        "TEXT_EMBEDDING": {
            "ARCHITECTURE": "T5Embedding", "D_MODEL": D, "DROPOUT": dropout,
            "PRETRAINED_NAME": "google/mt5-small", "D_PRETRAINED_FEATURE": HIDDEN,
            "PRETRAINED_LAYERS": 2, "PRETRAINED_D_FF": 96, "PRETRAINED_VOCAB_SIZE": 64,
        },
        "DECODER": {
            "ARCHITECTURE": "Decoder", "D_MODEL": D, "LAYERS": 2,
            "ATTENTION": {"SELF_ATTENTION": _attention(True, dropout),
                          "ENC_ATTENTION": _attention(False, dropout)},
            "TEXT_EMBEDDING": {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": D, "D_EMBEDDING": D,
                               "DROPOUT": dropout, "WORD_EMBEDDING": None},
        },
    })


def _numpy_batch(seed, bs, vocab):
    rng = np.random.default_rng(seed)
    questions = rng.integers(4, len(vocab), size=(bs, vocab.max_question_length)).astype(np.int32)
    questions[1, -4:] = vocab.padding_idx
    answers = rng.integers(4, len(vocab), size=(bs, vocab.max_answer_length)).astype(np.int32)
    answers[:, 0] = vocab.bos_idx
    answers[0, -2:] = vocab.padding_idx
    shifted = np.concatenate([answers[:, 1:], np.zeros((bs, 1), np.int32)], axis=1)
    return {
        "pixel_values": rng.normal(size=(bs, 32, 32, 3)).astype(np.float32),
        "question_tokens": questions, "answer_tokens": answers,
        "shifted_right_answer_tokens": shifted, "sample_valid": np.ones((bs,), bool),
    }


def _with_final_ln_bias(params, seed=0):
    """The flax tree with a nonzero bias on the ViT's final
    LayerNorm.  ViTEmbedding marks a token as padding when its features sum to
    zero (``padding_bias(features, 0)``, as the JAX package computes it); under
    a zero bias every token's normalised features sum to zero up to rounding,
    and which ones come out exactly zero would differ between the frameworks."""
    params = jax.tree.map(np.array, params)
    final = params["vision_encoder"]["backbone"]["final_layernorm"]
    final["bias"] = np.random.default_rng(seed).normal(
        scale=0.02, size=final["bias"].shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, params)


@pytest.fixture(scope="module")
def pair():
    """(flax ViTmT5, its params, the port's ViTmT5 with those params)."""
    vocab, config = _Vocab(), _model_config()
    flax_model = JaxViTmT5(config, vocab)
    batch = {k: jnp.asarray(v) for k, v in _numpy_batch(0, 3, vocab).items()}
    params = _with_final_ln_bias(jax.jit(lambda r, b: flax_model.init(r, b, train=False))(
        jax.random.PRNGKey(0), batch)["params"])
    port = builders.build_model(config, vocab).eval()
    state = params_from_flax(jax.tree.map(np.asarray, params))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return flax_model, params, port


def _inverse_bridge(state, config):
    """The port's state dict -> the flax tree, by hf_conversion's backbone
    converters and torch_conversion's decoder (no MODEL_CONVERTERS entry)."""
    def under(prefix):
        return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}

    sd = torch_conversion.StateDict(state)
    vision = hf_conversion.convert_vit_weights(
        under("vision_encoder.backbone."), config.VISION_EMBEDDING.PRETRAINED_LAYERS)
    vision["Dense_0"] = torch_conversion.linear(sd, "vision_encoder.proj")
    text = {
        "backbone": hf_conversion.convert_t5_encoder_weights(
            under("text_embedding.backbone."), config.TEXT_EMBEDDING.PRETRAINED_LAYERS),
        "Dense_0": torch_conversion.linear(sd, "text_embedding.proj"),
    }
    return {
        "vision_encoder": vision, "text_embedding": text,
        "fusion": torch_conversion.linear(sd, "fusion"),
        "decoder": torch_conversion.decoder(sd, "decoder", config.DECODER.LAYERS),
    }


def test_params_round_trip(pair):
    """params_from_flax and its inverse from hf_conversion's converters give
    back every flax tensor; the port's backbones hold HF's names."""
    flax_model, params, port = pair
    state = port.state_dict()
    for name in ("vision_encoder.backbone.embeddings.patch_embeddings.projection.weight",
                 "vision_encoder.backbone.encoder.layer.0.attention.attention.query.weight",
                 "text_embedding.backbone.shared.weight",
                 "text_embedding.backbone.encoder.block.0.layer.0.SelfAttention.q.weight",
                 "text_embedding.backbone.encoder.block.0.layer.0.SelfAttention"
                 ".relative_attention_bias.weight"):
        assert name in state, name
    back = _inverse_bridge(state, flax_model.config)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), np.asarray(want),
                                      err_msg=str(path))


def test_teacher_forced_log_probs_match_jax(pair):
    flax_model, params, port = pair
    batch = _numpy_batch(1, 3, flax_model.vocab)
    want = flax_model.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = port({k: _t(v) for k, v in batch.items()})
    _close(got, want)


@pytest.mark.parametrize("parts", ["layer", "none"])
def test_beam3_generate_matches_jax(pair, monkeypatch, parts):
    """Beam-3 generate of a numpy batch against the JAX package's: identical
    tokens, log-probs within 1e-4, on the layer route and the modules' plain
    route."""
    flax_model, params, port = pair
    batch = _numpy_batch(2, 3, flax_model.vocab)
    monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL_PARTS", parts)
    want_tokens, want_logprobs = jdecode.generate(
        flax_model, {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
        batch_size=3, beam_size=3)
    got_tokens, got_logprobs = decode.generate(port, {k: _t(v) for k, v in batch.items()}, 3)
    np.testing.assert_array_equal(got_tokens.numpy(), np.asarray(want_tokens))
    _close(got_logprobs, want_logprobs, atol=1e-4)


def test_bert_family_text_wrappers_raise_until_ported():
    """The BERT-layout wrappers build under ViTmBERTGeneration, and so do
    ALBERT and DeBERTa, once refused."""
    small = {"D_PRETRAINED_FEATURE": HIDDEN, "PRETRAINED_LAYERS": 1, "NUM_ATTENTION_HEADS": 3,
             "PRETRAINED_VOCAB_SIZE": 64}
    for name in ("BertEmbedding", "RobertaEmbedding", "XLMRobertaEmbedding"):
        config = _model_config().merged({"ARCHITECTURE": "ViTmBERTGeneration",
                                         "TEXT_EMBEDDING": {"ARCHITECTURE": name, **small}})
        model = builders.build_model(config, _Vocab())
        assert "text_embedding.backbone.encoder.layer.0.attention.self.query.weight" in (
            model.state_dict())
    for name, key in (("AlbertEmbedding", "embeddings.word_embeddings.weight"),
                      ("DebertaEmbedding", "encoder.rel_embeddings.weight")):
        config = _model_config().merged({"ARCHITECTURE": "ViTmBERTGeneration",
                                         "TEXT_EMBEDDING": {"ARCHITECTURE": name, **small}})
        model = builders.build_model(config, _Vocab())
        assert f"text_embedding.backbone.{key}" in model.state_dict()


# -- the task ----------------------------------------------------------------------------
GRADIENT_FREE = "fc_k.bias"  # softmax(q . (k + b)) does not depend on b
BACKBONES = ("vision_encoder.backbone.", "text_embedding.backbone.")


def _task_config(paths, tmp_path, dropout=0.1, **training):
    dataset = {"BATCH_SIZE": 6, "WORKERS": 1, "IMAGE_SIZE": 32,
               "FEATURE_PATH": {"FEATURES": None, "IMAGE": paths["images"], "SCENE_TEXT": None}}
    return ConfigNode({
        "TASK": "VlspEvjVqaTask",
        "DATASET": {
            "FEATURE_DATASET": dict(dataset, TYPE="MultilingualImageQuestionDataset"),
            "DICT_DATASET": dict(dataset, TYPE="MultilingualImageQuestionDictionaryDataset"),
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


def test_train_step_matches_jax_with_frozen_backbones(evjvqa, tmp_path):
    """One VlspEvjVqaTask step, loss and the Adam update, against the JAX
    package's OpenEndedTask._train_step on the same bridged weights and numpy
    batch, every dropout rate 0.  Loss rtol 1e-5; weights atol 5e-6 (see
    tests/test_torch_port_generative.py::test_train_step_matches_jax, whose
    bound this is; the key biases are held to +-lr).  Both backbones are
    unchanged on both sides: no gradient reaches them (stop_gradient there,
    requires_grad off and torch.no_grad() here)."""
    config = _task_config(evjvqa, tmp_path, dropout=0.0)
    task = builders.build_task(config, "cpu")
    host = next(iter(task.train_dataloader))
    jax_batch = {key: jnp.asarray(value) for key, value in host.arrays().items()}

    jax_model = JaxViTmT5(config.MODEL, task.vocab)
    params = _with_final_ln_bias(jax.jit(lambda r, b: jax_model.init(r, b, train=False))(
        jax.random.PRNGKey(0), jax_batch)["params"])
    before = params_from_flax(params)
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
        if name.startswith(BACKBONES):
            np.testing.assert_array_equal(tensor.numpy(), before[name], err_msg=name)
            np.testing.assert_array_equal(want[name], before[name], err_msg=name)
        elif name.endswith(GRADIENT_FREE):
            for after in (tensor.numpy(), want[name]):
                assert np.abs(after - before[name]).max() <= 1.01 * lr, name
        else:
            np.testing.assert_allclose(tensor.numpy(), want[name], atol=5e-6, rtol=0,
                                       err_msg=name)


def test_gradient_step_skips_the_frozen_backbones(evjvqa, tmp_path):
    """The training route at dropout 0.1: every trainable parameter gets a
    finite, non-zero gradient (the key biases only finite), the backbones
    none at all."""
    task = builders.build_task(_task_config(evjvqa, tmp_path), "cpu")
    _, batch = next(task.device_batches(task.train_dataloader))
    task.optimizer.zero_grad(set_to_none=True)
    task.compute_loss(batch).backward()
    frozen = 0
    for name, param in task.model.named_parameters():
        if name.startswith(BACKBONES):
            frozen += 1
            assert not param.requires_grad and param.grad is None, name
            continue
        assert param.grad is not None and bool(torch.isfinite(param.grad).all()), name
        assert name.endswith(GRADIENT_FREE) or float(param.grad.abs().max()) > 0.0, name
    assert frozen > 0


def test_vlsp_evjvqa_task_end_to_end(evjvqa, tmp_path):
    """XE training for one epoch, beam-3 dev eval, checkpoints, then
    get_predictions() writing both test splits' files; evaluate_metrics on
    the dev split scores."""
    config = _task_config(evjvqa, tmp_path)
    task = builders.build_task(config, "cpu")
    assert task.dev_dict_dataloader.batch_size == 2  # BATCH_SIZE // beam
    assert task.train_dict_dataloader.batch_size == 2
    task.start()
    ckpt_dir = os.path.join(config.TRAINING.CHECKPOINT_PATH, config.MODEL.NAME)
    assert os.path.isfile(os.path.join(ckpt_dir, "best_model.pth"))
    scores = task.get_predictions()
    assert sorted(scores) == ["private_test", "public_test"]
    for split, name in (("public_test", "public_test_results.json"),
                        ("private_test", "private_test_results.json")):
        with open(os.path.join(ckpt_dir, name)) as handle:
            dumped = json.load(handle)
        with open(evjvqa[split]) as handle:
            want_ids = sorted(a["id"] for a in json.load(handle)["annotations"])
        assert sorted(i for r in dumped["results"] for i in r["id"]) == want_ids
        assert "CIDEr" in dumped and all(isinstance(g, str) for r in dumped["results"]
                                         for g in r["gens"].values())
    dev = task.evaluate_metrics(task.dev_dict_dataloader)
    assert np.isfinite(dev["CIDEr"])


def test_entry_points_default_to_the_card(monkeypatch):
    """build_task and the command line put the model on cuda unless told
    otherwise."""
    assert inspect.signature(builders.build_task).parameters["device"].default == "cuda"
    seen = {}

    def fake_build_task(config, device):
        seen["device"] = device
        return types.SimpleNamespace(start=lambda: None, get_predictions=lambda: None)

    monkeypatch.setattr(train, "build_task", fake_build_task)
    train.main(["--config-file", "configs/vit_mt5.yaml"])
    assert seen["device"] == "cuda"
