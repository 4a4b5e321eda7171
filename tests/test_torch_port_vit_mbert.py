"""The port's BERT-family slice (configs/vit_mbert_classification.yaml under
ClassificationTask, configs/vit_mbert_generation.yaml under VlspEvjVqaTask) on
the CPU against the JAX package, at small sizes.

The host tokenizer is held against the JAX copy on a few-word WordPiece
``vocab.txt`` the test writes; the multilingual classification vocab and the
four new datasets (two RawQuestion feature / dictionary datasets, with and
without HF_TOKENIZER, and the two image classification datasets) against the
JAX copies on one synthetic EVJVQA set with Japanese questions and a ViT-shaped
feature store; the BERT-layout text wrapper (2 layers of 64, 2 heads, 50 rows)
against flax, and its backbone against an HF ``BertModel`` loaded by
``load_state_dict``; a small ViTmBERTClassification (ViT 1 x 48 on 32 x 32
images) and ViTmBERTGeneration (grid features) against the flax models on
bridged weights, the bridges' round trips, beam-3 ``generate()``; both tasks
end to end from the YAMLs at small widths.  Float32 on both sides: modules and
log-probs within 1e-5, tokens equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvivqa_tpu import builders as jax_builders
from openvivqa_tpu.data import hf_tokenization as jax_hf
from openvivqa_tpu.data.loader import DataLoader as JaxDataLoader
from openvivqa_tpu.models.modules import hf_conversion, torch_conversion
from openvivqa_tpu.models.modules.pretrained_embeddings import BertEmbedding as JaxBertEmbedding
from openvivqa_tpu.models.vit_models import ViTmBERTClassification as JaxViTmBERTClassification
from openvivqa_tpu.models.vit_models import ViTmBERTGeneration as JaxViTmBERTGeneration
from openvivqa_tpu.training import decode as jdecode
from openvivqa_tpu_torch import builders
from openvivqa_tpu_torch.config import ConfigNode, get_config
from openvivqa_tpu_torch.data import hf_tokenization, synthetic
from openvivqa_tpu_torch.data.loader import DataLoader
from openvivqa_tpu_torch.data.text_utils import is_japanese_sentence
from openvivqa_tpu_torch.models import convert
from openvivqa_tpu_torch.models.convert import params_from_flax
from openvivqa_tpu_torch.training import decode

jax_builders.populate()
builders.populate()

D = 32  # model width
BERT = {"D_PRETRAINED_FEATURE": 64, "PRETRAINED_LAYERS": 2, "NUM_ATTENTION_HEADS": 2,
        "PRETRAINED_VOCAB_SIZE": 50, "PRETRAINED_NAME": "bert-base-multilingual-uncased"}
WORDPIECE = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "con", "meo", "mau", "gi", "do",
             "xanh", "nguoi", "##s", "##a", "?", "こ", "れ"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=1e-5, rtol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def evjvqa(tmp_path_factory):
    root = tmp_path_factory.mktemp("evjvqa_vit")
    paths = synthetic.generate_evjvqa_dataset(str(root), n_images=8, n_questions_per_image=3,
                                              ja_share=0.4, seed=5)
    paths["vit"] = str(root / "vit")
    synthetic.write_vit_features(paths["vit"], 8, seed=5)
    return paths


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    """A few-word WordPiece tokenizer in local files (BertTokenizer, lower case)."""
    root = tmp_path_factory.mktemp("wordpiece")
    (root / "vocab.txt").write_text("\n".join(WORDPIECE) + "\n")
    (root / "tokenizer_config.json").write_text(
        json.dumps({"tokenizer_class": "BertTokenizer", "do_lower_case": True}))
    return str(root)


# -- the tokenizer ---------------------------------------------------------------------------
def test_backbone_token_table_matches_the_jax_package(evjvqa, tokenizer_dir):
    with open(evjvqa["train"]) as handle:
        annotations = [{"raw_question": a["question"]}
                       for a in json.load(handle)["annotations"]]
    annotations += [{"raw_question": "Con mèo màu gì ?"}, {"raw_question": "cons"}]
    config = ConfigNode({"HF_TOKENIZER": tokenizer_dir})
    ours = hf_tokenization.backbone_token_table(config, annotations)
    theirs = jax_hf.backbone_token_table(config, annotations)
    assert list(ours) == list(theirs) and len(ours) > 2
    for question, (ids, mask) in theirs.items():
        np.testing.assert_array_equal(ours[question][0], ids, err_msg=question)
        np.testing.assert_array_equal(ours[question][1], mask, err_msg=question)
    ids, mask = ours["Con mèo màu gì ?"]
    assert ids.dtype == np.int32 and mask.dtype == np.float32
    assert ids[:7].tolist() == [2, 5, 6, 7, 8, 14, 3] and mask.sum() == 7  # [CLS] ... [SEP]
    assert hf_tokenization.backbone_token_table(ConfigNode({}), annotations) is None


def test_unresolvable_tokenizer_is_an_error(tmp_path):
    with pytest.raises(FileNotFoundError, match="no local tokenizer files"):
        hf_tokenization.HostTokenizer(str(tmp_path / "missing"))


# -- vocab and datasets ----------------------------------------------------------------------
def _vocab_config(paths, kind):
    return ConfigNode({
        "TYPE": kind, "TOKENIZER": None, "MIN_FREQ": 1, "WORD_EMBEDDING": None,
        "WORD_EMBEDDING_CACHE": None, "PAD_TOKEN": "<pad>", "BOS_TOKEN": "<bos>",
        "EOS_TOKEN": "<eos>", "UNK_TOKEN": "<unk>",
        "JSON_PATH": {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["public_test"]},
    })


def test_multilingual_classification_vocab_matches_the_jax_package(evjvqa):
    config = _vocab_config(evjvqa, "MultilingualClassificationVocab")
    ours, theirs = builders.build_vocab(config), jax_builders.build_vocab(config)
    assert ours.itoa == theirs.itoa and ours.atoi == theirs.atoi
    assert ours.total_answers == theirs.total_answers
    assert ours.itos == theirs.itos and ours.max_question_length == theirs.max_question_length
    # a Japanese answer is one class of space-joined characters
    assert any(" " in a and not a.isascii() for a in ours.itoa.values())


DATASETS = [
    ("RawQuestionMultilingualFeatureDataset", "VlspEvjVqaVocab", "vit", False),
    ("RawQuestionMultilingualFeatureDataset", "VlspEvjVqaVocab", "vit", True),
    ("RawQuestionMultilingualDictionaryDataset", "VlspEvjVqaVocab", "vit", False),
    ("RawQuestionMultilingualDictionaryDataset", "VlspEvjVqaVocab", "vit", True),
    ("ImageQuestionClassificationDataset", "ClassificationVocab", "images", False),
    ("MultilingualImageQuestionClassificationDataset", "MultilingualClassificationVocab",
     "images", False),
]


@pytest.mark.parametrize("kind,vocab_kind,store,tokenized", DATASETS)
def test_datasets_match_the_jax_package(evjvqa, tokenizer_dir, kind, vocab_kind, store,
                                        tokenized):
    """Every batch of the train split, arrays and host fields, equal to the
    JAX copy's; with HF_TOKENIZER the backbone ids and mask too."""
    vocab_config = _vocab_config(evjvqa, vocab_kind)
    ours, theirs = builders.build_vocab(vocab_config), jax_builders.build_vocab(vocab_config)
    path = {"FEATURES": evjvqa["vit"]} if store == "vit" else {
        "FEATURES": None, "IMAGE": evjvqa["images"]}
    config = ConfigNode({"TYPE": kind, "BATCH_SIZE": 4, "IMAGE_SIZE": 32, "FEATURE_PATH": path,
                         **({"HF_TOKENIZER": tokenizer_dir} if tokenized else {})})
    if vocab_kind == "ClassificationVocab":  # word-level answers: Vietnamese questions only
        with open(evjvqa["train"]) as handle:
            data = json.load(handle)
        data["annotations"] = [a for a in data["annotations"]
                               if not is_japanese_sentence(a["question"])]
        json_path = os.path.join(os.path.dirname(evjvqa["train"]), "vi_only.json")
        with open(json_path, "w") as handle:
            json.dump(data, handle, ensure_ascii=False)
        vocab_config = vocab_config.merged({"JSON_PATH": {"TRAIN": json_path}})
        ours, theirs = builders.build_vocab(vocab_config), jax_builders.build_vocab(vocab_config)
    else:
        json_path = evjvqa["train"]
    got = list(DataLoader(builders.build_dataset(json_path, ours, config), batch_size=4,
                          num_workers=1))
    want = list(JaxDataLoader(jax_builders.build_dataset(json_path, theirs, config),
                              batch_size=4, num_workers=1))
    assert len(got) == len(want) > 0
    for batch, expected in zip(got, want):
        assert sorted(batch.arrays()) == sorted(expected.arrays())
        for key, value in expected.arrays().items():
            np.testing.assert_array_equal(batch.arrays()[key], value, err_msg=key)
        assert batch.host_fields() == expected.host_fields()
    assert ("question_backbone_tokens" in got[0].arrays()) == tokenized


def test_vit_feature_store_is_vit_base_shaped(evjvqa):
    store = np.load(os.path.join(evjvqa["vit"], "0.npy"), allow_pickle=True)[()]
    assert sorted(store) == ["grid_features"]
    assert store["grid_features"].shape == (197, 768)
    assert (np.abs(store["grid_features"]).sum(-1) > 0).all()  # no row reads as padding


# -- the BERT-layout wrapper -------------------------------------------------------------------
class _Vocab:
    padding_idx, bos_idx, eos_idx, unk_idx = 0, 1, 2, 3
    max_question_length = 9
    max_answer_length = 6
    word_embeddings = None
    total_answers = 7

    def __len__(self):
        return 40


def _text_config(dropout=0.1, **extra):
    return ConfigNode({"ARCHITECTURE": "BertEmbedding", "D_MODEL": D, "DROPOUT": dropout,
                       **BERT, **extra})


@pytest.mark.parametrize("padding", ["vocab ids", "tokenizer mask"])
def test_bert_wrapper_matches_flax(padding):
    """Output and padding bias of the wrapper (the frozen BERT, projection,
    GELU) against flax's at atol 1e-5; padding from the vocab's pad id, or from
    a tokenizer's validity mask with pad id 1 (the RoBERTa family's)."""
    vocab, config = _Vocab(), _text_config()
    rng = np.random.default_rng(0)
    tokens = rng.integers(4, 50, size=(3, 9)).astype(np.int32)
    mask = np.ones((3, 9), np.float32)
    tokens[1, -3:], mask[1, -3:] = (0, 0.0) if padding == "vocab ids" else (1, 0.0)
    kwargs = {} if padding == "vocab ids" else {"padding_idx": 1, "padding_mask": mask}
    flax_module = JaxBertEmbedding(config, vocab)
    mask_kw = {"padding_mask": jnp.asarray(mask)} if kwargs else {}
    pad = kwargs.get("padding_idx")
    params = jax.jit(lambda r, t, m: flax_module.init(r, t, padding_idx=pad, **m))(
        jax.random.PRNGKey(0), jnp.asarray(tokens), mask_kw)["params"]
    want, want_bias = jax.jit(lambda p, t, m: flax_module.apply(
        {"params": p}, t, padding_idx=pad, **m))(params, jnp.asarray(tokens), mask_kw)
    port = builders.build_text_embedding(config, vocab).eval()
    state = {}
    convert._pretrained_text_embedding(state, "wrapper", jax.tree.map(np.asarray, params))
    port.load_state_dict({k[len("wrapper."):]: torch.from_numpy(v) for k, v in state.items()})
    with torch.no_grad():
        got, got_bias = port(_t(tokens), **{k: _t(v) if k == "padding_mask" else v
                                            for k, v in kwargs.items()})
    _close(got, want)
    _close(got_bias, want_bias)
    assert not any(p.requires_grad for p in port.backbone.parameters())
    assert all(p.requires_grad for p in port.proj.parameters())


def test_bert_backbone_loads_an_hf_checkpoint():
    """The backbone's parameters are HF BertModel's names: a BertModel's
    state dict without the pooler loads by load_state_dict (strict), and the
    backbone's eval route (kernels F and C's plain versions here) then gives
    BertModel's last hidden states within 1e-5."""
    from transformers import BertConfig, BertModel

    torch.manual_seed(0)
    hf = BertModel(BertConfig(vocab_size=50, hidden_size=64, num_hidden_layers=2,
                              num_attention_heads=2, intermediate_size=128,
                              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                              layer_norm_eps=1e-12), add_pooling_layer=False).eval()
    port = builders.build_text_embedding(
        _text_config(PRETRAINED_INTERMEDIATE_SIZE=128), _Vocab()).backbone.eval()
    port.load_state_dict(hf.state_dict())
    assert "encoder.layer.1.attention.self.query.weight" in port.state_dict()
    tokens = torch.randint(4, 50, (3, 9), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(3, 9)
    mask[1, -3:] = 0.0
    with torch.no_grad():
        want = hf(input_ids=tokens, attention_mask=mask).last_hidden_state
        got = port(tokens, ((1.0 - mask) * -10e4)[:, None, None, :])
    valid = mask.bool()
    _close(got[valid], want[valid].numpy())


def test_albert_and_deberta_still_refuse():
    """ALBERT and DeBERTa, once refused, now build under ViTmBERTClassification
    with their backbones under HF's names and run a forward to finite
    log-probs."""
    small = {"D_PRETRAINED_FEATURE": 32, "PRETRAINED_LAYERS": 2, "NUM_ATTENTION_HEADS": 4,
             "PRETRAINED_VOCAB_SIZE": 64, "PRETRAINED_INTERMEDIATE_SIZE": 48}
    keys = {"AlbertEmbedding": "text_embedding.backbone.encoder.albert_layer_groups.0."
                               "albert_layers.0.attention.query.weight",
            "DebertaEmbedding": "text_embedding.backbone.encoder.layer.1.attention.self."
                                "query_proj.weight"}
    vocab = _Vocab()
    for name, key in keys.items():
        config = _classification_config().merged(
            {"TEXT_EMBEDDING": {"ARCHITECTURE": name, **small}})
        model = builders.build_model(config, vocab).eval()
        assert key in model.state_dict()
        batch = {k: torch.from_numpy(v) for k, v in _numpy_batch(3, 2, vocab).items()}
        with torch.no_grad():
            out = model(batch)
        assert out.shape == (2, vocab.total_answers) and bool(torch.isfinite(out).all())


# -- the two models ----------------------------------------------------------------------------
def _vit_config(dropout=0.1):
    return {"ARCHITECTURE": "ViTEmbedding", "D_MODEL": D, "DROPOUT": dropout,
            "D_PRETRAINED_FEATURE": 48, "PATCH_SIZE": 16, "PRETRAINED_LAYERS": 1,
            "PRETRAINED_HEADS": 2, "IMAGE_SIZE": 32}


def _classification_config(dropout=0.1):
    return ConfigNode({
        "NAME": "vit_mbert_classification_port_test", "ARCHITECTURE": "ViTmBERTClassification",
        "D_MODEL": D, "DROPOUT": dropout, "VISION_EMBEDDING": _vit_config(dropout),
        "TEXT_EMBEDDING": _text_config(dropout).to_dict(),
    })


def _attention(stateful=False, dropout=0.1):
    return {"ARCHITECTURE": "ScaledDotProductAttention", "HEAD": 2, "D_MODEL": D, "D_KEY": D // 2,
            "D_VALUE": D // 2, "D_FF": 2 * D, "USE_AOA": False, "CAN_BE_STATEFUL": stateful,
            "DROPOUT": dropout}


GRIDS, D_GRID = 9, 24


def _generation_config(dropout=0.1):
    return ConfigNode({
        "NAME": "vit_mbert_generation_port_test", "ARCHITECTURE": "ViTmBERTGeneration",
        "D_MODEL": D, "DROPOUT": dropout,
        "VISION_EMBEDDING": {"ARCHITECTURE": "FeatureEmbedding", "D_FEATURE": D_GRID,
                             "D_MODEL": D, "DROPOUT": dropout},
        "TEXT_EMBEDDING": _text_config(dropout).to_dict(),
        "DECODER": {
            "ARCHITECTURE": "Decoder", "D_MODEL": D, "LAYERS": 2,
            "ATTENTION": {"SELF_ATTENTION": _attention(True, dropout),
                          "ENC_ATTENTION": _attention(False, dropout)},
            "TEXT_EMBEDDING": {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": D, "D_EMBEDDING": D,
                               "DROPOUT": dropout, "WORD_EMBEDDING": None},
        },
    })


def _numpy_batch(seed, bs, vocab, pixels=True):
    rng = np.random.default_rng(seed)
    questions = rng.integers(4, len(vocab), size=(bs, vocab.max_question_length)).astype(np.int32)
    questions[1, -4:] = vocab.padding_idx
    answers = rng.integers(4, len(vocab), size=(bs, vocab.max_answer_length)).astype(np.int32)
    answers[:, 0] = vocab.bos_idx
    answers[0, -2:] = vocab.padding_idx
    shifted = np.concatenate([answers[:, 1:], np.zeros((bs, 1), np.int32)], axis=1)
    batch = {"question_tokens": questions, "answer_tokens": answers,
             "shifted_right_answer_tokens": shifted, "sample_valid": np.ones((bs,), bool)}
    if pixels:
        batch["pixel_values"] = rng.normal(size=(bs, 32, 32, 3)).astype(np.float32)
    else:
        batch["grid_features"] = rng.normal(size=(bs, GRIDS, D_GRID)).astype(np.float32)
        batch["grid_features"][2, -2:] = 0.0  # padding grid rows
    return batch


def _with_final_ln_bias(params):
    """A nonzero bias on the ViT's final LayerNorm: ViTEmbedding marks a token
    as padding when its features sum to zero, which under a zero bias is
    rounding noise that the two frameworks would break apart."""
    params = jax.tree.map(np.array, params)
    final = params["ViTEmbedding_0"]["backbone"]["final_layernorm"]
    final["bias"] = np.random.default_rng(0).normal(
        scale=0.02, size=final["bias"].shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, params)


def _pair(flax_cls, config, pixels):
    vocab = _Vocab()
    flax_model = flax_cls(config, vocab)
    batch = {k: jnp.asarray(v) for k, v in _numpy_batch(0, 3, vocab, pixels).items()}
    params = jax.jit(lambda r, b: flax_model.init(r, b, train=False))(
        jax.random.PRNGKey(0), batch)["params"]
    if pixels:
        params = _with_final_ln_bias(params)
    port = builders.build_model(config, vocab).eval()
    state = params_from_flax(jax.tree.map(np.asarray, params))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return flax_model, params, port


@pytest.fixture(scope="module")
def classification_pair():
    return _pair(JaxViTmBERTClassification, _classification_config(), pixels=True)


@pytest.fixture(scope="module")
def generation_pair():
    return _pair(JaxViTmBERTGeneration, _generation_config(), pixels=False)


def _bert_back(state, prefix):
    """The BERT wrapper's flax tree from the port's state dict, through
    hf_conversion.convert_bert_weights (which reads HF's names)."""
    under = {k[len(prefix) + len(".backbone."):]: v for k, v in state.items()
             if k.startswith(prefix + ".backbone.")}
    converted = hf_conversion.convert_bert_weights(under, BERT["PRETRAINED_LAYERS"])
    return {"BertEmbeddings_0": converted["embeddings"],
            "BertEncoderStack_0": converted["encoder"],
            "Dense_0": torch_conversion.linear(torch_conversion.StateDict(state), f"{prefix}.proj")}


def _assert_round_trip(params, back, state):
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want) == len(state)
    for path, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), np.asarray(want),
                                      err_msg=str(path))


def test_classification_params_round_trip(classification_pair):
    """params_from_flax, then hf_conversion's ViT and BERT converters on the
    port's state dict, give back every flax tensor; the backbones carry HF's
    names."""
    flax_model, params, port = classification_pair
    state = port.state_dict()
    for name in ("text_embedding.backbone.embeddings.word_embeddings.weight",
                 "text_embedding.backbone.encoder.layer.1.attention.self.query.weight",
                 "text_embedding.backbone.encoder.layer.0.output.LayerNorm.bias",
                 "vision_encoder.backbone.encoder.layer.0.attention.attention.query.weight",
                 "fusion.weight", "classify.bias"):
        assert name in state, name
    assert tuple(state["text_embedding.backbone.embeddings.word_embeddings.weight"].shape) == (
        50, 64)
    sd = torch_conversion.StateDict(state)
    vision = hf_conversion.convert_vit_weights(
        {k[len("vision_encoder.backbone."):]: v for k, v in state.items()
         if k.startswith("vision_encoder.backbone.")}, 1)
    vision["Dense_0"] = torch_conversion.linear(sd, "vision_encoder.proj")
    back = {"ViTEmbedding_0": vision, "BertEmbedding_0": _bert_back(state, "text_embedding"),
            "Dense_0": torch_conversion.linear(sd, "fusion"),
            "Dense_1": torch_conversion.linear(sd, "classify")}
    _assert_round_trip(params, back, state)


def test_classification_log_probs_match_jax(classification_pair):
    flax_model, params, port = classification_pair
    batch = _numpy_batch(1, 3, flax_model.vocab)
    want = flax_model.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = port({k: _t(v) for k, v in batch.items()})
    assert got.shape == (3, _Vocab.total_answers)
    _close(got, want)


def test_generation_params_round_trip(generation_pair):
    flax_model, params, port = generation_pair
    state = port.state_dict()
    sd = torch_conversion.StateDict(state)
    back = {
        "vision_encoder": {"Dense_0": torch_conversion.linear(sd, "vision_encoder.proj")},
        "text_embedding": _bert_back(state, "text_embedding"),
        "fusion": torch_conversion.linear(sd, "fusion"),
        "decoder": torch_conversion.decoder(sd, "decoder", 2),
    }
    _assert_round_trip(params, back, state)


def test_generation_teacher_forced_log_probs_match_jax(generation_pair):
    flax_model, params, port = generation_pair
    batch = _numpy_batch(1, 3, flax_model.vocab, pixels=False)
    want = flax_model.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = port({k: _t(v) for k, v in batch.items()})
    _close(got, want)


@pytest.mark.parametrize("parts", ["layer", "none"])
def test_generation_beam3_generate_matches_jax(generation_pair, monkeypatch, parts):
    """Beam-3 generate: identical tokens, log-probs within 1e-4, on the layer
    route and on the module route."""
    flax_model, params, port = generation_pair
    batch = _numpy_batch(2, 3, flax_model.vocab, pixels=False)
    monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL_PARTS", parts)
    want_tokens, want_logprobs = jdecode.generate(
        flax_model, {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
        batch_size=3, beam_size=3)
    got_tokens, got_logprobs = decode.generate(port, {k: _t(v) for k, v in batch.items()}, 3)
    np.testing.assert_array_equal(got_tokens.numpy(), np.asarray(want_tokens))
    _close(got_logprobs, want_logprobs, atol=1e-4)


# -- the tasks, from the YAMLs at small widths -------------------------------------------------
GRADIENT_FREE = "fc_k.bias"  # softmax(q . (k + b)) does not depend on b
BACKBONES = ("vision_encoder.backbone.", "text_embedding.backbone.")


def _yaml_config(name, paths, tmp_path, features):
    dataset = {"BATCH_SIZE": 6, "WORKERS": 1, "IMAGE_SIZE": 32, "FEATURE_PATH": features}
    json_paths = {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["public_test"],
                  "PUBLIC_TEST": paths["public_test"], "PRIVATE_TEST": paths["private_test"]}
    text = dict(BERT, D_MODEL=D, PRETRAINED_VOCAB_SIZE=64)
    model = {"D_MODEL": D, "TEXT_EMBEDDING": text}
    if name == "vit_mbert_classification":
        model["VISION_EMBEDDING"] = dict(_vit_config(), DEVICE="cuda")
        sections = {"FEATURE_DATASET": dataset}
    else:
        model["VISION_EMBEDDING"] = {"D_MODEL": D}
        model["DECODER"] = {"D_MODEL": D, "LAYERS": 1, "TEXT_EMBEDDING": {"D_MODEL": D},
                            "ATTENTION": {"SELF_ATTENTION": _attention(True),
                                          "ENC_ATTENTION": _attention(False)}}
        sections = {"FEATURE_DATASET": dataset, "DICT_DATASET": dataset}
    return get_config(f"configs/{name}.yaml").merged({
        "DATASET": {**sections, "JSON_PATH": json_paths, "MIN_FREQ": 1,
                    "VOCAB": {"MIN_FREQ": 1, "JSON_PATH": {
                        "TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["public_test"]}}},
        "MODEL": model,
        "TRAINING": {"CHECKPOINT_PATH": str(tmp_path / "saved_models"), "MAX_EPOCHS": 1,
                     "SEED": 3, "WARMUP": 100},
    })


def _one_gradient_step(task, batch):
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
    return frozen


def test_vit_mbert_classification_end_to_end(evjvqa, tmp_path):
    """configs/vit_mbert_classification.yaml under ClassificationTask: the
    multilingual image classification dataset, the frozen ViT and BERT, one
    gradient step (none on the backbones), start() for one epoch, checkpoints
    and test predictions."""
    config = _yaml_config("vit_mbert_classification", evjvqa, tmp_path,
                          {"FEATURES": None, "IMAGE": evjvqa["images"]})
    task = builders.build_task(config, "cpu")
    assert type(task).__name__ == "ClassificationTask"
    assert type(task.model).__name__ == "ViTmBERTClassification"
    _, batch = next(task.device_batches(task.train_dataloader))
    assert tuple(batch["pixel_values"].shape[1:]) == (32, 32, 3)
    assert _one_gradient_step(task, batch) > 0
    task.start()
    ckpt_dir = os.path.join(config.TRAINING.CHECKPOINT_PATH, config.MODEL.NAME)
    for name in ("best_model.pth", "last_model.pth"):
        assert os.path.isfile(os.path.join(ckpt_dir, name)), name
    scores = task.get_predictions()
    assert np.isfinite(scores["CIDEr"])
    assert os.path.isfile(os.path.join(ckpt_dir, "test_results.json"))


def test_vit_mbert_generation_end_to_end(evjvqa, tmp_path):
    """configs/vit_mbert_generation.yaml under VlspEvjVqaTask on the ViT-shaped
    store: one gradient step, XE for one epoch, the beam-3 dev eval,
    checkpoints and both test splits' predictions."""
    config = _yaml_config("vit_mbert_generation", evjvqa, tmp_path, {"FEATURES": evjvqa["vit"]})
    task = builders.build_task(config, "cpu")
    assert type(task.model).__name__ == "ViTmBERTGeneration"
    assert task.model.vision_encoder.proj.in_features == 768
    _, batch = next(task.device_batches(task.train_dataloader))
    assert tuple(batch["grid_features"].shape[1:]) == (197, 768)
    assert _one_gradient_step(task, batch) > 0
    task.start()
    ckpt_dir = os.path.join(config.TRAINING.CHECKPOINT_PATH, config.MODEL.NAME)
    assert os.path.isfile(os.path.join(ckpt_dir, "best_model.pth"))
    scores = task.get_predictions()
    assert sorted(scores) == ["private_test", "public_test"]
    assert all(np.isfinite(s["CIDEr"]) for s in scores.values())
