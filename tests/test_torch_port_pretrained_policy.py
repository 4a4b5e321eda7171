"""The pretrained-weights policy of the port against the JAX package's.

Both packages read the same files, which the tests write themselves (nothing is
downloaded): converted flax trees as ``.npz`` and ``.msgpack`` (from a random
flax site), and Hugging Face checkpoint directories (``save_pretrained`` of small
``transformers`` models, safetensors and ``pytorch_model.bin``, deeper than the
site so that both truncate).  After each package applies its policy to a random
wrapper the two wrappers give the same outputs within 1e-5.  Also: the same
requirements from every config, the refusal and its opt-out through the task,
the hub-cache layout, the port's msgpack and safetensors readers against flax's
and the safetensors package's.
"""

import json
import pathlib

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch
import transformers
from torch import nn

from openvivqa_tpu import builders as jax_builders
from openvivqa_tpu.config import ConfigNode as JaxConfigNode
from openvivqa_tpu.config import get_config as jax_get_config
from openvivqa_tpu.models.modules import pretrained_loading as jax_policy
from openvivqa_tpu_torch import builders
from openvivqa_tpu_torch.config import ConfigNode, get_config
from openvivqa_tpu_torch.models import convert
from openvivqa_tpu_torch.models.modules import pretrained_loading as policy
from openvivqa_tpu_torch.training.tasks.base_task import BaseTask

jax_builders.populate()
builders.populate()

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = "OPENVIVQA_ALLOW_RANDOM_BACKBONE"
SMALL = {"D_MODEL": 24, "DROPOUT": 0.1, "D_PRETRAINED_FEATURE": 32, "PRETRAINED_LAYERS": 2,
         "NUM_ATTENTION_HEADS": 4, "PRETRAINED_VOCAB_SIZE": 60,
         "PRETRAINED_INTERMEDIATE_SIZE": 48}
WRAPPERS = {
    "bert": ("BertEmbedding", {}),
    "roberta": ("RobertaEmbedding", {}),
    "albert": ("AlbertEmbedding", {"PRETRAINED_EMBEDDING_SIZE": 16}),
    "deberta": ("DebertaEmbedding", {}),
    "t5": ("T5Embedding", {"PRETRAINED_D_KV": 8, "PRETRAINED_D_FF": 48}),
    "vit": ("ViTEmbedding", {"PRETRAINED_HEADS": 4, "PATCH_SIZE": 8, "IMAGE_SIZE": 16}),
}


class _Vocab:
    padding_idx, bos_idx, eos_idx, unk_idx = 0, 1, 2, 3

    def __len__(self):
        return 60


class _Holder(nn.Module):
    def __init__(self, wrapper):
        super().__init__()
        self.wrapper = wrapper


def _t(x):
    return torch.from_numpy(np.array(x))


def _node(family, **extra):
    arch, spec = WRAPPERS[family]
    return {"ARCHITECTURE": arch, **SMALL, **spec, **extra}


def _inputs(family):
    rng = np.random.default_rng(0)
    if family == "vit":
        return rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    tokens = rng.integers(4, 50, size=(3, 9)).astype(np.int32)
    tokens[0, -3:] = 0
    return tokens


def _jax_wrapper(family, node):
    config = JaxConfigNode(node)
    if family == "vit":
        return jax_builders.build_vision_embedding(config)
    return jax_builders.build_text_embedding(config, _Vocab())


def _jax_params(wrapper, x, seed):
    return jax.tree.map(np.asarray,
                        wrapper.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])


def _v3_layout(family, params):
    """`params` with the JAX DebertaEmbedding's absolute position table zeroed.
    The JAX wrapper builds that table although deberta-v3's published config has
    none (position_biased_input false); the port's wrapper has none.  Zeroed, it
    adds nothing, so the two packages compute the same function."""
    if family != "deberta":
        return params
    table = params["backbone"]["position_embeddings"]["embedding"]
    backbone = dict(params["backbone"], position_embeddings={"embedding": np.zeros_like(table)})
    return dict(params, backbone=backbone)


def _port_wrapper(family, node, params):
    """The port's wrapper holding the flax `params` (bridged), in a holder; a
    DeBERTa wrapper takes them at v3's layout (``_v3_layout``)."""
    config = ConfigNode(node)
    if family == "vit":
        port = builders.build_vision_embedding(config)
    else:
        port = builders.build_text_embedding(config, _Vocab())
    state = {}
    (convert._vision_embedding if family == "vit" else convert._pretrained_text_embedding)(
        state, "w", params)
    if family == "deberta":
        assert not state.pop("w.backbone.embeddings.position_embeddings.weight").any()
    port.load_state_dict({key[2:]: _t(value) for key, value in state.items()})
    return _Holder(port.eval())


def _both_after_policy(family, node, monkeypatch):
    """(port output, JAX output) of the wrapper after each package's policy,
    both starting from the same random flax weights."""
    monkeypatch.delenv(ENV, raising=False)
    x = _inputs(family)
    jax_wrapper = _jax_wrapper(family, node)
    params = _v3_layout(family, _jax_params(jax_wrapper, x, 1))
    seeded, report = jax_policy.apply_pretrained_policy(JaxConfigNode({"TEXT": node}),
                                                        {"wrapper": params})
    assert report[0][1].split(":")[0] in ("converted", "hf_local"), report
    want = jax_wrapper.apply({"params": seeded["wrapper"]}, jnp.asarray(x))[0]
    holder = _port_wrapper(family, node, params)
    port_report = policy.apply_pretrained_policy(ConfigNode({"TEXT": node}), holder)
    assert [r[1] for r in port_report] == [r[1] for r in report]
    with torch.no_grad():
        got = holder.wrapper(_t(x))[0]
    return got, want, holder


# -- the requirements --------------------------------------------------------------------------
@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.yaml")), ids=lambda p: p.stem)
def test_requirements_match_jax(path):
    ours = policy.collect_pretrained_requirements(get_config(str(path)).MODEL)
    theirs = jax_policy.collect_pretrained_requirements(jax_get_config(str(path)).MODEL)
    assert [(r.path, r.arch, r.family, r.name, r.hidden) for r in ours] == [
        (r.path, r.arch, r.family, r.name, r.hidden) for r in theirs]


# -- converted files ---------------------------------------------------------------------------
def _converted_tree(family, params):
    """The tree scripts/convert_backbone.py would write for this site."""
    if family in ("bert", "roberta"):
        return {"embeddings": params["BertEmbeddings_0"], "encoder": params["BertEncoderStack_0"]}
    if family == "vit":
        return {key: value for key, value in params.items() if key != "Dense_0"}
    # deberta-v3's conversion has no absolute position table
    return {key: value for key, value in params["backbone"].items()
            if key != "position_embeddings"}


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        here = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            yield from _flatten(value, here)
        else:
            yield here, np.asarray(value)


@pytest.mark.parametrize("kind", ["npz", "msgpack"])
@pytest.mark.parametrize("family", ["bert", "albert", "deberta", "t5", "vit"])
def test_converted_file_loads_as_in_jax(family, kind, tmp_path, monkeypatch):
    node = _node(family)
    donor = _jax_params(_jax_wrapper(family, node), _inputs(family), 2)
    tree = _converted_tree(family, donor)
    path = tmp_path / f"backbone.{kind}"
    if kind == "npz":
        np.savez_compressed(path, **dict(_flatten(tree)))
    else:
        path.write_bytes(flax.serialization.msgpack_serialize(tree))
    got, want, _ = _both_after_policy(family, dict(node, CONVERTED_WEIGHTS=str(path)),
                                      monkeypatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


# -- Hugging Face checkpoint directories --------------------------------------------------------
def _hf_model(family):
    """A small transformers model at the wrapper's widths, one layer deeper
    (the site keeps the first two) and with smaller tables (padded)."""
    common = dict(hidden_size=32, num_hidden_layers=3, num_attention_heads=4,
                  intermediate_size=48)
    torch.manual_seed(5)
    if family == "bert":
        return transformers.BertForMaskedLM(transformers.BertConfig(
            vocab_size=50, max_position_embeddings=40, **common))
    if family == "roberta":
        return transformers.RobertaModel(transformers.RobertaConfig(
            vocab_size=50, max_position_embeddings=42, type_vocab_size=1, pad_token_id=1,
            **common))
    if family == "albert":
        return transformers.AlbertModel(transformers.AlbertConfig(
            vocab_size=50, embedding_size=16, max_position_embeddings=40, **common))
    if family == "deberta":
        return transformers.DebertaV2Model(transformers.DebertaV2Config(
            vocab_size=50, max_position_embeddings=512, relative_attention=True,
            position_biased_input=False, position_buckets=256, share_att_key=True, norm_rel_ebd="layer_norm",
            pos_att_type=["p2c", "c2p"], type_vocab_size=0, pad_token_id=0, **common))
    if family == "t5":
        return transformers.T5EncoderModel(transformers.T5Config(
            vocab_size=50, d_model=32, d_kv=8, d_ff=48, num_layers=3, num_heads=4,
            feed_forward_proj="gated-gelu"))
    return transformers.ViTModel(transformers.ViTConfig(
        image_size=16, patch_size=8, **common))


HF_CASES = [("bert", True), ("bert", False), ("roberta", True), ("albert", True),
            ("deberta", True), ("t5", True), ("vit", False)]


@pytest.mark.parametrize("family,safe", HF_CASES,
                         ids=[f"{f}-{'safetensors' if s else 'bin'}" for f, s in HF_CASES])
def test_hf_directory_loads_as_in_jax(family, safe, tmp_path, monkeypatch):
    directory = tmp_path / f"{family}-checkpoint"
    _hf_model(family).save_pretrained(str(directory), safe_serialization=safe)
    assert (directory / ("model.safetensors" if safe else "pytorch_model.bin")).is_file()
    got, want, holder = _both_after_policy(family, _node(family, PRETRAINED_NAME=str(directory)),
                                           monkeypatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    if family == "bert":  # the checkpoint's first two layers, its tables padded
        state, _ = policy.read_hf_checkpoint(str(directory))
        backbone = holder.wrapper.backbone
        torch.testing.assert_close(backbone.encoder.layer[1].output.dense.weight,
                                   state["bert.encoder.layer.1.output.dense.weight"])
        table = backbone.embeddings.word_embeddings.weight
        assert table.shape[0] == 60 and not bool(table[50:].any())


def test_loader_refuses_weights_that_leave_site_keys_unset():
    """A site key the weights lack raises, so no part of a backbone stays random
    without a word; the layers past a shallower checkpoint's depth keep their
    values."""
    node = _node("deberta")
    holder = _port_wrapper("deberta", node, _v3_layout("deberta", _jax_params(
        _jax_wrapper("deberta", node), _inputs("deberta"), 7)))
    site = holder.wrapper.backbone
    state = {key: value.clone() + 1.0 for key, value in site.state_dict().items()}
    with pytest.raises(KeyError, match="rel_embeddings"):
        policy.load_into_site(site, {key: value for key, value in state.items()
                                     if key != "encoder.rel_embeddings.weight"}, "site")
    layer_1 = {key: value.clone() for key, value in site.state_dict().items()
               if key.startswith("encoder.layer.1.")}
    policy.load_into_site(site, {key: value for key, value in state.items()
                                 if not key.startswith("encoder.layer.1.")}, "site")
    for key, value in layer_1.items():
        torch.testing.assert_close(site.state_dict()[key], value, rtol=0, atol=0)
    torch.testing.assert_close(site.encoder.rel_embeddings.weight,
                               state["encoder.rel_embeddings.weight"], rtol=0, atol=0)


def test_hub_cache_snapshot_resolves(tmp_path, monkeypatch):
    """PRETRAINED_NAME "org/name" found as models--org--name/snapshots/<rev>/
    under HF_HUB_CACHE (the revision refs/main names), loaded as its directory."""
    cache = tmp_path / "hub"
    snapshot = cache / "models--org--tiny-bert" / "snapshots" / "abc123"
    _hf_model("bert").save_pretrained(str(snapshot))
    (cache / "models--org--tiny-bert" / "refs").mkdir()
    (cache / "models--org--tiny-bert" / "refs" / "main").write_text("abc123")
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    assert policy.local_hf_dir("org/tiny-bert") == str(snapshot)
    holders = []
    for name in ("org/tiny-bert", str(snapshot)):
        holder = _port_wrapper("bert", _node("bert"), _jax_params(
            _jax_wrapper("bert", _node("bert")), _inputs("bert"), 3))
        report = policy.apply_pretrained_policy(
            ConfigNode({"TEXT": _node("bert", PRETRAINED_NAME=name)}), holder)
        assert report[0][1] == f"hf_local:{snapshot}"
        holders.append(holder)
    for a, b in zip(*(h.state_dict().values() for h in holders)):
        torch.testing.assert_close(a, b)


# -- the refusal -------------------------------------------------------------------------------
def _task_model_config(**text):
    return ConfigNode({
        "NAME": "policy_test", "ARCHITECTURE": "ViTmBERTClassification", "D_MODEL": 24,
        "DROPOUT": 0.1,
        "VISION_EMBEDDING": {"ARCHITECTURE": "FeatureEmbedding", "D_FEATURE": 8, "D_MODEL": 24,
                             "DROPOUT": 0.1},
        "TEXT_EMBEDDING": _node("bert", **text),
    })


class _ClassificationVocab(_Vocab):
    total_answers = 5


def _build(model_config):
    """BaseTask.build_model on a bare task: the seeded init, then the policy."""
    task = object.__new__(BaseTask)
    task.config = ConfigNode({"MODEL": model_config.to_dict(), "TRAINING": {"SEED": 0}})
    task.vocab = _ClassificationVocab()
    return BaseTask.build_model(task, None)


def test_task_refuses_unresolved_weights_unless_allowed(tmp_path, monkeypatch):
    missing = _task_model_config(PRETRAINED_NAME=str(tmp_path / "no-such-checkpoint"))
    monkeypatch.delenv(ENV, raising=False)
    with pytest.raises(FileNotFoundError, match=ENV):
        _build(missing)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        _build(_task_model_config(CONVERTED_WEIGHTS=str(tmp_path / "missing.npz")))
    monkeypatch.setenv(ENV, "1")
    model = _build(missing)
    assert "text_embedding.backbone.encoder.layer.1.attention.self.query.weight" in (
        model.state_dict())
    opted_out = _task_model_config(PRETRAINED_NAME=str(tmp_path / "no-such-checkpoint"),
                                   LOAD_PRETRAINED=False)
    monkeypatch.delenv(ENV, raising=False)
    _build(opted_out)  # LOAD_PRETRAINED: false opts the node out


def test_task_loads_converted_weights(tmp_path, monkeypatch):
    """The task's model holds the file's backbone; the projection stays seeded."""
    node = _node("bert")
    donor = _jax_params(_jax_wrapper("bert", node), _inputs("bert"), 4)
    path = tmp_path / "bert.npz"
    np.savez(path, **dict(_flatten(_converted_tree("bert", donor))))
    monkeypatch.delenv(ENV, raising=False)
    model = _build(_task_model_config(CONVERTED_WEIGHTS=str(path)))
    np.testing.assert_array_equal(
        model.text_embedding.backbone.encoder.layer[0].attention.self.query.weight.detach(),
        np.asarray(donor["BertEncoderStack_0"]["layer_0"]["BertSelfAttention_0"]["Dense_0"]
                   ["kernel"]).T)


# -- the readers -------------------------------------------------------------------------------
def test_msgpack_reader_matches_flax():
    rng = np.random.default_rng(6)
    tree = {"a": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                  "bias": np.arange(5, dtype=np.int32)},
            "bf16": jnp.asarray(rng.normal(size=(2, 3)), jnp.bfloat16),
            "scalar": np.float32(2.5), "big": rng.normal(size=(40,)).astype(np.float64),
            "nested": {"deeper": {"x": np.zeros((0, 2), np.float32)}}}
    data = flax.serialization.msgpack_serialize(tree)
    want = flax.serialization.msgpack_restore(data)
    got = policy.msgpack_restore(data)
    flat_got, flat_want = dict(_flatten(got)), dict(_flatten(want))
    assert sorted(flat_got) == sorted(flat_want)
    for key, value in flat_want.items():
        np.testing.assert_array_equal(flat_got[key], np.asarray(value, np.float64 if key == "big"
                                                                else None).astype(
            flat_got[key].dtype))


def test_safetensors_reader_matches_the_library(tmp_path):
    tensors = {"f32": torch.randn(3, 5), "bf16": torch.randn(4, 2).to(torch.bfloat16),
               "f16": torch.randn(7).half(), "i64": torch.arange(6).reshape(2, 3),
               "empty": torch.zeros(0, 3)}
    path = tmp_path / "model.safetensors"
    safetensors.torch.save_file(tensors, str(path), metadata={"format": "pt"})
    got = policy.read_safetensors(str(path))
    want = safetensors.torch.load_file(str(path))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    header = json.loads(path.read_bytes()[8:8 + int.from_bytes(path.read_bytes()[:8], "little")])
    assert header["__metadata__"] == {"format": "pt"}
