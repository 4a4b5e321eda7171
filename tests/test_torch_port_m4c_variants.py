"""The port's MMF_M4C variants (openvivqa_tpu_torch.models.mmf_variants) and
kernel E against the JAX package.

Kernel E's plain version is held against the Pallas kernel in interpret mode
with OPENVIVQA_DECODE_CHUNK=8, so that the JAX kernel streams several chunks and
a padded tail that the port does not have (atol 1e-5: float32 sums in another
order).  Then, for MMF_REGIONAL_M4C, MMF_SAL, MMF_LanguageAdaptiveM4C,
MMF_IterativeM4C and MMF_Iterative_Multilevel_M4C at hidden 32 with 4 heads and
1 to 2 layers, the flax model is initialised, bridged into the port with
params_from_flax, and both run on one numpy batch: teacher-forced scores (atol
1e-4), the quadratic and the incremental greedy (identical ids; torch.argmax and
jnp.argmax both take the first maximum), and the port's incremental greedy
against its quadratic one.  On the CPU the port runs each kernel's plain
version (A, E and C per decoder step of the Iterative family) and the JAX
package its XLA paths, both in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvivqa_tpu.builders import META_ARCHITECTURE as JAX_ARCHITECTURE
from openvivqa_tpu.builders import populate as populate_jax
from openvivqa_tpu.config import ConfigNode
from openvivqa_tpu.models.modules import bert as jbert
from openvivqa_tpu.models.modules import torch_conversion
from openvivqa_tpu.ops import decode_step as jds
from openvivqa_tpu_torch.builders import META_ARCHITECTURE, populate
from openvivqa_tpu_torch.models import convert
from openvivqa_tpu_torch.models.modules.bert import BertEncoderStack, BertLayer
from openvivqa_tpu_torch.models.modules.masks import MASK_VALUE
from openvivqa_tpu_torch.ops import decode_step, encoder_layer

populate_jax()
populate()

H, HEADS, VOCAB, MAXA = 32, 4, 25, 6
N_OBJ, N_OCR, N_GRID, QLEN = 4, 3, 5, 5
SCORE_ATOL = 1e-4
EPS = 1e-12


class Vocab:
    padding_idx, bos_idx, eos_idx, unk_idx = 0, 1, 2, 3
    max_answer_length = MAXA

    def __len__(self):
        return VOCAB


_BASE = {
    "D_MODEL": H,
    "MMT": {"HIDDEN_SIZE": H, "NUM_HIDDEN_LAYERS": 2, "NUM_ATTENTION_HEADS": HEADS},
    "TEXT_BERT": {"HIDDEN_SIZE": H, "NUM_HIDDEN_LAYERS": 1},
    "OBJECT_EMBEDDING": {"D_FEATURE": 12, "DROPOUT": 0.0},
    "OCR_EMBEDDING": {"D_FEATURE": 314, "DROPOUT": 0.0},
    "OCR_PTR_NET": {"HIDDEN_SIZE": H, "QUERY_KEY_SIZE": 16},
}
_ITERATIVE = {"ENCODER": {"LAYERS": 2, "HEAD": HEADS}, "DECODER": {"LAYERS": 2, "HEAD": HEADS}}
ARCHS = {
    "MMF_REGIONAL_M4C": {"REGION_EMBEDDING": {"D_FEATURE": 12, "DROPOUT": 0.0}},
    "MMF_SAL": {},
    "MMF_LanguageAdaptiveM4C": {"TEXT_BERT": {
        "HIDDEN_SIZE": H, "NUM_HIDDEN_LAYERS": 1, "D_LANGUAGE": 48, "PRETRAINED_LAYERS": 1,
        "PRETRAINED_HEADS": 2, "PRETRAINED_VOCAB_SIZE": VOCAB + 7}},
    "MMF_IterativeM4C": _ITERATIVE,
    "MMF_Iterative_Multilevel_M4C": _ITERATIVE,
}
ITERATIVE = ("MMF_IterativeM4C", "MMF_Iterative_Multilevel_M4C")
# the JAX converters from the reference's torch layout, the bridge's inverses
CONVERTERS = {
    "MMF_REGIONAL_M4C": torch_conversion.convert_mmf_regional_m4c,
    "MMF_LanguageAdaptiveM4C": torch_conversion.convert_mmf_language_adaptive,
    "MMF_IterativeM4C": torch_conversion.convert_mmf_iterative_m4c,
    "MMF_Iterative_Multilevel_M4C": torch_conversion.convert_mmf_iterative_m4c,
}


def _config(arch, **extra):
    return ConfigNode({**_BASE, **ARCHS[arch], "ARCHITECTURE": arch, **extra})


def _numpy_batch(bs=3, seed=13):
    rng = np.random.default_rng(seed)

    def feats(*shape):
        return rng.normal(size=shape).astype(np.float32)

    q = rng.integers(4, VOCAB, (bs, QLEN)).astype(np.int32)
    q[:, -1] = 0
    batch = {
        "question_tokens": q,
        "region_features": feats(bs, N_OBJ, 12),
        "region_boxes": feats(bs, N_OBJ, 4),
        "grid_features": feats(bs, N_GRID, 12),
        "grid_boxes": feats(bs, N_GRID, 4),
        "ocr_fasttext_features": feats(bs, N_OCR, 300),  # the FastText width MMF_SAL takes
        "ocr_rec_features": feats(bs, N_OCR, 8),
        "ocr_det_features": feats(bs, N_OCR, 6),
        "ocr_boxes": feats(bs, N_OCR, 4),
        "answer_tokens": rng.integers(4, VOCAB + N_OCR, (bs, MAXA)).astype(np.int32),
    }
    batch["shifted_right_answer_tokens"] = np.concatenate(
        [batch["answer_tokens"][:, 1:], np.zeros((bs, 1), np.int32)], axis=1)
    # padded rows exercise the object, grid and OCR padding biases
    batch["region_features"][0, -1] = 0.0
    batch["grid_features"][2, -2:] = 0.0
    for key in ("ocr_fasttext_features", "ocr_rec_features", "ocr_det_features"):
        batch[key][1, -1] = 0.0
    return batch


BATCH = _numpy_batch()
_CACHE = {}


def _jax_model(arch, **extra):
    return JAX_ARCHITECTURE.get(arch)(_config(arch, **extra), Vocab())


def _jax(arch):
    """The flax parameters of `arch` and the JAX package's outputs, once."""
    if arch not in _CACHE:
        jax_batch = {k: jnp.asarray(v) for k, v in BATCH.items()}
        init_model = _jax_model(arch)
        variables = jax.jit(
            lambda r, b: init_model.init({"params": r, "dropout": r}, b, train=False)
        )(jax.random.PRNGKey(3), jax_batch)
        params = jax.tree.map(np.asarray, variables["params"])
        out = {"params": params}
        out["teacher_forced"] = np.asarray(
            init_model.apply({"params": params}, jax_batch, train=False)["scores"])
        for mode, extra in (("quadratic", {}), ("incremental", {"DECODING_MODE": "incremental"})):
            got = _jax_model(arch, **extra).apply(
                {"params": params}, jax_batch, method="greedy_decode")
            out[mode] = {k: np.asarray(v) for k, v in got.items()}
        _CACHE[arch] = out
    return _CACHE[arch]


def _port_model(arch, params, **extra):
    model = META_ARCHITECTURE.get(arch)(_config(arch, **extra), Vocab())
    state = convert.params_from_flax(params)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.eval()


def _torch_batch():
    return {k: torch.from_numpy(v.copy()) for k, v in BATCH.items()}


def _close(got, want, atol=SCORE_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _prefixed(state, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in state.items() if k.startswith(prefix)}


# -- kernel E ------------------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_streamed_cross_attention_plain_matches_jax_interpret(monkeypatch, kv_dtype):
    """21 encoder keys: three chunks of 8 in the JAX kernel, the last padded
    with 3 MASK_VALUE keys of zeros; the port takes the 21 keys as they are.
    Some keys of every row are masked (a row with every key masked would
    average the pad rows on the JAX side)."""
    monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL", "interpret")
    monkeypatch.setenv("OPENVIVQA_DECODE_CHUNK", "8")
    rng = np.random.default_rng(31)
    rows, sk, hd, heads = 5, 21, H, HEADS
    scale = 1.0 / np.sqrt(hd // heads)
    x = rng.normal(size=(rows, hd)).astype(np.float32)
    w = {
        "wq": (rng.normal(size=(hd, hd)) * 0.2).astype(np.float32),
        "bq": (rng.normal(size=hd) * 0.1).astype(np.float32),
        "wo": (rng.normal(size=(hd, hd)) * 0.2).astype(np.float32),
        "bo": (rng.normal(size=hd) * 0.1).astype(np.float32),
        "ln_scale": (1 + rng.normal(size=hd) * 0.1).astype(np.float32),
        "ln_bias": (rng.normal(size=hd) * 0.1).astype(np.float32),
    }
    k, v = (rng.normal(size=(rows, sk, hd)).astype(np.float32) for _ in range(2))
    if kv_dtype == "bfloat16":  # values bf16 holds, stored as bf16 on both sides
        k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (k, v))
    lengths = np.array([21, 20, 9, 1, 14])
    bias = np.where(np.arange(sk)[None] < lengths[:, None], 0.0, MASK_VALUE).astype(np.float32)
    bias[0, 3] = MASK_VALUE  # a masked key inside a chunk

    plan = jds.cross_step_plan(rows, sk, hd)
    assert plan is not None and plan[1] == 8
    nj, chunk = -(-sk // 8), 8
    pad = nj * chunk - sk
    jdtype = jnp.bfloat16 if kv_dtype == "bfloat16" else jnp.float32

    def padded(a):
        return jnp.asarray(np.concatenate([a, np.zeros((rows, pad, hd), np.float32)], 1), jdtype)

    jbias = np.concatenate([bias, np.full((rows, pad), MASK_VALUE, np.float32)], 1)
    jbias = jnp.asarray(jbias.reshape(rows, nj, chunk).transpose(1, 0, 2))
    want = jds.fused_cross_attention_streamed(
        jnp.asarray(x), {n: jnp.asarray(a) for n, a in w.items()}, (padded(k), padded(v)), jbias,
        scale, heads, EPS, interpret=True,
    )
    tdtype = getattr(torch, kv_dtype)
    got = decode_step.fused_cross_attention_streamed(
        torch.from_numpy(x), {n: torch.from_numpy(a) for n, a in w.items()},
        (torch.from_numpy(k).to(tdtype), torch.from_numpy(v).to(tdtype)),
        torch.from_numpy(bias), scale, heads, EPS,
    )
    _close(got, want, atol=1e-5)


# -- the modules ----------------------------------------------------------------------------
@pytest.fixture
def kernel_f_calls(monkeypatch):
    """The hidden states kernel F's route is called on."""
    calls = []
    original = encoder_layer.fused_encoder_self_attention

    def recording(hidden, *args, **kwargs):
        calls.append(tuple(hidden.shape))
        return original(hidden, *args, **kwargs)

    monkeypatch.setattr(encoder_layer, "fused_encoder_self_attention", recording)
    return calls


@pytest.mark.parametrize("self_bias", ["causal", "key-only"])
def test_cross_attention_layer_matches_jax_and_never_takes_kernel_f(kernel_f_calls, self_bias):
    """A cross-attention BertLayer against the JAX one.  Its cross-attention
    has a key-only encoder bias, which kernel F (self-attention only) would
    take for its own rows: only the self-attention may go there, and only
    under a key-only bias."""
    rng = np.random.default_rng(23)
    x = rng.normal(size=(2, 5, H)).astype(np.float32)
    enc = rng.normal(size=(2, 9, H)).astype(np.float32)
    enc_bias = np.where(np.arange(9)[None] < np.array([[9], [4]]), 0.0, MASK_VALUE)
    enc_bias = enc_bias[:, None, None, :].astype(np.float32)
    if self_bias == "causal":
        bias = np.triu(np.full((5, 5), MASK_VALUE, np.float32), 1)[None, None]
    else:
        bias = np.where(np.arange(5)[None] < np.array([[5], [3]]), 0.0, MASK_VALUE)
        bias = bias[:, None, None, :].astype(np.float32)
    layer = jbert.BertLayer(hidden_size=H, num_heads=HEADS, cross_attention=True)
    args = (jnp.asarray(x), jnp.asarray(bias), jnp.asarray(enc), jnp.asarray(enc_bias))
    variables = layer.init(jax.random.PRNGKey(5), *args)
    want = layer.apply(variables, *args)

    state = {}
    convert._bert_layer(state, "l", jax.tree.map(np.asarray, variables["params"]))
    port = BertLayer(H, HEADS, cross_attention=True)
    port.load_state_dict(_prefixed(state, "l."))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(bias), encoder_states=torch.from_numpy(enc),
                   encoder_bias=torch.from_numpy(enc_bias))
    _close(got, want, atol=1e-5)
    assert kernel_f_calls == ([] if self_bias == "causal" else [(2, 5, H)])


def test_encoder_stack_return_all_matches_jax():
    rng = np.random.default_rng(24)
    x = rng.normal(size=(3, 7, H)).astype(np.float32)
    bias = np.where(np.arange(7)[None] < np.array([[7], [3], [1]]), 0.0, MASK_VALUE)
    bias = bias[:, None, None, :].astype(np.float32)
    stack = jbert.BertEncoderStack(hidden_size=H, num_layers=2, num_heads=HEADS)
    variables = stack.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want, want_all = stack.apply(variables, jnp.asarray(x), attention_bias=jnp.asarray(bias),
                                 return_all=True)
    state = {}
    convert._bert_encoder(state, "s", jax.tree.map(np.asarray, variables["params"]))
    port = BertEncoderStack(H, 2, HEADS)
    port.load_state_dict(_prefixed(state, "s."))
    with torch.no_grad():
        got, got_all = port(torch.from_numpy(x), torch.from_numpy(bias), return_all=True)
    _close(got, want, atol=1e-5)
    assert len(got_all) == len(want_all) == 2
    for g, w in zip(got_all, want_all):
        _close(g, w, atol=1e-5)
    with pytest.raises(ValueError, match="exclusive"):
        port(torch.from_numpy(x), return_all=True, return_layer_inputs=True)


# -- the five architectures ---------------------------------------------------------------
@pytest.mark.parametrize("arch", list(ARCHS))
def test_teacher_forced_scores_match_jax(arch):
    want = _jax(arch)
    got = _port_model(arch, want["params"])(_torch_batch())
    _close(got["scores"], want["teacher_forced"])


@pytest.mark.parametrize("mode", ["quadratic", "incremental"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_greedy_decode_matches_jax(arch, mode):
    want = _jax(arch)
    extra = {"DECODING_MODE": "incremental"} if mode == "incremental" else {}
    got = _port_model(arch, want["params"], **extra).greedy_decode(_torch_batch())
    np.testing.assert_array_equal(got["prev_inds"].numpy(), want[mode]["prev_inds"])
    np.testing.assert_array_equal(got["scores"].argmax(-1).numpy(),
                                  want[mode]["scores"].argmax(-1))
    _close(got["scores"], want[mode]["scores"])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_incremental_equals_quadratic(arch):
    """The KV-cached decode gives the quadratic greedy's ids and scores: the
    Iterative family's joint encoder never sees the decoder; the MMT variants
    need the context-blind mask on the quadratic side."""
    params = _jax(arch)["params"]
    blind = {} if arch in ITERATIVE else {"CONTEXT_BLIND": True}
    quadratic = _port_model(arch, params, **blind).greedy_decode(_torch_batch())
    incremental = _port_model(arch, params, DECODING_MODE="incremental").greedy_decode(
        _torch_batch())
    np.testing.assert_array_equal(incremental["prev_inds"].numpy(), quadratic["prev_inds"].numpy())
    _close(incremental["scores"], quadratic["scores"], atol=2e-5)


@pytest.mark.parametrize("arch", ITERATIVE)
def test_iterative_plain_decode_route_equals_kernel_route(arch, monkeypatch):
    """OPENVIVQA_DECODE_KERNEL_PARTS without 'layer' leaves the decoder steps
    to the modules' plain route (float32 caches, the packed attention); it
    decodes as kernels A, E and C do."""
    params = _jax(arch)["params"]
    model = _port_model(arch, params, DECODING_MODE="incremental")
    fused = model.greedy_decode(_torch_batch())
    calls = []
    original = decode_step.fused_cross_attention_streamed
    monkeypatch.setattr(decode_step, "fused_cross_attention_streamed",
                        lambda *a, **k: calls.append(1) or original(*a, **k))
    monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL_PARTS", "none")
    plain = model.greedy_decode(_torch_batch())
    assert not calls
    np.testing.assert_array_equal(plain["prev_inds"].numpy(), fused["prev_inds"].numpy())
    _close(plain["scores"], fused["scores"], atol=2e-5)


@pytest.mark.parametrize("arch", list(CONVERTERS))
def test_weight_bridge_round_trip(arch):
    """The JAX package's converter from the reference's torch layout is the
    bridge's inverse: the port's state_dict gives back the flax tree."""
    params = _jax(arch)["params"]
    model = _port_model(arch, params)
    back = CONVERTERS[arch](model.state_dict(), _config(arch))
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), leaf)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_bridge_covers_every_port_parameter(arch):
    state = convert.params_from_flax(_jax(arch)["params"])
    model = META_ARCHITECTURE.get(arch)(_config(arch), Vocab())
    assert set(state) == set(model.state_dict())
    for name, tensor in model.state_dict().items():
        assert tuple(tensor.shape) == state[name].shape, name
    if arch in ITERATIVE:
        assert not hasattr(model, "mmt") and not hasattr(model, "text_bert_out_linear")


def _gradient_free(name: str) -> bool:
    # softmax(q . (k + b)) does not depend on the key projection's bias b
    return name.endswith("self.key.bias")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_one_gradient_step(arch):
    """One training step (dropout 0.1 in the BERT modules, drawn from a
    generator): finite gradients on every trainable parameter, non-zero except
    the key-projection biases; the frozen LanguageAdaptive backbone gets none
    and an Adam step leaves it as it was, while every trainable tensor moves."""
    model = _port_model(arch, _jax(arch)["params"]).train()
    batch = _torch_batch()
    generator = torch.Generator().manual_seed(7)
    scores = model(batch, generator=generator)["scores"]
    logprobs = torch.log_softmax(scores, dim=-1)
    loss = torch.nn.functional.nll_loss(
        logprobs.reshape(-1, logprobs.shape[-1]), batch["shifted_right_answer_tokens"].long()
        .reshape(-1), ignore_index=0)
    loss.backward()
    assert torch.isfinite(loss)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert bool(frozen) == (arch == "MMF_LanguageAdaptiveM4C")
    assert all(n.startswith("text_bert.embedding.") for n in frozen)
    for name, p in model.named_parameters():
        if name in frozen:
            assert p.grad is None or not bool(p.grad.any()), name
            continue
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        assert _gradient_free(name) or float(p.grad.abs().max()) > 0.0, name
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.optim.Adam(model.parameters(), lr=1e-3).step()
    for name, p in model.named_parameters():
        if not _gradient_free(name):  # Adam turns a bias's rounding noise into steps
            assert torch.equal(p.detach(), before[name]) == (name in frozen), name
