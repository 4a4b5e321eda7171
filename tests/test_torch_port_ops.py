"""The port's kernel modules (openvivqa_tpu_torch.ops) against the JAX package.

On the CPU every wrapper runs its kernel's plain PyTorch version; these tests
hold each plain version against the JAX function on the same numpy inputs:
against the JAX Pallas kernel in interpret mode, driven as the JAX package's
own tests drive it, and against the JAX XLA path.  Both sides compute in
float32 (tolerance atol 1e-5 / rtol 1e-4), except where a test says why not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openvivqa_tpu.models.modules import bert as jbert
from openvivqa_tpu.models.modules.masks import MASK_VALUE
from openvivqa_tpu.ops import decode_step as jds
from openvivqa_tpu.ops import encoder_layer as jenc
from openvivqa_tpu.ops import fused_attention as jattn
from openvivqa_tpu_torch.ops import _cuda, decode_step, encoder_layer, fused_attention
from openvivqa_tpu_torch.ops.gather import take_rows, take_rows_shared

ATOL, RTOL = 1e-5, 1e-4
HD, HEADS, D_FF = 32, 2, 64
EPS = 1e-12


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.asarray(x).dtype))


def _key_bias(lengths, seq):
    pos = np.arange(seq)[None, :]
    return np.where(pos < np.asarray(lengths)[:, None], 0.0, MASK_VALUE).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _attention_weights(rng):
    """Random sublayer weights as numpy (flax layout: (in, out) matrices)."""
    w = {name: _normal(rng, HD, HD, scale=0.2) for name in ("wq", "wk", "wv", "wo")}
    w.update({name: _normal(rng, HD, scale=0.1) for name in ("bq", "bk", "bv", "bo")})
    w["ln_scale"] = 1.0 + _normal(rng, HD, scale=0.1)
    w["ln_bias"] = _normal(rng, HD, scale=0.1)
    return w


def _port_attention_weights(w):
    return {
        "wqkv": _t(np.concatenate([w["wq"], w["wk"], w["wv"]], axis=1)),
        "bqkv": _t(np.concatenate([w["bq"], w["bk"], w["bv"]])),
        "wo": _t(w["wo"]), "bo": _t(w["bo"]),
        "ln_scale": _t(w["ln_scale"]), "ln_bias": _t(w["ln_bias"]),
    }


def _jax_weights(w):
    return {k: jnp.asarray(v) for k, v in w.items()}


def _flax_attention_variables(w):
    """The same weights as a flax BertSelfAttention parameter tree."""
    return {"params": {
        "Dense_0": {"kernel": w["wq"], "bias": w["bq"]},
        "Dense_1": {"kernel": w["wk"], "bias": w["bk"]},
        "Dense_2": {"kernel": w["wv"], "bias": w["bv"]},
        "Dense_3": {"kernel": w["wo"], "bias": w["bo"]},
        "LayerNorm_0": {"scale": w["ln_scale"], "bias": w["ln_bias"]},
    }}


# -- kernel C -----------------------------------------------------------------
def _ffn_inputs(rows, seed):
    rng = _rng(seed)
    return (
        _normal(rng, rows, HD), _normal(rng, HD, D_FF, scale=0.2), _normal(rng, D_FF, scale=0.1),
        _normal(rng, D_FF, HD, scale=0.2), _normal(rng, HD, scale=0.1),
        1.0 + _normal(rng, HD, scale=0.1), _normal(rng, HD, scale=0.1),
    )


@pytest.mark.parametrize("rows", [5, 48])
def test_ffn_matches_jax_kernel_interpret(rows):
    """The Pallas kernel's GELU uses an A&S 7.1.26 erf whose error is at most
    1.5e-7 (openvivqa_tpu/ops/decode_step.py); the port uses the exact erf.
    That difference stays far inside atol 1e-5."""
    inputs = _ffn_inputs(rows, seed=rows)
    want = jds.fused_ffn_step(*map(jnp.asarray, inputs), interpret=True, eps=EPS)
    got = decode_step.fused_ffn_step(*map(_t, inputs), eps=EPS)
    _close(got, want)


def test_ffn_matches_jax_xla_path():
    rng = _rng(3)
    x = _normal(rng, 2, 7, HD)
    layer = jbert.BertLayer(hidden_size=HD, num_heads=HEADS, intermediate_size=D_FF)
    variables = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = layer.apply(variables, jnp.asarray(x), method=jbert.BertLayer.ffn)
    p = jax.tree.map(np.asarray, variables["params"])
    got = decode_step.fused_ffn_step(
        _t(x.reshape(-1, HD)), _t(p["Dense_0"]["kernel"]), _t(p["Dense_0"]["bias"]),
        _t(p["Dense_1"]["kernel"]), _t(p["Dense_1"]["bias"]),
        _t(p["LayerNorm_0"]["scale"]), _t(p["LayerNorm_0"]["bias"]), eps=EPS,
    )
    _close(got.reshape(x.shape), want)


# -- kernel F -----------------------------------------------------------------
@pytest.mark.parametrize("bs,seq,lengths", [(3, 12, [12, 5, 1]), (2, 9, [9, 4])])
def test_encoder_attention_matches_jax_kernel_interpret(bs, seq, lengths):
    rng = _rng(seq)
    w = _attention_weights(rng)
    x = _normal(rng, bs, seq, HD)
    kb = _key_bias(lengths, seq)
    scale = 1.0 / np.sqrt(HD // HEADS)
    want = jenc.fused_encoder_self_attention(
        jnp.asarray(x), _jax_weights(w), jnp.asarray(kb), scale, HEADS, EPS, interpret=True
    )
    got = encoder_layer.fused_encoder_self_attention(
        _t(x), _port_attention_weights(w), _t(kb), scale, HEADS, EPS
    )
    _close(got, want)


@pytest.mark.parametrize("lengths", [[10, 0, 4], [0, 0, 10]])
def test_encoder_attention_zero_length_sample_matches_jax_xla_path(lengths):
    """A sample whose keys are all masked attends uniformly over its own keys,
    as the XLA path does (the Pallas kernel lets it see other samples)."""
    rng = _rng(7)
    w = _attention_weights(rng)
    x = _normal(rng, 3, 10, HD)
    kb = _key_bias(lengths, 10)
    module = jbert.BertSelfAttention(hidden_size=HD, num_heads=HEADS, dropout=0.0)
    want = module.apply(
        _flax_attention_variables(_jax_weights(w)), jnp.asarray(x),
        attention_bias=jnp.asarray(kb)[:, None, None, :], train=False,
    )
    got = encoder_layer.fused_encoder_self_attention(
        _t(x), _port_attention_weights(w), _t(kb), 1.0 / np.sqrt(HD // HEADS), HEADS, EPS
    )
    _close(got, want)


# -- kernel D -----------------------------------------------------------------
def _decode_inputs(seed, bs=3, ctx_len=13, n_slots=4):
    rng = _rng(seed)
    w = _attention_weights(rng)
    ctx_k, ctx_v = _normal(rng, bs, ctx_len, HD), _normal(rng, bs, ctx_len, HD)
    ctx_bias = _key_bias([ctx_len, 6, 1][:bs], ctx_len)
    xs = [_normal(rng, bs, HD) for _ in range(n_slots + 2)]
    return w, ctx_k, ctx_v, ctx_bias, xs


def test_bert_self_step_matches_jax_kernel_interpret():
    """A 13-row context is no multiple of the JAX kernel's 8-row chunk, and the
    last two steps run past the last slot (both sides then overwrite it)."""
    w, ctx_k, ctx_v, ctx_bias, xs = _decode_inputs(seed=1)
    bs, ctx_len, n_slots, chunk = 3, 13, 4, 8
    scale = 1.0 / np.sqrt(HD // HEADS)
    pad = -ctx_len % chunk
    jctx = tuple(jnp.asarray(np.pad(c, ((0, 0), (0, pad), (0, 0)))) for c in (ctx_k, ctx_v))
    jbias = np.pad(ctx_bias, ((0, 0), (0, pad)), constant_values=MASK_VALUE)
    jbias = jnp.asarray(jbias.reshape(bs, -1, chunk).transpose(1, 0, 2))
    j_slots = [jnp.zeros((bs, n_slots, HD), jnp.float32) for _ in range(2)]
    p_slots = [torch.zeros((bs, n_slots, HD)) for _ in range(2)]
    pw = _port_attention_weights(w)
    for step, x in enumerate(xs):
        want, *j_slots = jds.fused_bert_self_step(
            jnp.asarray(x), _jax_weights(w), jctx, *j_slots, jnp.asarray(step), jbias,
            scale, HEADS, EPS, interpret=True,
        )
        got, *p_slots = decode_step.fused_bert_self_step(
            _t(x), pw, (_t(ctx_k), _t(ctx_v)), *p_slots, step, _t(ctx_bias),
            scale, HEADS, EPS,
        )
        _close(got, want)
        for g, j in zip(p_slots, j_slots):
            _close(g, j)


def test_bert_self_step_matches_jax_xla_path():
    """Against BertSelfAttention.decode_step over joint [context | slot] caches
    with the new token's K/V written at ctx_len + step, the JAX package's
    XLA decode route."""
    w, ctx_k, ctx_v, ctx_bias, xs = _decode_inputs(seed=2)
    bs, ctx_len, n_slots = 3, 13, 4
    module = jbert.BertSelfAttention(hidden_size=HD, num_heads=HEADS, dropout=0.0)
    variables = _flax_attention_variables(_jax_weights(w))
    zeros = np.zeros((bs, n_slots, HD), np.float32)
    joint_k = jnp.asarray(np.concatenate([ctx_k, zeros], axis=1))
    joint_v = jnp.asarray(np.concatenate([ctx_v, zeros], axis=1))
    bias_base = np.concatenate([ctx_bias, np.zeros((bs, n_slots), np.float32)], axis=1)
    p_slots = [torch.zeros((bs, n_slots, HD)) for _ in range(2)]
    pw = _port_attention_weights(w)
    for step, x in enumerate(xs[:n_slots]):
        hidden = jnp.asarray(x)[:, None, :]
        k_new, v_new = module.apply(variables, hidden, method=jbert.BertSelfAttention.project_kv)
        joint_k = joint_k.at[:, ctx_len + step].set(k_new[:, 0])
        joint_v = joint_v.at[:, ctx_len + step].set(v_new[:, 0])
        pos = np.arange(ctx_len + n_slots)
        bias = np.where(pos[None] <= ctx_len + step, bias_base, MASK_VALUE)[:, None, None, :]
        want = module.apply(
            variables, hidden, joint_k, joint_v, jnp.asarray(bias),
            method=jbert.BertSelfAttention.decode_step,
        )[:, 0]
        got, *p_slots = decode_step.fused_bert_self_step(
            _t(x), pw, (_t(ctx_k), _t(ctx_v)), *p_slots, step, _t(ctx_bias),
            1.0 / np.sqrt(HD // HEADS), HEADS, EPS,
        )
        _close(got, want)
    _close(p_slots[0], joint_k[:, ctx_len:])
    _close(p_slots[1], joint_v[:, ctx_len:])


# -- packed attention -------------------------------------------------------------
def _packed_inputs(seed, b=2, sq=11, sk=11, bias_shape=None):
    rng = _rng(seed)
    # bf16-representable inputs: the kernel's operand rounding is then exact
    # and both sides see the same operands
    q, k, v = (
        torch.from_numpy(_normal(rng, b, s, HD)).to(torch.bfloat16).float().numpy()
        for s in (sq, sk, sk)
    )
    bias = None
    if bias_shape is not None:
        bias = np.where(rng.random(bias_shape) < 0.25, MASK_VALUE, 0.0).astype(np.float32)
    return q, k, v, bias


_BIASES = {
    "batch-shared full": (1, 1, 11, 11),
    "per-sample full": (2, 1, 11, 11),
    "key-only": (2, 1, 1, 11),
}


@pytest.mark.parametrize("bias_kind", list(_BIASES))
def test_packed_attention_matches_jax_kernel_interpret(bias_kind):
    """The Pallas kernel rounds its dot operands and softmax weights to bf16
    even in interpret mode, so the plain version runs with op_dtype bf16 here;
    the inputs are bf16-representable so both sides round the same values."""
    q, k, v, bias = _packed_inputs(seed=4, bias_shape=_BIASES[bias_kind])
    scale = 1.0 / np.sqrt(HD // HEADS)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.fused_attention_packed(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), scale, HEADS
        )
    got = fused_attention.fused_attention_packed_plain(
        _t(q), _t(k), _t(v), _t(bias), scale, HEADS, op_dtype=torch.bfloat16
    )
    _close(got, want)


@pytest.mark.parametrize("bias_kind", list(_BIASES) + ["none"])
def test_packed_attention_matches_jax_xla_path(bias_kind):
    q, k, v, bias = _packed_inputs(seed=5, bias_shape=_BIASES.get(bias_kind))
    want = jbert._xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), HEADS, HD,
    )
    got = fused_attention.fused_attention_packed(
        _t(q), _t(k), _t(v), None if bias is None else _t(bias), 1.0 / np.sqrt(HD // HEADS),
        HEADS,
    )
    _close(got, want)


def test_packed_attention_rejects_unbroadcastable_bias():
    q, k, v, _ = _packed_inputs(seed=6)
    with pytest.raises(ValueError):
        fused_attention.fused_attention_packed(
            _t(q), _t(k), _t(v), torch.zeros(2, 2, 11, 11), 0.25, HEADS
        )


# -- gather and the device rule --------------------------------------------------------
def test_gather_out_of_range_ids_give_zero_rows():
    from openvivqa_tpu.ops import gather as jgather

    rng = _rng(8)
    table, shared = _normal(rng, 2, 5, 3), _normal(rng, 6, 3)
    ids = np.array([[0, 4, 5, -1], [7, 2, -3, 1]], np.int32)
    _close(take_rows(_t(table), _t(ids)), jgather.take_rows(jnp.asarray(table), jnp.asarray(ids)))
    _close(
        take_rows_shared(_t(shared), _t(ids)),
        jgather.take_rows_shared(jnp.asarray(shared), jnp.asarray(ids)),
    )


def test_device_rule_rejects_tensors_off_cpu_and_cuda():
    cpu = torch.zeros(4, HD)
    meta = torch.zeros(4, HD, device="meta")
    assert _cuda.uses_kernel(cpu) is False
    with pytest.raises(ValueError):
        _cuda.uses_kernel(cpu, meta)
    with pytest.raises(ValueError):
        decode_step.fused_ffn_step(meta, *(torch.zeros(1, device="meta"),) * 6)


def test_kernel_dtype_is_bf16_only_on_the_card():
    assert _cuda.kernel_dtype(torch.device("cpu")) == torch.float32
    assert _cuda.kernel_dtype(torch.device("cuda")) == torch.bfloat16


@pytest.mark.parametrize("keys,hd,heads,ok", [
    (215, 768, 8, True), (1, 32, 2, True), (0, 768, 8, False),
    (10, 40, 2, False), (10, 768, 2, False), (10, 770, 8, False),
])
def test_attention_shape_rule(keys, hd, heads, ok):
    """The attention block takes >= 1 key and a head dim that is a multiple of
    16 up to 128; anything else is a ValueError before any launch."""
    if ok:
        _cuda.require_attention_shape(keys, hd, heads, "test")
    else:
        with pytest.raises(ValueError, match="head dim"):
            _cuda.require_attention_shape(keys, hd, heads, "test")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda._nvcc()
