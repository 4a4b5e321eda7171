"""The port's decode-step kernels' plain versions and its beam search on the CPU
against the JAX package, on inputs made from a numpy seed.

Kernels A (stateful self-attention step), B (cross-attention step) and the
decoder-layer step are compared with the Pallas kernels in interpret mode on
float32 operands, as ``tests/test_decode_kernel.py`` runs them: both sides then
compute the same float32 function and differ in summation order only, hence
atol 1e-5 on LayerNorm outputs and on the returned caches.  With a bf16 ring
both sides round the stored key and value from float32 sums that may differ in
their last bits, so a stored value may land one bf16 ulp apart (7.8e-3 at
magnitudes in [1, 2)): atol 1e-2 there.

``beam_search`` is compared with ``openvivqa_tpu.training.decode.beam_search`` on
one scripted step function: a numpy table of log-probs indexed by the step, the
token before the previous one (carried in the cache, so a wrong cache reorder
changes the result) and the previous token.  Both sides read the same float32
values, so tokens are identical and log-probs agree to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvivqa_tpu.ops import decode_step as jds
from openvivqa_tpu.training import decode as jdecode
from openvivqa_tpu_torch.ops import decode_step as ds
from openvivqa_tpu_torch.training import decode

MASK = -10e4
HD, HEADS, D_FF = 64, 4, 96
SCALE = 1.0 / np.sqrt(HD // HEADS)


def _t(x):
    return torch.from_numpy(np.array(x))


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _self_weights(rng):
    w = {name: _normal(rng, HD, HD, scale=0.1) for name in ("wq", "wk", "wv", "wo")}
    w.update({name: _normal(rng, HD, scale=0.1) for name in ("bq", "bk", "bv", "bo", "ln_bias")})
    w["ln_scale"] = 1 + _normal(rng, HD, scale=0.1)
    return w


def _port_self(w):
    """The JAX kernels' separate q, k, v projections packed as the port reads them."""
    return {
        "wqkv": _t(np.concatenate([w["wq"], w["wk"], w["wv"]], axis=1)),
        "bqkv": _t(np.concatenate([w["bq"], w["bk"], w["bv"]])),
        **{name: _t(w[name]) for name in ("wo", "bo", "ln_scale", "ln_bias")},
    }


def _port_cross(w):
    return {name: _t(w[name]) for name in ("wq", "bq", "wo", "bo", "ln_scale", "ln_bias")}


def _ffn_weights(rng):
    return {
        "w1": _normal(rng, HD, D_FF, scale=0.1), "b1": _normal(rng, D_FF, scale=0.1),
        "w2": _normal(rng, D_FF, HD, scale=0.1), "b2": _normal(rng, HD, scale=0.1),
        "ln_scale": 1 + _normal(rng, HD, scale=0.1), "ln_bias": _normal(rng, HD, scale=0.1),
    }


def _ring(rng, rows, max_len):
    """A ring as earlier steps and a beam reorder left it: arbitrary finite
    keys and values, some earlier tokens padded."""
    bias = np.where(rng.random((rows, max_len)) < 0.2, MASK, 0.0).astype(np.float32)
    bias[:, 0] = 0.0  # <bos> is never padding
    return _normal(rng, rows, max_len, HD), _normal(rng, rows, max_len, HD), bias


def _step_bias(rng, rows):
    return np.where(rng.random(rows) < 0.3, MASK, 0.0).astype(np.float32)


STEP_CASES = {
    "8 rows, t=2": (8, 6, 2),
    "63 rows, last slot": (63, 5, 4),
    "63 rows, t past the end clamps": (63, 5, 7),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_self_attention_step_plain_matches_pallas_interpret(case):
    rows, max_len, t = STEP_CASES[case]
    rng = np.random.default_rng(rows + t)
    w, x, sb = _self_weights(rng), _normal(rng, rows, HD), _step_bias(rng, rows)
    ck, cv, cb = _ring(rng, rows, max_len)
    want = jds.fused_self_attention_step(
        jnp.asarray(x), *(jnp.asarray(w[n]) for n in (
            "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "ln_scale", "ln_bias")),
        jnp.asarray(sb), jnp.asarray(t, jnp.int32), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(cb), SCALE, HEADS, interpret=True,
    )
    ring = [_t(ck), _t(cv), _t(cb)]
    got = ds.fused_self_attention_step(_t(x), _port_self(w), _t(sb), t, *ring, SCALE, HEADS)
    assert all(a is b for a, b in zip(got[1:], ring))  # the ring is written in place
    for name, g, e in zip(("y", "cache_k", "cache_v", "cache_bias"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-5, rtol=0, err_msg=name)
    slot = min(t, max_len - 1)
    np.testing.assert_array_equal(got[3][:, slot].numpy(), sb)


def test_self_attention_step_plain_bf16_ring_and_eps():
    """A bf16 ring (stores round, the attention reads what the ring holds) and
    the BertLayer family's eps of 1e-12."""
    rows, max_len, t = 8, 6, 3
    rng = np.random.default_rng(5)
    w, x, sb = _self_weights(rng), _normal(rng, rows, HD), _step_bias(rng, rows)
    ck, cv, cb = _ring(rng, rows, max_len)
    ck16, cv16 = (jnp.asarray(a).astype(jnp.bfloat16) for a in (ck, cv))
    want = jds.fused_self_attention_step(
        jnp.asarray(x), *(jnp.asarray(w[n]) for n in (
            "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "ln_scale", "ln_bias")),
        jnp.asarray(sb), jnp.asarray(t, jnp.int32), ck16, cv16, jnp.asarray(cb), SCALE, HEADS,
        interpret=True, eps=1e-12,
    )
    got = ds.fused_self_attention_step(
        _t(x), _port_self(w), _t(sb), t, _t(ck).to(torch.bfloat16), _t(cv).to(torch.bfloat16),
        _t(cb), SCALE, HEADS, eps=1e-12,
    )
    assert got[1].dtype == torch.bfloat16
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-2, rtol=0)
    for g, e in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(e.astype(jnp.float32)), atol=1e-2, rtol=0)


@pytest.mark.parametrize("rows,sk", [(6, 5), (63, 23)])
def test_cross_attention_step_plain_matches_pallas_interpret(rows, sk):
    rng = np.random.default_rng(rows)
    w = _self_weights(rng)
    x, ek, ev = _normal(rng, rows, HD), _normal(rng, rows, sk, HD), _normal(rng, rows, sk, HD)
    eb = np.where(rng.random((rows, sk)) < 0.3, MASK, 0.0).astype(np.float32)
    want = jds.fused_cross_attention_step(
        jnp.asarray(x), *(jnp.asarray(w[n]) for n in (
            "wq", "bq", "wo", "bo", "ln_scale", "ln_bias")),
        jnp.asarray(ek), jnp.asarray(ev), jnp.asarray(eb), SCALE, HEADS, interpret=True,
    )
    got = ds.fused_cross_attention_step(_t(x), _port_cross(w), _t(ek), _t(ev), _t(eb), SCALE, HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["63 rows, last slot", "63 rows, t past the end clamps"])
def test_decoder_layer_step_plain_matches_pallas_interpret(case):
    """A, then B, then C in one call, float32 operands.  The Pallas FFN stage
    evaluates erf by a rational approximation (max abs error 1.5e-7) where the
    port keeps the exact one; its effect after the LayerNorm stays inside 1e-5."""
    rows, max_len, t = STEP_CASES[case]
    sk = 17
    rng = np.random.default_rng(t)
    self_w, cross_w, ffn_w = _self_weights(rng), _self_weights(rng), _ffn_weights(rng)
    x, sb = _normal(rng, rows, HD), _step_bias(rng, rows)
    ck, cv, cb = _ring(rng, rows, max_len)
    ek, ev = _normal(rng, rows, sk, HD), _normal(rng, rows, sk, HD)
    eb = np.where(rng.random((rows, sk)) < 0.3, MASK, 0.0).astype(np.float32)
    as_jax = lambda w: {k: jnp.asarray(v) for k, v in w.items()}  # noqa: E731
    jax_cross = {k: v for k, v in as_jax(cross_w).items() if k not in ("wk", "bk", "wv", "bv")}
    want = jds.fused_decoder_layer_step(
        jnp.asarray(x), as_jax(self_w), jax_cross, as_jax(ffn_w), jnp.asarray(sb),
        jnp.asarray(t, jnp.int32), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(cb),
        jnp.asarray(ek), jnp.asarray(ev), jnp.asarray(eb), SCALE, HEADS, interpret=True,
    )
    got = ds.fused_decoder_layer_step(
        _t(x), _port_self(self_w), _port_cross(cross_w), {k: _t(v) for k, v in ffn_w.items()},
        _t(sb), t, _t(ck), _t(cv), _t(cb), _t(ek), _t(ev), _t(eb), SCALE, HEADS,
    )
    for name, g, e in zip(("y", "cache_k", "cache_v", "cache_bias"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-5, rtol=0, err_msg=name)


def test_decode_kernel_parts_follows_the_jax_package(monkeypatch):
    for value in ("", "Layer", "self,ffn", "self, cross ,ffn", "none"):
        monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL_PARTS", value)
        assert ds.decode_kernel_parts() == jds.decode_kernel_parts()
    monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL_PARTS", "self cross")
    with pytest.raises(ValueError, match="unknown part"):
        ds.decode_kernel_parts()


def test_wrappers_refuse_tensors_on_mixed_devices():
    rng = np.random.default_rng(0)
    w = _port_cross(_self_weights(rng))
    x, ek = _t(_normal(rng, 4, HD)), _t(_normal(rng, 4, 3, HD))
    with pytest.raises(ValueError, match="all lie on the CPU or all on one CUDA"):
        ds.fused_cross_attention_step(x.to("meta"), w, ek, ek, torch.zeros(4, 3), SCALE, HEADS)


# -- beam search --------------------------------------------------------------------------
BOS, EOS = 1, 2


def _scripted(table):
    """(jax step_fn, torch step_fn, cache maker) over table (T, V, V, V) of
    log-probs indexed [step, token before the previous, previous token]."""
    jtable, ttable = jnp.asarray(table), _t(table)

    def jax_step(cache, tokens):
        prev = tokens[:, 0]
        logp = jtable[cache["step"], cache["before"], prev]
        return logp[:, None, :], {"step": cache["step"] + 1, "before": prev}

    def torch_step(cache, tokens):
        prev = tokens[:, 0]
        logp = ttable[cache["step"], cache["before"], prev]
        return logp[:, None, :], {"step": cache["step"] + 1, "before": prev}

    def caches(rows):
        return ({"step": jnp.zeros((), jnp.int32), "before": jnp.zeros((rows,), jnp.int32)},
                {"step": 0, "before": torch.zeros(rows, dtype=torch.int64)})

    return jax_step, torch_step, caches


def _random_table(seed, max_len, vocab):
    """Random log-softmax rows; <eos> gets a boost so that beams end early."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(max_len, vocab, vocab, vocab)).astype(np.float32)
    logits[..., EOS] += 1.5
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


def _tied_table(max_len, vocab):
    """Every word equally likely at every step: all live candidates of a beam
    tie, and so do the frozen beams' EOS_FREEZE entries."""
    return np.full((max_len, vocab, vocab, vocab), -np.log(vocab), np.float32)


def _run_both(table, bs, beam, max_len, **kwargs):
    jax_step, torch_step, caches = _scripted(table)
    jcache, tcache = caches(bs * beam)
    want = jdecode.beam_search(jax_step, jcache, bs, beam, max_len, BOS, EOS, **kwargs)
    got = decode.beam_search(torch_step, tcache, bs, beam, max_len, BOS, EOS, **kwargs)
    return got, want


@pytest.mark.parametrize("beam", [2, 3])
def test_beam_search_matches_jax_on_a_scripted_step(beam):
    bs, max_len, vocab = 4, 6, 7
    got, want = _run_both(_random_table(beam, max_len, vocab), bs, beam, max_len)
    assert got[0].shape == (bs, max_len) and got[1].shape == (bs, max_len)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
    assert (got[0].numpy() == EOS).any(axis=1).any()  # some answer ends early
    ended = np.cumsum(got[0].numpy() == EOS, axis=1) - (got[0].numpy() == EOS) > 0
    assert np.all(got[1].numpy()[ended] == 0.0)  # recorded log-probs are masked past <eos>


def test_beam_search_out_size_and_return_probs_match_jax():
    bs, beam, max_len, vocab = 3, 3, 5, 7
    got, want = _run_both(_random_table(11, max_len, vocab), bs, beam, max_len,
                          out_size=2, return_probs=True)
    assert got[0].shape == (bs, 2, max_len)
    assert got[1].shape == (bs, 2, max_len)
    assert got[2].shape == (bs, beam, max_len, vocab)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, e in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-6, rtol=0)


@pytest.mark.parametrize("table", ["all words tie", "ties after a random start"])
def test_beam_search_breaks_ties_by_the_lowest_index_like_jax(table):
    """jax.lax.top_k returns the lowest index first among equal candidates and
    jnp.argsort is stable; the port's selection must pick the same ones."""
    bs, beam, max_len, vocab = 3, 3, 6, 5
    tables = {
        "all words tie": _tied_table(max_len, vocab),
        "ties after a random start": np.concatenate(
            [_random_table(3, 2, vocab), _tied_table(max_len - 2, vocab)]),
    }
    got, want = _run_both(tables[table], bs, beam, max_len, out_size=beam)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)


def test_gather_beams_reorders_rows_and_passes_the_rest():
    class Ring:
        def __init__(self):
            self.key = torch.arange(6.0).reshape(6, 1)

    tree = {"pos": 3, "layers": [Ring()], "scalar": torch.tensor(7), "other": torch.zeros(5)}
    selected = torch.tensor([[2, 0, 0], [1, 1, 2]])
    out = decode._gather_beams(tree, selected, 2, 3)
    assert out["layers"][0].key[:, 0].tolist() == [2.0, 0.0, 0.0, 4.0, 4.0, 5.0]
    assert tree["layers"][0].key[:, 0].tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    assert out["pos"] == 3 and out["scalar"] is tree["scalar"] and out["other"] is tree["other"]
