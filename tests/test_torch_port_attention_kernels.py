"""The port's flat and streamed attention (openvivqa_tpu_torch.ops.fused_attention)
against the JAX package, on the CPU.

Each wrapper runs its kernel's plain version here.  The flat attention's plain
version is held against the JAX Pallas kernel in interpret mode (both round
their dot operands and softmax weights to bf16, on bf16-representable inputs),
against the JAX XLA ``attend`` through the port's ``attend`` (float32 on both
sides, d_k != d_v too), and its backward against ``jax.vjp`` of the JAX
function (the analytic XLA backward, bias gradient included).  The streamed
attention's plain version is held against the streamed Pallas kernel in
interpret mode, and the port's copies of the dispatch rules against the JAX
functions.  The choice of device block (``attention_block``) is checked at
every cut-over, and the wrappers' calls of each block's C entry (the dropout
forward and backward entries too) are run through an emulation of that entry's
addressing on CPU memory.  Float32
comparisons: atol 1e-5 / rtol 1e-4 (the frameworks sum in other orders).
"""

import ctypes
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openvivqa_tpu.config import ConfigNode as JaxConfigNode
from openvivqa_tpu.models.modules.attentions import (
    ScaledDotProductAttention as JaxScaledDotProductAttention,
)
from openvivqa_tpu.ops import fused_attention as jattn
from openvivqa_tpu_torch.config import ConfigNode
from openvivqa_tpu_torch.models.modules.attentions import ScaledDotProductAttention
from openvivqa_tpu_torch.ops import fused_attention

ATOL, RTOL = 1e-5, 1e-4
MASK = -10e4
B, H, SQ, SK, D = 2, 3, 5, 7, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _masked(rng, shape, share=0.25):
    bias = np.where(rng.random(shape) < share, MASK, 0.0).astype(np.float32)
    bias[..., 0] = 0.0
    return bias


# the flat kernel's bias forms: constant, per sample (key padding or full),
# per head, and a sample with every key masked
_FLAT_BIASES = {
    "none": None,
    "constant": (1, 1, SQ, SK),
    "per-sample keys": (B, 1, 1, SK),
    "per-sample full": (B, 1, SQ, SK),
    "per-head": (B, H, SQ, SK),
    "fully masked sample": (B, 1, 1, SK),
}


def _flat_inputs(seed, bias_kind, dv=D):
    rng = np.random.default_rng(seed)
    q, k = (_bf16(rng.normal(size=(B, H, s, D)).astype(np.float32)) for s in (SQ, SK))
    v = _bf16(rng.normal(size=(B, H, SK, dv)).astype(np.float32))
    shape = _FLAT_BIASES[bias_kind]
    bias = None if shape is None else _masked(rng, shape)
    if bias_kind == "fully masked sample":
        bias[0] = MASK
    return q, k, v, bias


@pytest.mark.parametrize("bias_kind", list(_FLAT_BIASES))
def test_flat_plain_matches_jax_kernel_interpret(bias_kind):
    """fused_attention_plain at op_dtype bf16 against the Pallas flat kernel in
    interpret mode; a fully masked sample averages its values, finite."""
    q, k, v, bias = _flat_inputs(1, bias_kind)
    scale = 1.0 / np.sqrt(D)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     None if bias is None else jnp.asarray(bias), scale)
    got = fused_attention.fused_attention_plain(
        _t(q), _t(k), _t(v), None if bias is None else _t(bias), scale, op_dtype=torch.bfloat16)
    assert bool(torch.isfinite(got).all())
    _close(got, want)


def _attention_pair(dk, dv, d_model=24):
    """A flax ScaledDotProductAttention, its params, and the port's module
    with those weights."""
    cfg = {"HEAD": H, "D_KEY": dk, "D_VALUE": dv, "D_MODEL": d_model}
    flax_module = JaxScaledDotProductAttention(JaxConfigNode(cfg))
    x = jnp.zeros((1, 2, d_model), jnp.float32)
    params = flax_module.init(jax.random.PRNGKey(dk + dv), x, x, x)["params"]
    port = ScaledDotProductAttention(ConfigNode(cfg))
    with torch.no_grad():
        for name in ("fc_q", "fc_k", "fc_v", "fc_o"):
            getattr(port, name).weight.copy_(_t(params[name]["kernel"]).T)
            getattr(port, name).bias.copy_(_t(params[name]["bias"]))
    return flax_module, params, port


def _merge(x):
    b, h, s, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, s, h * d)


@pytest.mark.parametrize("case", ["per-head, d_k 16 / d_v 8", "2-D key padding",
                                  "fully masked sample"])
def test_attend_matches_jax_xla_attend(case):
    """The port's attend (the flat attention over head-split views of packed
    projections) and out projection against the JAX module's attend, whose
    CPU route is XLA: a per-head bias at d_k != d_v, a (b, Sk) key-padding
    bias, a (b, 1, 1, Sk) bias masking every key of sample 0."""
    rng = np.random.default_rng(2)
    dk, dv = (16, 8) if case.startswith("per-head") else (D, D)
    q = rng.normal(size=(B, H, SQ, dk)).astype(np.float32)
    k = rng.normal(size=(B, H, SK, dk)).astype(np.float32)
    v = rng.normal(size=(B, H, SK, dv)).astype(np.float32)
    if case.startswith("per-head"):
        bias = _masked(rng, (B, H, SQ, SK))
    elif case == "2-D key padding":
        bias = _masked(rng, (B, SK))
    else:
        bias = _masked(rng, (B, 1, 1, SK))
        bias[0] = MASK
    flax_module, params, port = _attention_pair(dk, dv)
    want = flax_module.apply({"params": params}, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(bias), method=lambda m, *a: m.attend(*a))
    with torch.no_grad():
        got = port.fc_o(port.attend(_t(_merge(q)), _t(_merge(k)), _t(_merge(v)), _t(bias)))
    _close(got, want)


@pytest.mark.parametrize("bias_kind", ["none", "constant", "per-sample keys", "per-head"])
def test_flat_backward_matches_jax_vjp(bias_kind):
    """dq, dk, dv and the bias gradient (summed over the bias's broadcast
    axes) of the port's autograd function against jax.vjp of the JAX
    fused_attention, whose backward is the analytic XLA one."""
    q, k, v, bias = _flat_inputs(3, bias_kind)
    g = np.random.default_rng(4).normal(size=(B, H, SQ, D)).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    operands = [jnp.asarray(x) for x in (q, k, v)] + ([] if bias is None else [jnp.asarray(bias)])

    def fn(*args):
        return jattn.fused_attention(*args[:3], args[3] if len(args) > 3 else None, scale)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, *operands)
        want = vjp(jnp.asarray(g))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)] + (
        [] if bias is None else [_t(bias).requires_grad_()])
    out = fused_attention.fused_attention(*leaves[:3], leaves[3] if bias is not None else None,
                                          scale)
    out.backward(_t(g))
    for leaf, expected in zip(leaves, want):
        _close(leaf.grad, expected)


def test_flat_checks_raise_value_error():
    q = torch.zeros(B, H, SQ, D)
    k = torch.zeros(B, H, SK, D)
    bad = [
        ((q[0], k, k, None), "must be"),
        ((q, k[:, :, :, :8], k, None), "are not"),
        ((q, k, k[:, :, :4], None), "are not"),
        ((q, k, k, torch.zeros(B, 2, SQ, SK)), "does not broadcast"),
        ((q, k, k, torch.zeros(B, 1, SK)), "does not broadcast"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            fused_attention.fused_attention(*args, 0.25)


# -- the streamed attention ------------------------------------------------------------
S_HD, S_HEADS = 32, 2


def test_streamed_plain_matches_jax_kernel_interpret():
    """At 16 queries x 128 keys (plan_streamed_blocks: q-blocks of 16, two key
    blocks of 64) with a per-sample padding bias.  The TPU kernel rounds each
    key block's unnormalised weights to bf16 and divides at the end; the
    port's (the packed kernel's arithmetic) rounds the normalised weights.
    Each rounding is within 2^-8 of its weight, so the outputs differ by at
    most 2^-7 * sum_j w_j |v_j| <= 2^-7 max |v|."""
    rng = np.random.default_rng(5)
    b, sq, sk = 2, 16, 128
    assert jattn.plan_streamed_blocks(sq, sk, S_HD, S_HEADS) == (16, 64)
    q, k, v = (_bf16(rng.normal(size=(b, s, S_HD)).astype(np.float32)) for s in (sq, sk, sk))
    bias = _masked(rng, (b, 1, 1, sk))
    scale = 1.0 / np.sqrt(S_HD // S_HEADS)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.fused_attention_packed_streamed(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), scale, S_HEADS)
    got = fused_attention.fused_attention_packed_streamed_plain(
        _t(q), _t(k), _t(v), _t(bias), scale, S_HEADS, op_dtype=torch.bfloat16)
    _close(got, want, atol=2.0 ** -7 * float(np.abs(v).max()), rtol=0)


def test_streamed_wrapper_is_the_packed_contract_with_its_backward():
    """On the CPU the streamed wrapper computes the packed attention, forward
    and gradients."""
    rng = np.random.default_rng(6)
    q, k, v = (_t(rng.normal(size=(2, s, S_HD)).astype(np.float32)) for s in (9, 70, 70))
    bias = _t(_masked(rng, (2, 1, 9, 70)))
    grads = []
    for fn in (fused_attention.fused_attention_packed_streamed,
               fused_attention.fused_attention_packed):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, bias, 0.25, S_HEADS)
        out.sum().backward()
        grads.append([out.detach()] + [leaf.grad for leaf in leaves])
    for got, want in zip(*grads):
        _close(got, want.numpy(), atol=0, rtol=0)


def _one_walk(q, k, v, bias, scale, chunk=64):
    """The streamed kernel's arithmetic on (b, h, S, d) float32 tensors: bf16
    operands; over 64-key chunks an f32 running max and sum, the unnormalised
    weights rounded to bf16 against bf16 values, the accumulator rescaled when
    the max moves and divided by the sum at the end."""
    rt = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    q, k, v = rt(q), rt(k), rt(v)
    b, h, sq, d = q.shape
    m = torch.full((b, h, sq, 1), -torch.inf)
    total = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, v.shape[-1])
    for j0 in range(0, k.shape[2], chunk):
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, j0:j0 + chunk]) * scale
        if bias is not None:
            logits = logits + bias[..., j0:j0 + chunk]
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(logits - m_new)
        total = total * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", rt(p), v[:, :, j0:j0 + chunk])
        m = m_new
    return acc / total


def test_one_walk_matches_the_streamed_pallas_kernel_interpret():
    """The card's streamed kernel walks 64-key chunks as the TPU kernel walks
    its 64-key blocks (plan_streamed_blocks at 16 x 128): the same function,
    up to exp's last bits moving a bf16 rounding of a weight."""
    rng = np.random.default_rng(15)
    b, sq, sk = 2, 16, 128
    q, k, v = (_bf16(rng.normal(size=(b, s, S_HD)).astype(np.float32)) for s in (sq, sk, sk))
    bias = _masked(rng, (b, 1, 1, sk))
    bias[0] = MASK  # sample 0: every key masked
    scale = 1.0 / np.sqrt(S_HD // S_HEADS)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.fused_attention_packed_streamed(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), scale, S_HEADS)
    split = lambda x: _t(x).view(b, x.shape[1], S_HEADS, -1).transpose(1, 2)  # noqa: E731
    got = _one_walk(split(q), split(k), split(v), _t(bias), scale)
    got = got.transpose(1, 2).reshape(b, sq, S_HD)
    _close(got, want, atol=2.0 ** -9 * float(np.abs(v).max()), rtol=0)


def _emulate_streamed(args, workspaces):
    """The streamed C entry on CPU memory: q, k, v through the packed layout,
    the bias through its strides, the bf16 K/V workspace of streamed_plan's
    size; the one-walk arithmetic."""
    q, k, v, bias, bias_bs, bias_qs, out, kv, b, sq, sk, hd, heads, *cut, scale = args
    plan = fused_attention.streamed_plan(b, sq, sk, hd, heads)
    assert tuple(cut) == plan[:5]
    assert workspaces[kv].numel() == plan.workspace_elements
    assert workspaces[kv].dtype == torch.bfloat16
    d = hd // heads

    def heads_of(ptr, s):
        return torch.from_numpy(_strided(ptr, (b, heads, s, d), (s * hd, d, hd, 1)).copy())

    bv = None if bias is None else torch.from_numpy(
        _strided(bias, (b, heads, sq, sk), (bias_bs, 0, bias_qs, 1)).copy())
    got = _one_walk(heads_of(q, sq), heads_of(k, sk), heads_of(v, sk), bv, scale)
    _strided(out, (b, heads, sq, d), (sq * hd, d, hd, 1))[...] = got.numpy()


@pytest.mark.parametrize("sq,sk,d,bias_shape", [
    (40, 130, 32, (3, 1, 1, 130)), (130, 70, 96, (3, 1, 130, 70)), (5, 64, 128, None),
    (33, 1601 // 8, 64, (1, 1, 1, 200)),
])
def test_streamed_wrapper_hands_the_entry_its_operands(monkeypatch, sq, sk, d, bias_shape):
    """The streamed wrapper's launch, emulated: the one-walk output (sample 0
    with every key masked, where there is a per-sample bias), within 2^-7 max
    |v| of the plain version, one counted launch."""
    rng = np.random.default_rng(sq + sk + d)
    heads = 2
    workspaces = {}
    real_empty = torch.empty

    def empty(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        workspaces[t.data_ptr()] = t
        return t

    launched = []

    def launch(name, *args):
        launched.append(name)
        _emulate_streamed(args, workspaces)

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(fused_attention._cuda, "launch", launch)
    q, k, v = (_t(rng.normal(size=(3, s, heads * d)).astype(np.float32)) for s in (sq, sk, sk))
    bias = None if bias_shape is None else _t(_masked(rng, bias_shape))
    if bias is not None and bias.shape[0] == 3:
        bias[0] = MASK
    before = fused_attention._cuda.launch_counts()["fused_attention_packed_streamed"]
    got = fused_attention._packed_kernel(q, k, v, bias, 0.3, heads, streamed=True)
    assert launched == ["ovq_streamed_attention_forward"]
    assert fused_attention._cuda.launch_counts()["fused_attention_packed_streamed"] == before + 1
    want = fused_attention.fused_attention_packed_plain(q, k, v, bias, 0.3, heads,
                                                        op_dtype=torch.bfloat16)
    assert bool(torch.isfinite(got).all())
    _close(got, want.numpy(), atol=2.0 ** -7 * float(v.abs().max()), rtol=0)


@pytest.mark.parametrize("hd,h", [(256, 4), (512, 8), (768, 12)])
def test_dispatch_rules_match_the_jax_package(hd, h):
    """The port's copies of plan_q_block, packed_attention_viable,
    plan_streamed_blocks and streamed_attention_viable give the JAX
    functions' answers over a grid of query and key counts."""
    lengths = (1, 26, 100, 324, 512, 640, 1024, 1536, 1600, 2048)
    for sq, sk in itertools.product(lengths, lengths):
        assert fused_attention.plan_q_block(sq, sk, hd, True) == \
            jattn.plan_q_block(sq, sk, hd, True)
        assert fused_attention.packed_attention_viable(sq, sk, hd, h) == \
            jattn.packed_attention_viable(sq, sk, hd, h), (sq, sk)
        assert fused_attention.plan_streamed_blocks(sq, sk, hd, h) == \
            jattn.plan_streamed_blocks(sq, sk, hd, h), (sq, sk)
        assert fused_attention.streamed_attention_viable(sq, sk, hd, h) == \
            jattn.streamed_attention_viable(sq, sk, hd, h), (sq, sk)


def _spy(monkeypatch, names):
    calls = []
    for name in names:
        original = getattr(fused_attention, name)

        def spy(*args, _name=name, _original=original):
            calls.append(_name)
            return _original(*args)

        monkeypatch.setattr(fused_attention, name, spy)
    return calls


@pytest.mark.parametrize("case,want", [
    ("short stream", "fused_attention_packed"),
    ("long stream", "fused_attention_packed_streamed"),
    ("per-head bias", "fused_attention"),
    ("d_k != d_v", "fused_attention"),
])
def test_scaled_dot_product_attention_routes_as_the_jax_package(monkeypatch, case, want):
    """ScaledDotProductAttention takes the packed attention, past its reach
    (1536 keys at hd 512) the streamed one, and attend's flat attention for a
    per-head bias or d_k != d_v; the output matches the flax module's, whose
    CPU route is XLA."""
    rng = np.random.default_rng(7)
    heads, d_model = 8, 64
    length = 1536 if case == "long stream" else 20
    dk, dv = (64, 32) if case == "d_k != d_v" else (64, 64)
    cfg = {"HEAD": heads, "D_KEY": dk, "D_VALUE": dv, "D_MODEL": d_model}
    flax_module = JaxScaledDotProductAttention(JaxConfigNode(cfg))
    x = rng.normal(size=(1, length, d_model)).astype(np.float32)
    shape = (1, heads, length, length) if case == "per-head bias" else (1, 1, 1, length)
    bias = _masked(rng, shape)
    params = flax_module.init(jax.random.PRNGKey(0), jnp.asarray(x[:, :2]), jnp.asarray(x[:, :2]),
                              jnp.asarray(x[:, :2]))["params"]
    port = ScaledDotProductAttention(ConfigNode(cfg))
    with torch.no_grad():
        for name in ("fc_q", "fc_k", "fc_v", "fc_o"):
            getattr(port, name).weight.copy_(_t(params[name]["kernel"]).T)
            getattr(port, name).bias.copy_(_t(params[name]["bias"]))
    calls = _spy(monkeypatch, ["fused_attention_packed", "fused_attention_packed_streamed",
                               "fused_attention"])
    with torch.no_grad():
        got = port(_t(x), _t(x), _t(x), _t(bias))
    assert calls == [want]
    want_out = flax_module.apply({"params": params}, jnp.asarray(x), jnp.asarray(x),
                                 jnp.asarray(x), jnp.asarray(bias))
    _close(got, want_out, atol=1e-4)


# -- the choice of device block ---------------------------------------------------------------
_ALLOWED_BLOCKS = {"flat": {"single", "tile"}, "packed": {"single", "resident", "ring"},
                   "dropout": {"resident", "ring"}, "encoder": {"resident", "ring"},
                   "2bias": {"resident", "ring"}, "streamed": {"streamed"}}
# the entries that take block B at any row count, never the single-query block
_BLOCK_B_ONLY = ("dropout", "encoder", "2bias")


def _round16(n):
    return -(-n // 16) * 16


@pytest.mark.parametrize("entry", ["flat", "packed", "dropout", "encoder", "2bias", "streamed"])
def test_attention_block_choice_at_every_cut_over(entry):
    """Every shape an entry accepts maps to exactly one of its blocks, every
    one of them is reached, and each cut-over falls where its rule says: the
    single-query block up to the entry's SINGLE_QUERY_MAX_ROWS rows and
    SINGLE_QUERY_MAX_KEYS keys (never for the dropout, encoder and two-bias
    entries), the packed, dropout, encoder and two-bias blocks resident while
    four bytes per key row of width d + 8 (bf16 K and V) fit RESIDENT_KV_BYTES."""
    rows = fused_attention.SINGLE_QUERY_MAX_ROWS.get(entry, 1)
    keys = fused_attention.SINGLE_QUERY_MAX_KEYS
    budget = fused_attention.RESIDENT_KV_BYTES

    def pick(sq, sk, dk, dv=None):
        return fused_attention.attention_block(entry, sq, sk, dk, dk if dv is None else dv)

    dims = [(d, d) for d in (16, 64, 96, 128)]
    if entry == "flat":
        dims += [(4, 4), (64, 32), (32, 128)]
    seen = set()
    for sq, sk, (dk, dv) in itertools.product(
            (1, 2, rows, rows + 1, 16, 64, 215, 1536),
            (1, 8, 63, 64, 65, 215, 272, 273, 324, 400, 401, 1535, 1601, keys, keys + 1), dims):
        block = pick(sq, sk, dk, dv)
        assert block in _ALLOWED_BLOCKS[entry], (sq, sk, dk, dv, block)
        seen.add(block)
    assert seen == _ALLOWED_BLOCKS[entry]
    if entry == "streamed":
        return
    if entry in _BLOCK_B_ONLY:
        # the Iterative M4C decoder trains 5 query rows, kernel F encodes
        # one-token samples, T5 one-token questions: block B, never block A
        assert pick(1, 324, 64) == "resident" and pick(5, 210, 64) == "resident"
        assert pick(1, keys + 1, 64) == "ring"
    else:
        assert pick(1, 324, 64) == "single" and pick(rows, 324, 64) == "single"
        assert pick(rows + 1, 324, 64) != "single" and pick(1, keys + 1, 64) != "single"
        assert pick(1, keys, 64) == "single"
    if entry == "flat":
        assert pick(rows + 1, 324, 64) == "tile" and pick(1, keys + 1, 64, 32) == "tile"
        return
    for d, last in ((64, 400), (96, 272), (128, 208)):
        assert 4 * _round16(last) * (d + 8) <= budget < 4 * _round16(last + 1) * (d + 8)
        assert pick(rows + 1, last, d) == "resident" and pick(rows + 1, last + 1, d) == "ring"
        if entry in _BLOCK_B_ONLY:
            assert pick(1, last, d) == "resident" and pick(1, last + 1, d) == "ring"
    assert pick(215, 215, 96) == "resident" and pick(64, 1535, 64) == "ring"
    with pytest.raises(ValueError, match="unknown entry"):
        fused_attention.attention_block("two-bias", 1, 8, 64, 64)


def _strided(ptr, shape, strides, ctype=ctypes.c_float):
    """A writable numpy view (float32, or `ctype`) of CPU memory at `ptr` with
    element strides (0 broadcasts), as a kernel addresses it."""
    n = 1 + sum((size - 1) * stride for size, stride in zip(shape, strides))
    flat = np.ctypeslib.as_array((ctype * n).from_address(ptr))
    size = ctypes.sizeof(ctype)
    return np.lib.stride_tricks.as_strided(flat, shape, [size * stride for stride in strides])


def _emulated_attention(q, k, v, bias, scale):
    """The kernels' arithmetic on (b, h, S, d) numpy operands: bf16 operands,
    float32 softmax, bf16 weights."""
    rt = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).float()  # noqa: E731
    logits = torch.einsum("bhqd,bhkd->bhqk", rt(q), rt(k)) * scale
    if bias is not None:
        logits = logits + torch.from_numpy(np.ascontiguousarray(bias))
    weights = torch.softmax(logits, dim=-1).to(torch.bfloat16).float()
    return torch.einsum("bhqk,bhkd->bhqd", weights, rt(v)).numpy()


def _emulate_launch(entry, *args):
    """Run a block's C entry on CPU memory, reading every operand through the
    pointers and strides the wrapper passes."""
    if entry in ("ovq_single_query_attention_forward", "ovq_flat_attention_forward"):
        (q, q_bs, q_hs, q_rs, k, k_bs, k_hs, k_rs, v, v_bs, v_hs, v_rs, bias, bias_bs, bias_hs,
         bias_qs, bias_ks, out, out_bs, out_hs, out_rs, b, h, sq, sk, dk, dv, scale) = args
        qv = _strided(q, (b, h, sq, dk), (q_bs, q_hs, q_rs, 1))
        kv = _strided(k, (b, h, sk, dk), (k_bs, k_hs, k_rs, 1))
        vv = _strided(v, (b, h, sk, dv), (v_bs, v_hs, v_rs, 1))
        bv = None if bias is None else _strided(bias, (b, h, sq, sk),
                                                (bias_bs, bias_hs, bias_qs, bias_ks))
        _strided(out, (b, h, sq, dv), (out_bs, out_hs, out_rs, 1))[...] = \
            _emulated_attention(qv, kv, vv, bv, scale)
        return
    assert entry == "ovq_packed_attention_forward"
    q, k, v, bias, bias_bs, bias_qs, out, b, sq, sk, hd, heads, scale, resident = args
    assert resident in (0, 1)
    d = hd // heads

    def heads_of(ptr, s):
        return _strided(ptr, (b, heads, s, d), (s * hd, d, hd, 1))

    bv = None if bias is None else _strided(bias, (b, heads, sq, sk), (bias_bs, 0, bias_qs, 1))
    heads_of(out, sq)[...] = _emulated_attention(heads_of(q, sq), heads_of(k, sk),
                                                 heads_of(v, sk), bv, scale)


@pytest.mark.parametrize("entry,sq,sk,dk,dv,bias_shape,block", [
    ("flat", 1, 65, 64, 64, (3, 1, 1, 65), "single"),
    ("flat", 1, 9, 64, 32, None, "single"),
    ("flat", fused_attention.SINGLE_QUERY_MAX_ROWS["flat"], 30, 32, 32, (1, 4, 1, 30), "single"),
    ("flat", fused_attention.SINGLE_QUERY_MAX_ROWS["flat"] + 1, 30, 32, 32, (3, 4, 5, 30), "tile"),
    ("flat", 7, 20, 16, 16, None, "tile"),
    # head-shared (1, h, Sq, Sk) and per-sample, per-head key biases on both blocks
    ("flat", 2, 30, 32, 16, (1, 4, 2, 30), "single"),
    ("flat", 1, 30, 64, 32, (3, 4, 1, 30), "single"),
    ("flat", 5, 33, 48, 16, (1, 4, 5, 33), "tile"),
    ("flat", 70, 30, 64, 32, (3, 4, 1, 30), "tile"),
    ("packed", 1, 63, 16, 16, (3, 1, 1, 63), "single"),
    ("packed", fused_attention.SINGLE_QUERY_MAX_ROWS["packed"], 40, 16, 16, None, "single"),
    ("packed", fused_attention.SINGLE_QUERY_MAX_ROWS["packed"] + 1, 40, 16, 16, (3, 1, 1, 40),
     "resident"),
    ("packed", 5, 40, 16, 16, (3, 1, 5, 40), "resident"),
    ("packed", 20, 401, 64, 64, (1, 1, 20, 401), "ring"),
    ("packed", 20, 400, 64, 64, (1, 1, 1, 400), "resident"),
])
def test_wrappers_launch_the_chosen_block(monkeypatch, entry, sq, sk, dk, dv, bias_shape, block):
    """Each wrapper launches the C entry of the block `attention_block` names,
    with pointers and strides that address its operands: an emulation of the
    entry on CPU memory (head-split views of packed projections for the flat
    entry) gives the plain version's output, and the launch is counted."""
    rng = np.random.default_rng(sq * 1000 + sk)
    heads = 4
    launched = []

    def launch(name, *args):
        launched.append(name if name != "ovq_packed_attention_forward" else (name, args[-1]))
        _emulate_launch(name, *args)

    monkeypatch.setattr(fused_attention._cuda, "launch", launch)
    assert fused_attention.attention_block(entry, sq, sk, dk, dv) == block
    bias = None if bias_shape is None else _t(_masked(rng, bias_shape))
    counter = "fused_attention" if entry == "flat" else "fused_attention_packed"
    before = fused_attention._cuda.launch_counts()[counter]
    if entry == "flat":
        def split(s, d):
            x = _t(rng.normal(size=(3, s, heads * d)).astype(np.float32))
            return x.view(3, s, heads, d).transpose(1, 2)

        q, k, v = split(sq, dk), split(sk, dk), split(sk, dv)
        got = fused_attention._flat_kernel(q, k, v, bias, 0.3)
        want = fused_attention.fused_attention_plain(q, k, v, bias, 0.3, op_dtype=torch.bfloat16)
    else:
        q, k, v = (_t(rng.normal(size=(3, s, heads * dk)).astype(np.float32)) for s in (sq, sk, sk))
        got = fused_attention._packed_kernel(q, k, v, bias, 0.3, heads)
        want = fused_attention.fused_attention_packed_plain(q, k, v, bias, 0.3, heads,
                                                            op_dtype=torch.bfloat16)
    entries = {"single": "ovq_single_query_attention_forward", "tile": "ovq_flat_attention_forward",
               "resident": ("ovq_packed_attention_forward", 1),
               "ring": ("ovq_packed_attention_forward", 0)}
    assert launched == [entries[block]]
    assert fused_attention._cuda.launch_counts()[counter] == before + 1
    _close(got, want.numpy(), atol=1e-5)


# -- the two-bias entry: block B's two-bias instance ---------------------------------------
def _emulate_2bias_launch(entry, *args):
    """Block B's two-bias entry on CPU memory: q, k, v and out as packed (b, S,
    h * d) rows, the head-shared bias through its batch and row strides (a
    null pointer: none), the head bias through its batch stride and the (Sq,
    Sk) plane of each head."""
    assert entry == "ovq_packed_2bias_attention_forward"
    (q, k, v, bias, bias_bs, bias_qs, head_bias, head_bias_bs, out, b, sq, sk, hd, heads, scale,
     resident) = args
    assert resident in (0, 1)
    d = hd // heads

    def heads_of(ptr, s):
        return _strided(ptr, (b, heads, s, d), (s * hd, d, hd, 1))

    logits_bias = _strided(head_bias, (b, heads, sq, sk), (head_bias_bs, sq * sk, sk, 1)).copy()
    if bias is not None:
        logits_bias += _strided(bias, (b, heads, sq, sk), (bias_bs, 0, bias_qs, 1))
    heads_of(out, sq)[...] = _emulated_attention(heads_of(q, sq), heads_of(k, sk),
                                                 heads_of(v, sk), logits_bias, scale)


T5_HEADS, T5_HD = 6, 384  # mT5-small: 6 heads of 64


@pytest.mark.parametrize("b,sq,sk,form,block", [
    # the mT5 encoder at a train and an eval batch of question lengths
    (60, 26, 26, "padding + shared table", "resident"),
    (60, 26, 26, "(b, h, L, L) head bias", "resident"),
    (60, 23, 23, "padding + shared table", "resident"),
    (60, 23, 23, "per-sample head bias, row bias", "resident"),
    # one query row, and a key count past block B's resident reach
    (3, 1, 26, "padding + shared table", "resident"),
    (3, 1, 26, "per-sample head bias, row bias", "resident"),
    (2, 20, 401, "padding + shared table", "ring"),
    (2, 20, 401, "(b, h, L, L) head bias", "ring"),
])
def test_two_bias_wrapper_launches_block_b(monkeypatch, b, sq, sk, form, block):
    """The two-bias wrapper launches block B's two-bias entry with the block
    `attention_block("2bias", ...)` names (resident or ring, at any row
    count), pointers and strides that address its operands (the (1, h, Sq,
    Sk) table through a batch stride of 0, a per-sample head bias, a
    (b, 1, 1, Sk) padding or (b, 1, Sq, Sk) row bias, or none as a null
    pointer), and one count: an emulation of the entry on CPU memory gives the
    plain version's output.  Sample 0 has every key masked."""
    rng = np.random.default_rng(b * 1000 + sq * 10 + sk)
    launched = []

    def launch(name, *args):
        launched.append((name, args[3] is None, args[-1]))
        _emulate_2bias_launch(name, *args)

    monkeypatch.setattr(fused_attention._cuda, "launch", launch)
    q, k, v = (_t(rng.normal(size=(b, s, T5_HD)).astype(np.float32)) for s in (sq, sk, sk))
    padding = _masked(rng, (b, 1, 1, sk))
    padding[0] = MASK
    table = rng.normal(size=(1, T5_HEADS, sq, sk)).astype(np.float32)
    if form == "padding + shared table":
        bias, head_bias = _t(padding), _t(table)
    elif form == "(b, h, L, L) head bias":
        bias, head_bias = None, _t(table + padding)
    else:
        bias, head_bias = _t(_masked(rng, (b, 1, sq, sk))), _t(table + padding)
    assert fused_attention.attention_block("2bias", sq, sk, 64, 64) == block
    before = fused_attention._cuda.launch_counts()["fused_attention_packed_2bias"]
    got = fused_attention._packed_2bias_kernel(q, k, v, bias, head_bias, 1.0, T5_HEADS)
    want = fused_attention.fused_attention_packed_2bias_plain(
        q, k, v, bias, head_bias, 1.0, T5_HEADS, op_dtype=torch.bfloat16)
    assert launched == [("ovq_packed_2bias_attention_forward", bias is None,
                         int(block == "resident"))]
    assert fused_attention._cuda.launch_counts()["fused_attention_packed_2bias"] == before + 1
    assert bool(torch.isfinite(got).all())
    _close(got, want.numpy(), atol=1e-5)


def test_two_bias_wrapper_validates_once_and_allocates_no_bias(monkeypatch):
    """On the kernel route the wrapper reads the bias where it lies (no
    zeros for an absent one, no copy of a float32 contiguous one) and
    allocates the output alone; refused operands raise ValueError before any
    launch."""
    launched = []
    monkeypatch.setattr(fused_attention._cuda, "launch", lambda name, *args: launched.append(args))
    monkeypatch.setattr(fused_attention._cuda, "uses_kernel", lambda *tensors: True)
    allocated = []
    real_empty_like, real_zeros = torch.empty_like, torch.zeros

    def empty_like(*args, **kwargs):
        allocated.append("empty_like")
        return real_empty_like(*args, **kwargs)

    def zeros(*args, **kwargs):
        allocated.append("zeros")
        return real_zeros(*args, **kwargs)

    monkeypatch.setattr(torch, "empty_like", empty_like)
    monkeypatch.setattr(torch, "zeros", zeros)
    q = torch.zeros(2, 5, T5_HD)
    table = torch.zeros(1, T5_HEADS, 5, 5)
    padding = torch.zeros(2, 1, 1, 5)
    allocated.clear()
    with torch.no_grad():
        fused_attention.fused_attention_packed_2bias(q, q, q, None, table, 1.0, T5_HEADS)
        fused_attention.fused_attention_packed_2bias(q, q, q, padding, table, 1.0, T5_HEADS)
    assert allocated == ["empty_like", "empty_like"]
    assert launched[0][3] is None and launched[1][3] == padding.data_ptr()
    assert launched[1][4:6] == (5, 0)  # per-sample padding: batch stride Sk, rows shared
    launched.clear()
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention.fused_attention_packed_2bias(
            q, q, q, None, table.transpose(2, 3), 1.0, T5_HEADS)
    with pytest.raises(ValueError, match="multiple of 16 up to 128"):
        fused_attention.fused_attention_packed_2bias(  # head dim 192
            q, q, q, None, torch.zeros(1, 2, 5, 5), 1.0, 2)
    assert not launched


# -- the dropout entries: block B's dropout instance and the backward pair -------------------
def _rt(x):
    """bf16-rounded float32 torch tensor of a numpy view."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).float()


def _emulate_dropout_launch(entry, *args):
    """Run a dropout C entry on CPU memory through the pointers, strides and
    scalars the wrapper passes: the forward draws the Philox mask from the
    seed it finds at its pointer and the threshold it is given, and writes
    out, stats (max, 1 / denominator) and the keep bits; the backward reads
    stats and bits, not the seed, and writes D, dq, dk and dv."""
    if entry == "ovq_packed_dropout_forward":
        (q, k, v, bias, bias_bs, bias_qs, seed, threshold, keep_scale, stats, bits, out,
         b, sq, sk, hd, heads, scale, resident) = args
    else:
        (q, k, v, g, bias, bias_bs, bias_qs, keep_scale, stats, bits, delta, dq, dk, dv,
         b, sq, sk, hd, heads, scale, kv_resident, qg_resident) = args
    d, n_words = hd // heads, -(-sk // 32)

    def heads_of(ptr, s):
        return _strided(ptr, (b, heads, s, d), (s * hd, d, hd, 1))

    logits = torch.einsum("bhqd,bhkd->bhqk", _rt(heads_of(q, sq)), _rt(heads_of(k, sk))) * scale
    if bias is not None:
        logits = logits + torch.from_numpy(np.ascontiguousarray(
            _strided(bias, (b, heads, sq, sk), (bias_bs, 0, bias_qs, 1))))
    stats_v = _strided(stats, (b, heads, sq, 2), (heads * sq * 2, sq * 2, 2, 1))
    bits_v = _strided(bits, (b, heads, sq, n_words), (heads * sq * n_words, sq * n_words, n_words, 1),
                      ctypes.c_int32)
    if entry == "ovq_packed_dropout_forward":
        seed_t = torch.from_numpy(_strided(seed, (1,), (1,), ctypes.c_int64).copy())
        keep = (fused_attention._philox_words(seed_t, b, heads, sq, sk) >> 9) >= threshold
        weights = torch.softmax(logits, dim=-1)
        dropped = (weights * keep * np.float32(keep_scale)).to(torch.bfloat16).float()
        _strided(out, (b, heads, sq, d), (sq * hd, d, hd, 1))[...] = torch.einsum(
            "bhqk,bhkd->bhqd", dropped, _rt(heads_of(v, sk))).numpy()
        row_max = logits.max(dim=-1).values
        stats_v[..., 0] = row_max.numpy()
        stats_v[..., 1] = (1.0 / torch.exp(logits - row_max[..., None]).sum(dim=-1)).numpy()
        padded = torch.nn.functional.pad(keep.to(torch.int64), (0, 32 * n_words - sk))
        words = (padded.reshape(b, heads, sq, n_words, 32) << torch.arange(32)).sum(dim=-1)
        bits_v[...] = words.numpy().astype(np.uint32).view(np.int32)
        return
    word = torch.from_numpy(bits_v.astype(np.int64) & 0xFFFFFFFF)
    keep = ((word[..., None] >> torch.arange(32)) & 1).reshape(b, heads, sq, 32 * n_words)[..., :sk]
    factors = keep.float() * np.float32(keep_scale)
    weights = torch.exp(logits - torch.from_numpy(stats_v[..., :1].copy())) * \
        torch.from_numpy(stats_v[..., 1:].copy())
    gh, vh, qh, kh = _rt(heads_of(g, sq)), _rt(heads_of(v, sk)), _rt(heads_of(q, sq)), \
        _rt(heads_of(k, sk))
    dp = torch.einsum("bhqd,bhkd->bhqk", gh, vh)
    row_d = (weights * factors * dp).sum(dim=-1)
    ds = (weights * (factors * dp - row_d[..., None])).to(torch.bfloat16).float()
    _strided(delta, (b, heads, sq), (heads * sq, sq, 1))[...] = row_d.numpy()
    heads_of(dq, sq)[...] = (torch.einsum("bhqk,bhkd->bhqd", ds, kh) * scale).numpy()
    heads_of(dk, sk)[...] = (torch.einsum("bhqk,bhqd->bhkd", ds, qh) * scale).numpy()
    dropped = (weights * factors).to(torch.bfloat16).float()
    heads_of(dv, sk)[...] = torch.einsum("bhqk,bhqd->bhkd", dropped, gh).numpy()


@pytest.mark.parametrize("sq,sk,d,bias_shape", [
    (1, 9, 16, None),                # one query row: block B, never the single-query block
    (5, 40, 16, (3, 1, 1, 40)),      # the Iterative M4C decoder's 5 rows, key-only bias
    (7, 33, 32, (3, 1, 7, 33)),      # a per-sample bias, keys not a multiple of 32
    (20, 401, 64, (1, 1, 20, 401)),  # K and V past the resident limit: ring forward, kernel 1 ring
    (401, 20, 64, (1, 1, 1, 20)),    # Q and G past it: kernel 2 ring
])
def test_dropout_wrappers_launch_block_b_and_the_backward_pair(monkeypatch, sq, sk, d, bias_shape):
    """The dropout wrappers launch block B's dropout entry in the form
    `attention_block("dropout", ...)` names and the backward entry with each
    kernel's form from the same rule (K, V by (sq, sk); Q, G by (sk, sq)),
    with pointers, strides and scalars that address their operands: an
    emulation of the entries on CPU memory gives the plain versions' output
    (atol 1e-5: the same arithmetic) and gradients (within 1e-2 of their
    largest magnitude, as on the card: the backward takes p as exp(x - max) /
    sum from the forward's stats, one float32 rounding from the softmax, which
    can move a bf16-rounded dS by one ulp).  The stats are (b, h, Sq, 2)
    float32 (max, 1 / denominator) and the bits (b, h, Sq, ceil(Sk / 32))
    int32, equal to ``dropout_mask_bits``; one launch of each is counted."""
    rng = np.random.default_rng(sq * 1000 + sk)
    heads, rate = 4, 0.25
    launched = []

    def launch(name, *args):
        launched.append((name, *args[-2:]) if name.endswith("backward") else (name, args[-1]))
        _emulate_dropout_launch(name, *args)

    monkeypatch.setattr(fused_attention._cuda, "launch", launch)
    q, g = (_t(rng.normal(size=(3, sq, heads * d)).astype(np.float32)) for _ in range(2))
    k, v = (_t(rng.normal(size=(3, sk, heads * d)).astype(np.float32)) for _ in range(2))
    bias = None if bias_shape is None else _t(_masked(rng, bias_shape))
    seed = torch.tensor([20260 + sq], dtype=torch.int64)
    before = fused_attention._cuda.launch_counts()
    out, stats, bits = fused_attention._dropout_forward_kernel(q, k, v, bias, seed, 0.3, heads, rate)
    grads = fused_attention._dropout_backward_kernel(q, k, v, bias, stats, bits, g, 0.3, heads, rate)
    after = fused_attention._cuda.launch_counts()
    block = fused_attention.attention_block("dropout", sq, sk, d, d)
    resident = {"resident": 1, "ring": 0}
    assert launched == [
        ("ovq_packed_dropout_forward", resident[block]),
        ("ovq_packed_dropout_backward", resident[block],
         resident[fused_attention.attention_block("dropout", sk, sq, d, d)]),
    ]
    for name in ("fused_attention_packed_dropout", "fused_attention_packed_dropout_backward"):
        assert after[name] == before[name] + 1, name
    assert stats.dtype == torch.float32 and tuple(stats.shape) == (3, heads, sq, 2)
    assert bits.dtype == torch.int32 and tuple(bits.shape) == (3, heads, sq, -(-sk // 32))
    assert torch.equal(bits, fused_attention.dropout_mask_bits(seed, 3, heads, sq, sk, rate))
    plain_args = (q, k, v, bias, seed, 0.3, heads, rate)
    want = fused_attention.fused_attention_packed_dropout_plain(*plain_args, op_dtype=torch.bfloat16)
    _close(out, want.numpy(), atol=1e-5)
    want_grads = fused_attention.fused_attention_packed_dropout_backward_plain(
        q, k, v, bias, seed, g, 0.3, heads, rate, op_dtype=torch.bfloat16)
    for got, want in zip(grads, want_grads):
        _close(got, want.numpy(), atol=1e-2 * float(want.abs().max()), rtol=0)
