"""The plan of the persistent step kernel (kernels A, B, D, E and the
decoder-layer step, ``csrc/decoder_layer_step.cu``) and the arguments their wrappers hand its
C entries, on the CPU.

The kernel runs only on the card.  What can be checked here is the Python that
cuts it over the card (``ops/decode_step.py::step_plan``: the grid, its shared
memory, each product's K slice, the one workspace's buffers, the CTAs' shares of
the L2 prefetch) at the shapes the paths call it at, and, through an emulation
of each C entry on CPU memory (its operands read back through the pointers and
sizes it is given, then the plain version run on them), that each wrapper passes
its operands, workspace buffers and plan in the entry's order.
"""

import ctypes
import itertools

import numpy as np
import pytest
import torch

from openvivqa_tpu_torch.ops import _cuda
from openvivqa_tpu_torch.ops import decode_step as ds
from openvivqa_tpu_torch.ops import fused_attention

# (rows, hd, heads, T, Sk): IterativeMCAN's beam step (63 rows, Sk 110), its staged
# route's kernels, ViTmT5's (60 rows over 223 keys), JointTransformer's (60 over
# 324), the Iterative M4C step (64 rows, E over 210 keys, A over a 12-slot ring),
# a last beam batch of odd size, greedy 64 rows
STEP_SHAPES = ((63, 512, 8, 5, 110), (60, 512, 8, 8, 223), (60, 512, 8, 8, 324),
               (64, 512, 8, 12, 210), (37, 512, 8, 5, 110), (64, 768, 12, 12, 210),
               (1, 512, 8, 5, 110))
D_FF = {512: 2048, 768: 3072}


def _weight_bytes(kind, hd, d_ff):
    """The bytes of each weight matrix the call prefetches."""
    self_w = (hd * 3 * hd * 2, hd * hd * 2)
    cross_w = (hd * hd * 2, hd * hd * 2)
    ffn_w = (hd * d_ff * 2, d_ff * hd * 2)
    return {"self": self_w, "cross": cross_w, "layer": self_w + cross_w + ffn_w}[kind]


def _plans(rows, hd, heads, t_len, sk):
    d_ff = D_FF[hd]
    return {"self": ds.step_plan("self", rows, hd, heads, t_len),
            "cross": ds.step_plan("cross", rows, hd, heads, sk),
            "layer": ds.step_plan("layer", rows, hd, heads, max(t_len, sk), d_ff)}


@pytest.mark.parametrize("rows,hd,heads,t_len,sk", STEP_SHAPES)
def test_every_prefetched_byte_belongs_to_exactly_one_cta(rows, hd, heads, t_len, sk):
    """Each weight matrix and the encoder K/V (bf16 and f32) is cut into its
    CTAs' shares of 128-byte lines: disjoint, covering every byte, none past the
    end of the buffer."""
    for kind, plan in _plans(rows, hd, heads, t_len, sk).items():
        sizes = list(_weight_bytes(kind, hd, D_FF[hd]))
        if kind != "self":
            sizes += [rows * sk * hd * 2, rows * sk * hd * 4]
        for nbytes in sizes:
            lines = [ds.step_prefetch_lines(nbytes, plan.ctas, cta) for cta in range(plan.ctas)]
            covered = [line for share in lines for line in share]
            assert covered == list(range(-(-nbytes // 128)))
            assert all(line * 128 < nbytes for line in covered)


@pytest.mark.parametrize("rows,hd,heads,t_len,sk", STEP_SHAPES)
def test_layer_steps_ffn_phase_takes_kernel_cs_plans(rows, hd, heads, t_len, sk):
    """The layer step's last two products take ffn_plans' K slices, on the 64 x
    64 tiles kernel C's own route runs at these rows; A's and B's products take
    gemm_plan's split; the C entry's six slices come in product order."""
    plans = _plans(rows, hd, heads, t_len, sk)
    p1, p2 = ds.ffn_plans(rows, hd, D_FF[hd])
    layer = plans["layer"]
    assert layer.k_slices[4:] == (p1.k_slice, p2.k_slice)
    assert layer.splits[4:] == (p1.splits, p2.splits)
    assert (p1.bm, p1.bn, p2.bm, p2.bn) == (64, 64, 64, 64) and p2.cluster == 0
    assert layer.k_slices[:2] == plans["self"].k_slices
    assert layer.k_slices[2:4] == plans["cross"].k_slices
    for (n, k), k_slice in zip(((3 * hd, hd), (hd, hd)), plans["self"].k_slices):
        assert k_slice == _cuda.gemm_plan(rows, n, k, "bias").k_slice
    for splits, k_slice, k in zip(layer.splits, layer.k_slices,
                                  (hd, hd, hd, hd, hd, D_FF[hd])):
        assert k_slice % 64 == 0 and (splits - 1) * k_slice < k <= splits * k_slice


@pytest.mark.parametrize("rows,hd,heads,t_len,sk", STEP_SHAPES)
def test_step_grid_fits_the_card(rows, hd, heads, t_len, sk):
    """Two CTAs per SM, each within its half of the SM's shared memory and the
    per-CTA ceiling, holding the TMA ring and two attention items' scratch
    for every key; the workspace's buffers are disjoint, 256-byte aligned, and
    the partial tiles hold every product's split."""
    for kind, plan in _plans(rows, hd, heads, t_len, sk).items():
        keys = {"self": t_len, "cross": sk, "layer": max(t_len, sk)}[kind]
        assert plan.ctas == 2 * _cuda.SM_COUNT
        assert plan.smem <= _cuda.MAX_SMEM_BYTES and plan.smem <= _cuda.SMEM_PER_SM // 2 - 1024
        assert plan.smem >= ds.STEP_RING_BYTES + 2 * 4 * keys
        end = 0
        for name, offset, size in plan.buffers:
            assert offset % 256 == 0 and offset >= end
            end = offset + size
        assert end <= plan.workspace_bytes
        sizes = dict((name, size) for name, _, size in plan.buffers)
        widths = {"self": (3 * hd, hd), "cross": (hd, hd),
                  "layer": (3 * hd, hd, hd, hd, D_FF[hd], hd)}[kind]
        assert sizes["partial"] == 4 * rows * max(
            s * n for s, n in zip(plan.splits, widths))


@pytest.mark.parametrize("rows,hd", [(513, 512), (600, 512), (2000, 512), (321, 768), (640, 768)])
def test_layer_step_past_kernel_cs_split_route_takes_a_and_bs_rule(rows, hd):
    """Past the row counts where kernel C runs its 64 x 64 split route (513 and
    more rows at hd 512, 321 and more at hd 768: an eval or SCST batch times
    the beam), the layer step still takes the call: its FFN products take
    gemm_plan's split where it splits, else all of K in one slice, on the same
    64 x 64 tiles, and the partial tiles hold the widest."""
    d_ff, heads = D_FF[hd], hd // 64
    p1, p2 = ds.ffn_plans(rows, hd, d_ff)
    assert (p1.bm, p1.bn) != (64, 64) or (p2.bm, p2.bn) != (64, 64) or p2.cluster
    plan = ds.step_plan("layer", rows, hd, heads, 110, d_ff)
    for (n, k), splits, k_slice in zip(((d_ff, hd), (hd, d_ff)), plan.splits[4:],
                                       plan.k_slices[4:]):
        want = _cuda.gemm_plan(rows, n, k, "bias")
        assert k_slice == (want.k_slice if want.cluster == 0 else k)
        assert k_slice % 64 == 0 and (splits - 1) * k_slice < k <= splits * k_slice
    sizes = dict((name, size) for name, _, size in plan.buffers)
    widths = (3 * hd, hd, hd, hd, d_ff, hd)
    assert sizes["partial"] == 4 * rows * max(s * n for s, n in zip(plan.splits, widths))
    assert plan.ctas == 2 * _cuda.SM_COUNT


def test_step_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="shared memory"):
        ds.step_plan("cross", 63, 512, 8, 100_000)
    with pytest.raises(ValueError, match="unknown kind"):
        ds.step_plan("ffn", 63, 512, 8, 110)
    with pytest.raises(ValueError, match="multiple of 128"):
        ds.step_plan("self", 63, 320, 8, 5)


# kernel D's (rows, hd, heads, C, T): MMF_M4C's greedy step (64 rows, 8 heads of 96,
# 10 question + 100 object + 100 OCR context keys, 5 slots), the regional
# variant's context (10 + 100 + 49 grids + 30 OCR), an odd context at a last
# batch of odd size, the card tests' hd 256 over 2 heads, one row
BERT_SELF_SHAPES = ((64, 768, 8, 210, 5), (64, 768, 8, 189, 5), (37, 768, 8, 77, 5),
                    (5, 256, 2, 77, 4), (1, 768, 8, 13, 12))


@pytest.mark.parametrize("rows,hd,heads,c_len,t_len", BERT_SELF_SHAPES)
def test_bert_self_plan_holds_the_context_and_the_slots(rows, hd, heads, c_len, t_len):
    """Kernel D's plan: one logits row of C + T keys in each attention item's
    scratch (the head dim's instance, 128 at d 96), A's two products (q|k|v of
    3 hd, then the out projection) at gemm_plan's K split, the workspace's
    bf16 x and context and the partial tiles of the wider split, two CTAs per
    SM within the shared memory each may take; past that context the plan
    raises ValueError."""
    plan = ds.step_plan("bert_self", rows, hd, heads, c_len + t_len)
    d = hd // heads
    assert ds.step_head_block(d) == (64 if d <= 64 else 128)
    assert plan.smem == ds.step_smem_bytes(d, c_len + t_len)
    assert plan.smem >= ds.STEP_RING_BYTES + 2 * 4 * (c_len + t_len)
    assert plan.smem <= _cuda.MAX_SMEM_BYTES and plan.smem <= _cuda.SMEM_PER_SM // 2 - 1024
    assert plan.ctas == 2 * _cuda.SM_COUNT
    assert plan.k_slices == ds.step_plan("self", rows, hd, heads, t_len).k_slices
    for (n, k), k_slice, splits in zip(((3 * hd, hd), (hd, hd)), plan.k_slices, plan.splits):
        assert k_slice == _cuda.gemm_plan(rows, n, k, "bias").k_slice
        assert k_slice % 64 == 0 and (splits - 1) * k_slice < k <= splits * k_slice
    sizes = {name: size for name, _, size in plan.buffers}
    assert list(sizes) == ["xb", "ctx", "partial"]
    assert sizes["xb"] == sizes["ctx"] == rows * hd * 2
    assert sizes["partial"] == 4 * rows * max(s * n for s, n in zip(plan.splits, (3 * hd, hd)))
    too_long = _cuda.MAX_SMEM_BYTES // 8
    with pytest.raises(ValueError, match="shared memory"):
        ds.step_plan("bert_self", rows, hd, heads, too_long + t_len)


def test_a_long_key_stream_takes_one_cta_per_sm():
    """Past half an SM's shared memory the grid is one CTA per SM."""
    plan = ds.step_plan("cross", 63, 512, 8, 20_000)
    assert plan.ctas == _cuda.SM_COUNT and plan.smem <= _cuda.MAX_SMEM_BYTES


# -- the streamed attention's plan -------------------------------------------------------
# (b, Sq, Sk, hd, heads): phase 3's 64 x 1536 and ragged 16 x 1601, phase 9's long
# stream through JointTransformer's Encoder, the card tests' odd query counts and
# head dims
STREAMED_SHAPES = ((64, 1536, 1536, 512, 8), (16, 1601, 1601, 512, 8), (16, 1536, 1536, 512, 8),
                   (2, 40, 1601, 512, 8), (2, 130, 300, 256, 8), (2, 64, 200, 768, 8),
                   (2, 33, 45, 512, 4))


@pytest.mark.parametrize("b,sq,sk,hd,heads", STREAMED_SHAPES)
def test_streamed_plan_at_every_called_shape(b, sq, sk, hd, heads):
    """192 query rows a CTA (three warpgroups of 64) at head dims up to 64,
    128 (two) up to 128, a ring of four 64-key stages of K and V padded to 64
    or 128 columns and a bf16 Q tile per warpgroup, within one CTA's shared
    memory (the C entry refuses any other plan); the workspace holds K and V in bf16 at the padded width."""
    plan = fused_attention.streamed_plan(b, sq, sk, hd, heads)
    d = hd // heads
    assert plan.head_block == (64 if d <= 64 else 128) and plan.head_block >= d
    assert plan.q_rows == (192 if plan.head_block == 64 else 128)
    assert (plan.stages, plan.chunk) == (4, 64)
    q_tiles = plan.q_rows * plan.head_block * 2
    assert plan.smem == 1024 + 4 * 2 * plan.head_block * 64 * 2 + q_tiles + 64
    assert plan.smem <= _cuda.MAX_SMEM_BYTES
    assert plan.workspace_elements == 2 * b * heads * sk * plan.head_block


def test_streamed_plan_refuses_a_head_dim_the_block_does_not_take():
    with pytest.raises(ValueError, match="multiple of 16 up to 128"):
        fused_attention.streamed_plan(2, 8, 8, 8 * 136, 8)
    with pytest.raises(ValueError, match="multiple of 16 up to 128"):
        fused_attention.streamed_plan(2, 8, 8, 8 * 40, 8)


# -- the C entries, emulated on CPU memory ----------------------------------------------
def _view(ptr, n, ctype):
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


def _f32(ptr, *shape):
    return torch.from_numpy(_view(ptr, int(np.prod(shape)), ctypes.c_float).reshape(shape))


def _bf16(ptr, *shape):
    raw = _view(ptr, int(np.prod(shape)), ctypes.c_int16).reshape(shape)
    return torch.from_numpy(raw).view(torch.bfloat16)


def _cache(ptr, is_bf16, *shape):
    return _bf16(ptr, *shape) if is_bf16 else _f32(ptr, *shape)


def _attention_w(ptrs, in_name, hd, in_width):
    names = (in_name, "b" + in_name[1:], "wo", "bo", "ln_scale", "ln_bias")
    shapes = ((hd, in_width), (in_width,), (hd, hd), (hd,), (hd,), (hd,))
    return {name: (_bf16 if name in (in_name, "wo") else _f32)(ptr, *shape)
            for name, ptr, shape in zip(names, ptrs, shapes)}


def _check_buffers(buffers, plan, workspaces):
    """The buffers are the plan's, carved from one workspace of its size."""
    base = buffers[0]
    assert workspaces[base].numel() == plan.workspace_bytes
    assert [ptr - base for ptr in buffers] == [offset for _, offset, _ in plan.buffers]


def _emulate_self(args, workspaces):
    (x, *w, sb, ck, cv, cb, xb, ctx, partial, y, rows, max_len, t, hd, heads, cache_bf16,
     ks_qkv, ks_o, ctas, smem, scale, eps) = args
    plan = ds.step_plan("self", rows, hd, heads, max_len)
    assert ((ks_qkv, ks_o), ctas, smem) == (plan.k_slices, plan.ctas, plan.smem)
    _check_buffers((xb, ctx, partial), plan, workspaces)
    ring = [_cache(ck, cache_bf16, rows, max_len, hd), _cache(cv, cache_bf16, rows, max_len, hd),
            _f32(cb, rows, max_len)]
    out, *_ = ds.fused_self_attention_step_plain(
        _f32(x, rows, hd), _attention_w(w, "wqkv", hd, 3 * hd), _f32(sb, rows), t, *ring,
        scale, heads, eps)
    _f32(y, rows, hd)[...] = out


def _emulate_cross(args, workspaces):
    (x, *w, ek, ev, eb, xb, ctx, partial, y, rows, sk, hd, heads, enc_bf16, ks_q, ks_o, ctas,
     smem, scale, eps) = args
    plan = ds.step_plan("cross", rows, hd, heads, sk)
    assert ((ks_q, ks_o), ctas, smem) == (plan.k_slices, plan.ctas, plan.smem)
    _check_buffers((xb, ctx, partial), plan, workspaces)
    kv = (_cache(ek, enc_bf16, rows, sk, hd), _cache(ev, enc_bf16, rows, sk, hd))
    out = ds.fused_cross_attention_step_plain(
        _f32(x, rows, hd), _attention_w(w, "wq", hd, hd), *kv, _f32(eb, rows, sk), scale, heads,
        eps)
    _f32(y, rows, hd)[...] = out


def _emulate_bert_self(args, workspaces):
    (x, *w, ck, cv, cb, sk, sv, xb, ctx, partial, y, rows, c_len, n_slots, t, hd, heads,
     ks_qkv, ks_o, ctas, smem, scale, eps) = args
    plan = ds.step_plan("bert_self", rows, hd, heads, c_len + n_slots)
    assert ((ks_qkv, ks_o), ctas, smem) == (plan.k_slices, plan.ctas, plan.smem)
    assert 0 <= t < n_slots
    _check_buffers((xb, ctx, partial), plan, workspaces)
    out, *_ = ds.fused_bert_self_step_plain(
        _f32(x, rows, hd), _attention_w(w, "wqkv", hd, 3 * hd),
        (_bf16(ck, rows, c_len, hd), _bf16(cv, rows, c_len, hd)), _bf16(sk, rows, n_slots, hd),
        _bf16(sv, rows, n_slots, hd), t, _f32(cb, rows, c_len), scale, heads, eps)
    _f32(y, rows, hd)[...] = out


def _emulate_layer(args, workspaces):
    x, rest = args[0], args[1:]
    self_w, cross_w, ffn_w, rest = rest[:6], rest[6:12], rest[12:18], rest[18:]
    sb, ck, cv, cb, ek, ev, eb, *buffers = rest[:17]
    y = buffers.pop()
    (rows, max_len, t, sk, hd, heads, d_ff, cache_bf16, enc_bf16, *k_slices, ctas, smem,
     scale, eps) = rest[17:]
    plan = ds.step_plan("layer", rows, hd, heads, max(max_len, sk), d_ff)
    assert (tuple(k_slices), ctas, smem) == (plan.k_slices, plan.ctas, plan.smem)
    _check_buffers(buffers, plan, workspaces)
    f = dict(zip(("w1", "b1", "w2", "b2", "ln_scale", "ln_bias"), ffn_w))
    ffn = {"w1": _bf16(f["w1"], hd, d_ff), "b1": _f32(f["b1"], d_ff),
           "w2": _bf16(f["w2"], d_ff, hd), "b2": _f32(f["b2"], hd),
           "ln_scale": _f32(f["ln_scale"], hd), "ln_bias": _f32(f["ln_bias"], hd)}
    ring = [_cache(ck, cache_bf16, rows, max_len, hd), _cache(cv, cache_bf16, rows, max_len, hd),
            _f32(cb, rows, max_len)]
    kv = (_cache(ek, enc_bf16, rows, sk, hd), _cache(ev, enc_bf16, rows, sk, hd))
    assert eps == pytest.approx(1e-6)
    out, *_ = ds.fused_decoder_layer_step_plain(
        _f32(x, rows, hd), _attention_w(self_w, "wqkv", hd, 3 * hd),
        _attention_w(cross_w, "wq", hd, hd), ffn, _f32(sb, rows), t, *ring, *kv,
        _f32(eb, rows, sk), scale, heads)
    _f32(y, rows, hd)[...] = out


@pytest.fixture
def emulated(monkeypatch):
    """CPU tensors take the kernel route, whose C entries run their emulations;
    the workspace each call allocates is found by its pointer."""
    workspaces = {}
    real_empty = torch.empty

    def empty(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        workspaces[t.data_ptr()] = t
        return t

    def launch(entry, *args):
        if entry == "ovq_self_attention_step_forward":
            _emulate_self(args, workspaces)
        elif entry == "ovq_bert_self_step_forward":
            _emulate_bert_self(args, workspaces)
        elif entry in ("ovq_cross_attention_step_forward",
                       "ovq_cross_attention_streamed_forward"):
            _emulate_cross(args, workspaces)
        else:
            assert entry == "ovq_decoder_layer_step_forward"
            _emulate_layer(args, workspaces)
        launched.append(entry)

    launched = []
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(_cuda, "launch", launch)
    monkeypatch.setattr(_cuda, "uses_kernel", lambda *tensors: True)
    return launched


def _normal(rng, *shape, scale=1.0, dtype=torch.float32):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dtype)


def _weights(rng, hd, in_name, in_width):
    return {in_name: _normal(rng, hd, in_width, scale=0.05, dtype=torch.bfloat16),
            "b" + in_name[1:]: _normal(rng, in_width, scale=0.1),
            "wo": _normal(rng, hd, hd, scale=0.05, dtype=torch.bfloat16),
            "bo": _normal(rng, hd, scale=0.1), "ln_scale": 1 + _normal(rng, hd, scale=0.1),
            "ln_bias": _normal(rng, hd, scale=0.1)}


def _ring(rng, rows, max_len, hd, dtype):
    bias = torch.where(torch.from_numpy(rng.random((rows, max_len))) < 0.2, -10e4, 0.0).float()
    return [_normal(rng, rows, max_len, hd, dtype=dtype), _normal(rng, rows, max_len, hd, dtype=dtype),
            bias]


_EMULATED = list(itertools.product(((1, 128, 2, 3, 9), (37, 256, 4, 5, 70), (63, 256, 2, 6, 110)),
                                   (torch.float32, torch.bfloat16)))


@pytest.mark.parametrize("shape,dtype", _EMULATED)
def test_self_attention_step_wrapper_hands_the_entry_its_operands(emulated, shape, dtype):
    """Kernel A's launch, emulated: the plain version's output and ring at a
    clamped step, the plan of step_plan, one workspace of its size."""
    rows, hd, heads, max_len, _ = shape
    rng = np.random.default_rng(rows + hd)
    x, sb = _normal(rng, rows, hd), torch.where(torch.arange(rows) % 5 == 0, -10e4, 0.0).float()
    w = _weights(rng, hd, "wqkv", 3 * hd)
    ring = _ring(rng, rows, max_len, hd, dtype)
    plain_ring = [r.clone() for r in ring]
    got, *_ = ds.fused_self_attention_step(x, w, sb, max_len + 1, *ring, hd ** -0.5 * 2, heads)
    want, *_ = ds.fused_self_attention_step_plain(x, w, sb, max_len + 1, *plain_ring,
                                                  hd ** -0.5 * 2, heads)
    assert emulated == ["ovq_self_attention_step_forward"]
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(ring, plain_ring))


@pytest.mark.parametrize("shape,dtype", _EMULATED)
def test_cross_attention_wrappers_hand_the_entries_their_operands(emulated, shape, dtype):
    """Kernels B's and E's launches, emulated: the plain version's output, each
    through its own entry, E at its eps."""
    rows, hd, heads, _, sk = shape
    rng = np.random.default_rng(rows + sk)
    x = _normal(rng, rows, hd)
    w = _weights(rng, hd, "wq", hd)
    kv = (_normal(rng, rows, sk, hd, dtype=dtype), _normal(rng, rows, sk, hd, dtype=dtype))
    eb = torch.where(torch.from_numpy(rng.random((rows, sk))) < 0.3, -10e4, 0.0).float()
    eb[0] = -10e4
    scale = (hd // heads) ** -0.5
    got = ds.fused_cross_attention_step(x, w, *kv, eb, scale, heads)
    assert torch.equal(got, ds.fused_cross_attention_step_plain(x, w, *kv, eb, scale, heads))
    got = ds.fused_cross_attention_streamed(x, w, kv, eb, scale, heads, 1e-12)
    want = ds.fused_cross_attention_streamed_plain(x, w, kv, eb, scale, heads, 1e-12)
    assert torch.equal(got, want)
    assert emulated == ["ovq_cross_attention_step_forward", "ovq_cross_attention_streamed_forward"]


@pytest.mark.parametrize("shape,dtype", _EMULATED)
def test_layer_step_wrapper_hands_the_entry_its_operands(emulated, shape, dtype):
    """The layer step's launch, emulated: the plain version's output and ring,
    the six K slices of step_plan, the nine workspace buffers."""
    rows, hd, heads, max_len, sk = shape
    d_ff = 2 * hd
    rng = np.random.default_rng(rows * 3 + hd)
    x, sb = _normal(rng, rows, hd), torch.zeros(rows)
    self_w, cross_w = _weights(rng, hd, "wqkv", 3 * hd), _weights(rng, hd, "wq", hd)
    ffn_w = {"w1": _normal(rng, hd, d_ff, scale=0.05, dtype=torch.bfloat16),
             "b1": _normal(rng, d_ff, scale=0.1),
             "w2": _normal(rng, d_ff, hd, scale=0.05, dtype=torch.bfloat16),
             "b2": _normal(rng, hd, scale=0.1), "ln_scale": 1 + _normal(rng, hd, scale=0.1),
             "ln_bias": _normal(rng, hd, scale=0.1)}
    ring = _ring(rng, rows, max_len, hd, dtype)
    plain_ring = [r.clone() for r in ring]
    kv = (_normal(rng, rows, sk, hd, dtype=dtype), _normal(rng, rows, sk, hd, dtype=dtype))
    eb = torch.where(torch.from_numpy(rng.random((rows, sk))) < 0.3, -10e4, 0.0).float()
    scale = (hd // heads) ** -0.5
    got, *_ = ds.fused_decoder_layer_step(x, self_w, cross_w, ffn_w, sb, 2, *ring, *kv, eb,
                                          scale, heads)
    want, *_ = ds.fused_decoder_layer_step_plain(x, self_w, cross_w, ffn_w, sb, 2, *plain_ring,
                                                 *kv, eb, scale, heads)
    assert emulated == ["ovq_decoder_layer_step_forward"]
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(ring, plain_ring))


@pytest.mark.parametrize("rows,hd,heads,c_len,t_len", [
    (5, 256, 2, 77, 4), (3, 768, 8, 13, 5), (4, 128, 2, 1, 3), (1, 256, 4, 9, 1)])
def test_bert_self_step_wrapper_hands_the_entry_its_operands(emulated, rows, hd, heads, c_len,
                                                             t_len):
    """Kernel D's launch, emulated over T + 2 steps (the last two clamp to the
    last slot): the plain version's output and slots at every step, one launch
    of the bert_self plan a step with its workspace, the context read where it
    lies; a sample's context fully padded."""
    rng = np.random.default_rng(rows * 7 + hd + c_len)
    w = _weights(rng, hd, "wqkv", 3 * hd)
    ctx = (_normal(rng, rows, c_len, hd, dtype=torch.bfloat16),
           _normal(rng, rows, c_len, hd, dtype=torch.bfloat16))
    cb = torch.where(torch.from_numpy(rng.random((rows, c_len))) < 0.3, -10e4, 0.0).float()
    cb[0] = -10e4
    slots = [torch.zeros(rows, t_len, hd, dtype=torch.bfloat16) for _ in range(2)]
    plain_slots = [s.clone() for s in slots]
    scale = (hd // heads) ** -0.5
    for step in range(t_len + 2):
        x = _normal(rng, rows, hd)
        got, *_ = ds.fused_bert_self_step(x, w, ctx, *slots, step, cb, scale, heads, 1e-12)
        want, *_ = ds.fused_bert_self_step_plain(x, w, ctx, *plain_slots, step, cb, scale, heads,
                                                 1e-12)
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(slots, plain_slots))
    assert emulated == ["ovq_bert_self_step_forward"] * (t_len + 2)


def test_bert_self_step_refuses_a_context_past_shared_memory(emulated):
    """A context whose logits row does not fit the step kernel's shared memory
    raises ValueError before any launch (there is no plain fallback)."""
    rows, hd, heads, c_len = 1, 128, 2, _cuda.MAX_SMEM_BYTES // 8
    rng = np.random.default_rng(5)
    w = _weights(rng, hd, "wqkv", 3 * hd)
    ctx = tuple(torch.zeros(rows, c_len, hd, dtype=torch.bfloat16) for _ in range(2))
    slots = [torch.zeros(rows, 4, hd, dtype=torch.bfloat16) for _ in range(2)]
    with pytest.raises(ValueError, match="shared memory"):
        ds.fused_bert_self_step(_normal(rng, rows, hd), w, ctx, *slots, 0,
                                torch.zeros(rows, c_len), 0.125, heads, 1e-12)
    assert emulated == []


@pytest.mark.parametrize("hd,heads", [(128, 32), (384, 32), (128, 128)])
def test_step_wrappers_take_a_head_dim_off_the_16_byte_grain(emulated, hd, heads):
    """A head dim that is not a multiple of 8 (4, 12, 1: the kernel reads such
    rows element by element) is launched like any other."""
    rng = np.random.default_rng(hd + heads)
    x = _normal(rng, 4, hd)
    w = _weights(rng, hd, "wq", hd)
    kv = (_normal(rng, 4, 9, hd, dtype=torch.bfloat16), _normal(rng, 4, 9, hd, dtype=torch.bfloat16))
    eb = torch.zeros(4, 9)
    got = ds.fused_cross_attention_step(x, w, *kv, eb, 0.25, heads)
    assert torch.equal(got, ds.fused_cross_attention_step_plain(x, w, *kv, eb, 0.25, heads))
    assert emulated == ["ovq_cross_attention_step_forward"]
