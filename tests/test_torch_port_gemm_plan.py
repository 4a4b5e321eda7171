"""The launch plan of kernels C and F (``ops/_cuda.py::gemm_plan``) and the
arguments their wrappers hand the C entries, on the CPU.

The kernels run only on the card, so what can be checked here is the Python
that surrounds them: the plan of each product (tile, K split, cluster) at every
row count the paths use, the shapes it refuses, and, through an emulation of
each C entry on CPU memory (its operands read back through the pointers and
sizes it is given), that kernel C's and kernel F's wrappers pass their operands,
workspaces and plans in the entry's order.
"""

import ctypes
import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from openvivqa_tpu_torch.ops import _cuda, decode_step, encoder_layer, fused_attention

# the row counts of the paths: one decode token, odd beam batches, the decode
# batch of 64, TextBert 64 x 10, the MMT encodes 64 x 210 and 64 x 215
ROWS = (1, 37, 63, 64, 65, 300, 640, 13440, 13760)
# (hd, d_ff): MMF_M4C / TextBert, and the 512-wide models
WIDTHS = ((768, 3072), (512, 2048))


def _products(hd, d_ff):
    """(n, k, epilogue) of kernel C's and kernel F's products."""
    return ((d_ff, hd, "bias"), (hd, d_ff, "ln"), (3 * hd, hd, "bias"), (hd, hd, "ln"))


_CASES = [(m, n, k, epi) for m, (hd, d_ff) in itertools.product(ROWS, WIDTHS)
          for n, k, epi in _products(hd, d_ff)]


@pytest.mark.parametrize("m,n,k,epilogue", _CASES)
def test_plan_covers_every_row_column_and_k_once(m, n, k, epilogue):
    """The grid's tiles cover every row and column of the output exactly once
    (the last tile ragged at most), the K slices are whole 64-deep blocks that
    cover K without an empty slice, a cluster divides the column tiles and, for
    the LayerNorm, spans the whole row."""
    plan = _cuda.gemm_plan(m, n, k, epilogue)
    gx, gy, gz = plan.grid(m, n)
    assert (gx - 1) * plan.bn < n <= gx * plan.bn
    assert (gy - 1) * plan.bm < m <= gy * plan.bm
    assert gz == plan.splits
    assert plan.k_slice % _cuda.GEMM_BK == 0
    assert (plan.splits - 1) * plan.k_slice < k <= plan.splits * plan.k_slice
    assert (plan.bm, plan.bn) in _cuda.GEMM_BIAS_TILES + ((128, 256), (128, 128))
    if plan.cluster:
        assert plan.splits == 1 and gx % plan.cluster == 0
        if epilogue == "ln":
            assert plan.cluster * plan.bn == n and plan.bm == 128 and plan.cluster <= 8
        else:
            assert plan.cluster == 1
    else:
        assert (plan.bm, plan.bn) == _cuda.GEMM_SPLIT_TILE
        assert plan.partial_floats(m, n) == plan.splits * m * n


def _finer_split_outgrows_the_partial_share(plan, m, k) -> bool:
    """Whether the next shorter whole K slice would write f32 partials past
    GEMM_PARTIAL_SHARE of the weight's bytes (or no shorter slice exists)."""
    per_slice = plan.k_slice // _cuda.GEMM_BK
    if per_slice == 1:
        return True
    finer = -(-k // ((per_slice - 1) * _cuda.GEMM_BK))
    return finer * m * 4 > _cuda.GEMM_PARTIAL_SHARE * k * 2


@pytest.mark.parametrize("m,n,k,epilogue", [c for c in _CASES if c[0] <= 64])
def test_few_rows_put_the_card_on_disjoint_weight_slices(m, n, k, epilogue):
    """At most 64 rows (a decode step) the weight's bytes bound the product:
    one 64-row block of CTAs, each streaming its own (64-column, K-slice) block
    of the weight, at least one per SM, or every 64 x 64 block of the weight
    where it holds fewer than that, unless a finer K split would write more f32
    partials than GEMM_PARTIAL_SHARE of the weight's bytes (a small weight, many
    rows: 63 rows at hd 512 take 64 CTAs)."""
    plan = _cuda.gemm_plan(m, n, k, epilogue)
    blocks = -(-n // 64) * -(-k // 64)
    assert plan.grid(m, n)[1] == 1 and (plan.bm, plan.bn) == _cuda.GEMM_SPLIT_TILE
    assert (plan.ctas(m, n) >= min(_cuda.SM_COUNT, blocks)
            or _finer_split_outgrows_the_partial_share(plan, m, k))
    if m <= 16:
        assert plan.ctas(m, n) >= min(_cuda.SM_COUNT, blocks)


@pytest.mark.parametrize("m,n,k,epilogue", _CASES)
def test_split_partials_stay_within_their_share_of_the_weight(m, n, k, epilogue):
    """A split plan's f32 partial tiles, written once and read once by the
    reduce pass, take at most GEMM_PARTIAL_SHARE of the weight's bf16 bytes;
    a bias product that is not split runs its epilogue in the GEMM."""
    plan = _cuda.gemm_plan(m, n, k, epilogue)
    if plan.splits > 1:
        assert plan.partial_floats(m, n) * 4 <= _cuda.GEMM_PARTIAL_SHARE * n * k * 2
    if epilogue == "bias":
        assert plan.cluster == 1 or plan.splits > 1


@pytest.mark.parametrize("hd,d_ff", WIDTHS)
def test_encode_rows_run_the_epilogues_in_the_gemm(hd, d_ff):
    """At the encode shapes (13,440 and 13,760 rows) every product takes the
    128 x 256 tile with its epilogue in the GEMM (the LayerNorm over a cluster
    of hd / 256 CTAs) and no workspace, and fills the card at least twice."""
    for m in (13440, 13760):
        for n, k, epilogue in _products(hd, d_ff):
            plan = _cuda.gemm_plan(m, n, k, epilogue)
            assert (plan.bm, plan.bn, plan.splits) == (128, 256, 1)
            assert plan.cluster == (hd // 256 if epilogue == "ln" else 1)
            assert plan.partial_floats(m, n) == 0 and plan.ctas(m, n) >= 2 * 60


@pytest.mark.parametrize("m,n,k,epilogue,match", [
    (64, 3072, 770, "bias", "multiples of 8"), (64, 3070, 768, "bias", "multiples of 8"),
    (0, 3072, 768, "bias", "positive"), (64, 3072, 0, "bias", "positive"),
    (64, 640 + 8, 768, "ln", "multiple of 128"), (64, 1152, 768, "ln", "up to 1024"),
    (64, 768, 768, "gelu", "unknown epilogue"),
])
def test_plan_refuses_what_the_kernels_do_not_take(m, n, k, epilogue, match):
    with pytest.raises(ValueError, match=match):
        _cuda.gemm_plan(m, n, k, epilogue)


def test_ffn_wrapper_refuses_a_d_ff_the_tma_maps_cannot_stride(monkeypatch):
    """A d_ff that is not a multiple of 8 is a ValueError before any launch."""
    monkeypatch.setattr(_cuda, "uses_kernel", lambda *tensors: True)
    monkeypatch.setattr(_cuda, "launch", lambda *args: pytest.fail("launched"))
    x = torch.zeros(4, 256)
    w1, w2 = torch.zeros(256, 100, dtype=torch.bfloat16), torch.zeros(100, 256, dtype=torch.bfloat16)
    vec = torch.zeros(256)
    with pytest.raises(ValueError, match="multiple of 8"):
        decode_step.fused_ffn_step(x, w1, torch.zeros(100), w2, vec, vec, vec)


# -- the C entries, emulated on CPU memory ----------------------------------------------
def _view(ptr, n, ctype):
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


def _f32(ptr, *shape):
    return torch.from_numpy(_view(ptr, int(np.prod(shape)), ctypes.c_float).reshape(shape))


def _bf16(ptr, *shape):
    raw = _view(ptr, int(np.prod(shape)), ctypes.c_int16).reshape(shape)
    return torch.from_numpy(raw).view(torch.bfloat16)


def _plan(ints):
    return _cuda.GemmPlan(*ints)


def _check_workspace(partial_ptr, partial_floats, plans_and_shapes):
    """The split route's workspace holds what each plan writes to it."""
    for plan, (m, n) in plans_and_shapes:
        assert plan.partial_floats(m, n) <= partial_floats
    # writable over its whole length
    _view(partial_ptr, partial_floats, ctypes.c_float)[...] = 0.0


def _ln(x, gamma, beta, eps):
    return F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)


def _emulate_ffn(x, w1, b1, w2, b2, gamma, beta, xb, hidden, partial, y, rows, hd, d_ff, *rest,
                 partial_floats):
    plan1, plan2, eps = _plan(rest[:5]), _plan(rest[5:10]), rest[10]
    assert (plan1, plan2) == decode_step.ffn_plans(rows, hd, d_ff)
    _check_workspace(partial, partial_floats, ((plan1, (rows, d_ff)), (plan2, (rows, hd))))
    xv = _f32(x, rows, hd)
    _bf16(xb, rows, hd)[...] = xv.to(torch.bfloat16)
    h = F.gelu(_bf16(xb, rows, hd).float() @ _bf16(w1, hd, d_ff).float() + _f32(b1, d_ff))
    _bf16(hidden, rows, d_ff)[...] = h.to(torch.bfloat16)
    out = _bf16(hidden, rows, d_ff).float() @ _bf16(w2, d_ff, hd).float() + _f32(b2, hd)
    _f32(y, rows, hd)[...] = _ln(xv + out, _f32(gamma, hd), _f32(beta, hd), eps)


def _emulate_encoder(x, wqkv, bqkv, wo, bo, gamma, beta, key_bias, xb, qkv, ctx, partial, y,
                     batch, seq, hd, heads, resident, *rest, partial_floats):
    plan1, plan2, (scale, eps) = _plan(rest[:5]), _plan(rest[5:10]), rest[10:]
    rows = batch * seq
    assert (plan1, plan2) == encoder_layer.encoder_attention_plans(rows, hd)
    d = hd // heads
    assert resident == int(fused_attention.attention_block("encoder", seq, seq, d, d) == "resident")
    _check_workspace(partial, partial_floats, ((plan1, (rows, 3 * hd)), (plan2, (rows, hd))))
    xv = _f32(x, rows, hd)
    _bf16(xb, rows, hd)[...] = xv.to(torch.bfloat16)
    proj = _bf16(xb, rows, hd).float() @ _bf16(wqkv, hd, 3 * hd).float() + _f32(bqkv, 3 * hd)
    _bf16(qkv, rows, 3 * hd)[...] = proj.to(torch.bfloat16)
    q, k, v = (part.float().reshape(batch, seq, heads, d)
               for part in _bf16(qkv, rows, 3 * hd).split(hd, dim=-1))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    weights = torch.softmax(logits + _f32(key_bias, batch, seq)[:, None, None, :], dim=-1)
    context = torch.einsum("bhqk,bkhd->bqhd", weights.to(torch.bfloat16).float(), v)
    _bf16(ctx, rows, hd)[...] = context.reshape(rows, hd).to(torch.bfloat16)
    out = _bf16(ctx, rows, hd).float() @ _bf16(wo, hd, hd).float() + _f32(bo, hd)
    _f32(y, rows, hd)[...] = _ln(xv + out, _f32(gamma, hd), _f32(beta, hd), eps)


@pytest.fixture
def emulated(monkeypatch):
    """Route kernel C's and F's C entries to their emulations; the workspace
    tensor each call allocates is found by its pointer."""
    allocated = {}
    real_empty = torch.empty

    def empty(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        allocated[t.data_ptr()] = t
        return t

    def launch(entry, *args):
        emulate = {"ovq_ffn_forward": (_emulate_ffn, 9),
                   "ovq_encoder_attention_forward": (_emulate_encoder, 11)}[entry]
        fn, partial_index = emulate
        fn(*args, partial_floats=allocated[args[partial_index]].numel())

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(_cuda, "launch", launch)


def _bf16_weight(rng, *shape):
    return torch.from_numpy((rng.normal(size=shape) * 0.05).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("rows,hd,d_ff", [(1, 256, 512), (37, 128, 384), (300, 256, 512),
                                          (640, 128, 256)])
def test_ffn_wrapper_hands_the_entry_its_operands_and_plans(emulated, rows, hd, d_ff):
    """Kernel C's launch, emulated: the plain version's output, the plans of
    ffn_plans, a workspace large enough for the split route."""
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.normal(size=(rows, hd)).astype(np.float32))
    w1, w2 = _bf16_weight(rng, hd, d_ff), _bf16_weight(rng, d_ff, hd)
    b1, b2, beta = (torch.from_numpy(rng.normal(size=n).astype(np.float32) * 0.1)
                    for n in (d_ff, hd, hd))
    gamma = 1 + beta.flip(0)
    args = (x, w1, b1, w2, b2, gamma, beta)
    got = decode_step._ffn_launch(*args, 1e-6)
    want = decode_step.fused_ffn_step_plain(*args)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("b,s,hd,heads", [(3, 1, 128, 2), (5, 13, 256, 4), (4, 70, 256, 2)])
def test_encoder_wrapper_hands_the_entry_its_operands_and_plans(emulated, b, s, hd, heads):
    """Kernel F's launch, emulated: the plain version's output (sample 0 with
    every key masked), the plans of encoder_attention_plans and the block of
    attention_block("encoder", ...)."""
    rng = np.random.default_rng(b * s)
    x = torch.from_numpy(rng.normal(size=(b, s, hd)).astype(np.float32))
    w = {"wqkv": _bf16_weight(rng, hd, 3 * hd), "wo": _bf16_weight(rng, hd, hd)}
    for name, n in (("bqkv", 3 * hd), ("bo", hd), ("ln_bias", hd)):
        w[name] = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 0.1)
    w["ln_scale"] = 1 + w["ln_bias"].flip(0)
    kb = torch.zeros(b, s)
    kb[0] = -10e4
    kb[1:, s // 2 + 1:] = -10e4
    scale = (hd // heads) ** -0.5
    got = encoder_layer._encoder_attention_launch(x, w, kb, scale, heads, 1e-12)
    want = encoder_layer.fused_encoder_self_attention_plain(x, w, kb, scale, heads, 1e-12)
    assert float((got - want).abs().max()) <= 1e-4
