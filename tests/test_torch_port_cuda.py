"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so these tests need an NVIDIA GPU (sm_90a) and
nvcc; elsewhere they skip.  On a machine with the card:

    python -m pytest -m cuda tests/test_torch_port_cuda.py -q

Kernel and plain version see the same bf16 weights and caches; bf16
intermediates may round one ulp apart under another summation order, hence
atol 2e-3 on LayerNorm outputs.  The packed attention has no LayerNorm after
it: a bf16-rounded softmax weight one ulp (2^-8 relative) apart moves its
output by up to 2^-8 * weight * |v|, hence atol 1e-2 there with N(0, 1) inputs.
The dropout attention's kernels and plain versions draw the same Philox mask
from the same seed, so they are compared at rates above 0 too; the forward
leaves the mask as bits for the backward, held against ``dropout_mask_bits``.
"""

import itertools

import pytest
import torch

from openvivqa_tpu_torch.ops import _cuda, decode_step, encoder_layer, fused_attention

pytestmark = pytest.mark.cuda

TOL = 2e-3
ATTN_TOL = 1e-2
HD, HEADS, D_FF = 256, 2, 512
EPS = 1e-12
MASK = -10e4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _attention_weights(gen, hd=HD):
    return {
        "wqkv": _randn(gen, hd, 3 * hd, scale=0.05, dtype=torch.bfloat16),
        "bqkv": _randn(gen, 3 * hd, scale=0.1),
        "wo": _randn(gen, hd, hd, scale=0.05, dtype=torch.bfloat16),
        "bo": _randn(gen, hd, scale=0.1),
        "ln_scale": 1 + _randn(gen, hd, scale=0.1),
        "ln_bias": _randn(gen, hd, scale=0.1),
    }


def _key_bias(gen, bs, n):
    lengths = torch.randint(1, n + 1, (bs,), generator=gen, device="cuda")
    lengths[0] = 0
    return torch.where(torch.arange(n, device="cuda")[None] < lengths[:, None], 0.0, MASK)


def _err(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize("rows", [1, 37, 300])
def test_ffn_kernel_matches_plain(dev, rows):
    gen = torch.Generator(device=dev).manual_seed(rows)
    args = (
        _randn(gen, rows, HD), _randn(gen, HD, D_FF, scale=0.05, dtype=torch.bfloat16),
        _randn(gen, D_FF, scale=0.1), _randn(gen, D_FF, HD, scale=0.05, dtype=torch.bfloat16),
        _randn(gen, HD, scale=0.1), 1 + _randn(gen, HD, scale=0.1), _randn(gen, HD, scale=0.1),
    )
    before = _cuda.launch_counts()["fused_ffn_step"]
    got = decode_step.fused_ffn_step(*args, eps=EPS)
    assert _cuda.launch_counts()["fused_ffn_step"] == before + 1
    assert _err(got, decode_step.fused_ffn_step_plain(*args, eps=EPS)) <= TOL


@pytest.mark.parametrize("seq", [1, 13, 70])
def test_encoder_attention_kernel_matches_plain(dev, seq):
    gen = torch.Generator(device=dev).manual_seed(seq)
    w = _attention_weights(gen)
    x, kb = _randn(gen, 3, seq, HD), _key_bias(gen, 3, seq)
    args = (x, w, kb, 0.125, HEADS, EPS)
    got = encoder_layer.fused_encoder_self_attention(*args)
    assert _err(got, encoder_layer.fused_encoder_self_attention_plain(*args)) <= TOL


# kernel C on gemm_sm90.cu at the main path's widths: each row count of the paths
# (decode steps 1-65, TextBert 640, the MMT encode 64 x 215), so every route of
# the launch plan runs (split K with a reduce pass, tiles with the epilogue in the
# GEMM, the LayerNorm over a cluster).  At these widths the weights take the
# models' own scale, BERT's initializer range of 0.02; at 0.05 kernel and plain
# version lie further apart than TOL, each about as far from float64 as the
# other (test_kernels_at_weight_scale_0_05_lie_as_close_to_float64_as_plain)
_WIDTHS = ((768, 3072), (512, 2048))
_INIT = 0.02


def _ffn_args(gen, rows, hd, d_ff):
    return (
        _randn(gen, rows, hd), _randn(gen, hd, d_ff, scale=_INIT, dtype=torch.bfloat16),
        _randn(gen, d_ff, scale=0.1), _randn(gen, d_ff, hd, scale=_INIT, dtype=torch.bfloat16),
        _randn(gen, hd, scale=0.1), 1 + _randn(gen, hd, scale=0.1), _randn(gen, hd, scale=0.1),
    )


@pytest.mark.parametrize("rows,hd,d_ff", [
    (rows, hd, d_ff) for rows in (1, 37, 63, 64, 65, 300, 640, 13760) for hd, d_ff in _WIDTHS])
def test_ffn_kernel_matches_plain_at_path_widths(dev, rows, hd, d_ff):
    gen = torch.Generator(device=dev).manual_seed(rows + hd)
    args = _ffn_args(gen, rows, hd, d_ff)
    before = _cuda.launch_counts_by_rows()["fused_ffn_step"].get(rows, 0)
    got = decode_step.fused_ffn_step(*args, eps=EPS)
    torch.cuda.synchronize()
    assert _cuda.launch_counts_by_rows()["fused_ffn_step"][rows] == before + 1
    assert _err(got, decode_step.fused_ffn_step_plain(*args, eps=EPS)) <= TOL


@pytest.mark.parametrize("rows", [64, 64 * 10, 64 * 160, 64 * 165])
def test_ffn_kernel_at_the_standalone_m4c_widths(dev, rows):
    """Kernel C at 512 -> 3072 (BertConfig's default intermediate size, which
    the standalone M4C keeps in both stacks): its step rows, question rows,
    context and joint encode rows."""
    gen = torch.Generator(device=dev).manual_seed(rows + 3072)
    args = _ffn_args(gen, rows, 512, 3072)
    got = decode_step.fused_ffn_step(*args, eps=EPS)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _err(got, decode_step.fused_ffn_step_plain(*args, eps=EPS)) <= TOL


# (rows, hd, d_ff) at which ffn_plans takes each route of gemm_plan, and the
# plans it takes there: every GEMM instance the plan reaches, each product's
# epilogue in the GEMM or after a split
_ROUTES = {
    "128x256-cluster3": ((13759, 768, 3072), ((128, 256, 1, 768, 1), (128, 256, 1, 3072, 3))),
    "128x256-cluster3x128": ((5600, 384, 1536), ((128, 256, 1, 384, 1), (128, 128, 1, 1536, 3))),
    "128x128-unsplit-partial": ((1001, 768, 3072), ((128, 128, 1, 768, 1), (64, 64, 1, 3072, 0))),
    "64x128-unsplit-partial": ((640, 768, 3072), ((64, 128, 1, 768, 1), (64, 64, 1, 3072, 0))),
    "64x64-split2": ((300, 768, 3072), ((64, 64, 1, 768, 1), (64, 64, 2, 1536, 0))),
    "split3-split12": ((64, 768, 3072), ((64, 64, 3, 256, 0), (64, 64, 12, 256, 0))),
}


@pytest.mark.parametrize("route", list(_ROUTES))
def test_ffn_kernel_under_every_route_matches_plain(dev, route):
    """Every GEMM instance and route that the launch plan reaches, each at a
    ragged shape where it reaches it: the plan changes the time, not the
    result."""
    (rows, hd, d_ff), plans = _ROUTES[route]
    assert tuple(map(tuple, decode_step.ffn_plans(rows, hd, d_ff))) == plans
    gen = torch.Generator(device=dev).manual_seed(3)
    args = _ffn_args(gen, rows, hd, d_ff)
    got = decode_step.fused_ffn_step(*args, eps=EPS)
    assert _err(got, decode_step.fused_ffn_step_plain(*args, eps=EPS)) <= TOL


def _attention_weights_at(gen, hd, scale):
    return {
        "wqkv": _randn(gen, hd, 3 * hd, scale=scale, dtype=torch.bfloat16),
        "bqkv": _randn(gen, 3 * hd, scale=0.1),
        "wo": _randn(gen, hd, hd, scale=scale, dtype=torch.bfloat16),
        "bo": _randn(gen, hd, scale=0.1),
        "ln_scale": 1 + _randn(gen, hd, scale=0.1),
        "ln_bias": _randn(gen, hd, scale=0.1),
    }


def _f_weights(gen, hd):
    return _attention_weights_at(gen, hd, _INIT)


# kernel F at the paths' geometries: 8 heads of 96 (MMF_M4C's MMT), 12 of 64
# (TextBert), 8 of 64 (the 512-wide models); 64 samples, the first with every key
# masked
@pytest.mark.parametrize("seq,heads,d", [
    (seq, heads, d) for seq in (1, 10, 13, 70, 210, 215) for heads, d in ((8, 96), (12, 64), (8, 64))])
def test_encoder_attention_kernel_matches_plain_at_path_widths(dev, seq, heads, d):
    gen = torch.Generator(device=dev).manual_seed(seq * 100 + d)
    hd = heads * d
    w = _f_weights(gen, hd)
    x, kb = _randn(gen, 64, seq, hd), _key_bias(gen, 64, seq)
    args = (x, w, kb, d ** -0.5, heads, EPS)
    before = _cuda.launch_counts_by_rows()["fused_encoder_self_attention"].get(64 * seq, 0)
    got = encoder_layer.fused_encoder_self_attention(*args)
    torch.cuda.synchronize()
    assert _cuda.launch_counts_by_rows()["fused_encoder_self_attention"][64 * seq] == before + 1
    assert bool(torch.isfinite(got).all())
    assert _err(got, encoder_layer.fused_encoder_self_attention_plain(*args)) <= TOL


@pytest.mark.parametrize("seq,d,block", [
    (13, 64, "resident"), (215, 96, "resident"), (215, 96, "ring"), (273, 96, "ring"),
    (401, 64, "ring"), (1, 128, "resident"), (70, 128, "ring")])
def test_block_b_bf16_instance_matches_plain(dev, seq, d, block):
    """Block B's bf16 instance (kernel F's attention), forced resident or ring,
    inside kernel F under a key bias whose first sample masks every key, against
    F's plain version."""
    gen = torch.Generator(device=dev).manual_seed(seq + d)
    heads = 4
    hd = heads * d
    w = _f_weights(gen, hd)
    x, kb = _randn(gen, 5, seq, hd), _key_bias(gen, 5, seq)
    args = (x, w, kb, d ** -0.5, heads, EPS)
    got = encoder_layer._encoder_attention_launch(*args, block=block)
    assert bool(torch.isfinite(got).all())
    assert _err(got, encoder_layer.fused_encoder_self_attention_plain(*args)) <= TOL


# kernels C and F at the older cases' weight scale, 0.05, at the MMF_M4C widths,
# where kernel and plain version lie further apart than TOL; both are held against
# a float64 evaluation of the same function with the same bf16 operand roundings
# (x, the hidden or q|k|v, the softmax weights, the context), in which only the
# sums are exact.  The errors print with -s.
def _ffn_float64(x, w1, b1, w2, b2, gamma, beta, eps):
    def r(t):
        return t.to(torch.bfloat16).double()

    x64 = x.double()
    hidden = r(torch.nn.functional.gelu(r(x64) @ w1.double() + b1.double()))
    out = hidden @ w2.double() + b2.double()
    return torch.nn.functional.layer_norm(x64 + out, (x.shape[-1],), gamma.double(),
                                          beta.double(), eps)


def _encoder_float64(x, w, kb, scale, heads, eps):
    def r(t):
        return t.to(torch.bfloat16).double()

    b, s, hd = x.shape
    x64 = x.double()
    qkv = r(r(x64) @ w["wqkv"].double() + w["bqkv"].double())
    q, k, v = (part.reshape(b, s, heads, hd // heads) for part in qkv.split(hd, dim=-1))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + kb.double()[:, None, None, :]
    weights = r(torch.softmax(logits, dim=-1))
    context = r(torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, s, hd))
    out = context @ w["wo"].double() + w["bo"].double()
    return torch.nn.functional.layer_norm(x64 + out, (hd,), w["ln_scale"].double(),
                                          w["ln_bias"].double(), eps)


@pytest.mark.parametrize("kernel", ["C", "F"])
def test_kernels_at_weight_scale_0_05_lie_as_close_to_float64_as_plain(dev, kernel):
    """At weight scale 0.05 the bf16 roundings of the operands flip at other
    values under another summation order, and the out projection (768 terms)
    carries a flip into every output column: the kernel is no further from the
    float64 evaluation than the plain version is, to within TOL."""
    gen = torch.Generator(device=dev).manual_seed(5)
    if kernel == "C":
        hd, d_ff, rows = 768, 3072, 64 * 210
        args = (
            _randn(gen, rows, hd), _randn(gen, hd, d_ff, scale=0.05, dtype=torch.bfloat16),
            _randn(gen, d_ff, scale=0.1), _randn(gen, d_ff, hd, scale=0.05, dtype=torch.bfloat16),
            _randn(gen, hd, scale=0.1), 1 + _randn(gen, hd, scale=0.1), _randn(gen, hd, scale=0.1),
        )
        got = decode_step.fused_ffn_step(*args, eps=EPS)
        plain = decode_step.fused_ffn_step_plain(*args, eps=EPS)
        exact = _ffn_float64(*args, EPS)
    else:
        heads, d, seq = 8, 96, 210
        hd = heads * d
        w = _attention_weights_at(gen, hd, 0.05)
        x, kb = _randn(gen, 64, seq, hd), _key_bias(gen, 64, seq)
        args = (x, w, kb, d ** -0.5, heads, EPS)
        got = encoder_layer.fused_encoder_self_attention(*args)
        plain = encoder_layer.fused_encoder_self_attention_plain(*args)
        exact = _encoder_float64(*args)
    errs = {"kernel-plain": _err(got, plain), "kernel-float64": _err(got.double(), exact),
            "plain-float64": _err(plain.double(), exact)}
    print(f"{kernel} at weight scale 0.05: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    assert errs["kernel-float64"] <= errs["plain-float64"] + TOL


# the packed entry's cases: the old shapes (40 rows, head dim 128), then every block
# at each side of its cut-over: the single-query block up to SINGLE_QUERY_MAX_ROWS
# rows, block B resident in shared memory up to the key cut-over (400 keys at d 64,
# 272 at d 96) and streaming past it, 1535 keys at hd 512 over 8 heads; each with a
# bias form (sample 0 of a per-sample bias has every key masked)
_CUT = fused_attention.SINGLE_QUERY_MAX_ROWS["packed"]
_PACKED_BIASES = ("none", "shared keys", "shared full", "per-sample keys", "per-sample full")
_PACKED_CASES = [
    (40, 45, 128, "none"), (40, 45, 128, "shared full"), (40, 45, 128, "per-sample full"),
    (40, 45, 128, "per-sample keys"), (40, 300, 128, "per-sample full"),
] + [
    (sq, sk, d, _PACKED_BIASES[n % len(_PACKED_BIASES)])
    for n, (sq, sk, d) in enumerate(itertools.product(
        (1, _CUT, _CUT + 1), (1, 8, 63, 64, 65, 215, 324, 1601), (64, 96)))
] + [
    (_CUT + 1, 400, 64, "per-sample full"), (_CUT + 1, 401, 64, "per-sample keys"),
    (37, 272, 96, "shared full"), (37, 273, 96, "per-sample full"),
    (64, 1535, 64, "per-sample keys"), (1, 1535, 64, "per-sample keys"),
]


def _bias_of_form(gen, form, bs, sq, sk, heads=1):
    """A bias of the named form; a per-sample one masks every key of sample 0."""
    shapes = {"none": None, "constant": (1, 1, 1, 1), "shared keys": (1, 1, 1, sk),
              "shared full": (1, 1, sq, sk), "per-sample keys": (bs, 1, 1, sk),
              "per-sample full": (bs, 1, sq, sk), "per-head": (bs, heads, sq, sk),
              "per-head keys": (bs, heads, 1, sk), "head keys": (1, heads, 1, sk),
              "head full": (1, heads, sq, sk)}
    shape = shapes[form]
    if shape is None:
        return None
    bias = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.2, MASK, 0.0)
    if form.startswith("per-sample"):
        bias[0] = MASK
    return bias


@pytest.mark.parametrize("sq,sk,d,bias_form", _PACKED_CASES)
def test_packed_attention_kernel_matches_plain(dev, sq, sk, d, bias_form):
    """The packed entry's blocks against the plain version: 1535 keys at hd 512
    over 8 heads, else 2 heads of d; finite, one launch counted."""
    gen = torch.Generator(device=dev).manual_seed(sq + sk + d)
    heads = 8 if sk == 1535 else 2
    hd = heads * d
    q, k, v = _randn(gen, 3, sq, hd), _randn(gen, 3, sk, hd), _randn(gen, 3, sk, hd)
    bias = _bias_of_form(gen, bias_form, 3, sq, sk)
    args = (q, k, v, bias, d ** -0.5, heads)
    before = _cuda.launch_counts()["fused_attention_packed"]
    got = fused_attention.fused_attention_packed(*args)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["fused_attention_packed"] == before + 1
    assert bool(torch.isfinite(got).all())
    assert _err(got, fused_attention.fused_attention_packed_plain(*args)) <= ATTN_TOL


def _prefix_lm_bias(gen, bs, total, ans_len):
    """A (bs, 1, L, L) prefix-LM bias: padded prefix keys per sample, the
    answer block causal, and query row 1 of sample 0 fully masked."""
    lengths = torch.randint(total // 2, total - ans_len + 1, (bs,), generator=gen, device="cuda")
    cols = torch.where(torch.arange(total, device="cuda")[None] < lengths[:, None], 0.0, MASK)
    cols[:, total - ans_len:] = 0.0
    bias = cols[:, None, None, :].expand(bs, 1, total, total).clone()
    bias[:, :, -ans_len:, -ans_len:] = torch.triu(
        torch.full((ans_len, ans_len), MASK, device="cuda"), 1)
    bias[0, :, 1, :] = MASK
    return bias


@pytest.mark.parametrize("bs,total", [(64, 165), (180, 264), (60, 264), (60, 332)])
def test_packed_attention_under_a_prefix_lm_bias(dev, bs, total):
    """The packed entry at the M4C family's joint shapes (hd 512 over 8 heads)
    under a full (b, 1, L, L) prefix-LM bias, read per (sample, query row),
    with a fully masked query row: the standalone M4C's 64 x 165,
    IterativeM4C's beam step over 264 keys (60 and 180 rows) and
    UniqueTransformer's beam step, its encoder over 324 prefix + 8 answer
    keys for 60 rows."""
    gen = torch.Generator(device=dev).manual_seed(bs + total)
    q, k, v = (_randn(gen, bs, total, 512) for _ in range(3))
    bias = _prefix_lm_bias(gen, bs, total, 5)
    args = (q, k, v, bias, 64 ** -0.5, 8)
    got = fused_attention.fused_attention_packed(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _err(got, fused_attention.fused_attention_packed_plain(*args)) <= ATTN_TOL


def test_packed_attention_single_query_over_264_keys(dev):
    """Block A at IterativeM4C's incremental step: 60 rows of one query over
    [259 prefix keys | 5 slots], the unwritten slots and padded keys masked."""
    gen = torch.Generator(device=dev).manual_seed(264)
    q = _randn(gen, 60, 1, 512)
    k, v = (_randn(gen, 60, 264, 512) for _ in range(2))
    bias = _key_bias(gen, 60, 264)
    bias[:, -3:] = MASK
    bias = bias[:, None, None, :].contiguous()
    args = (q, k, v, bias, 64 ** -0.5, 8)
    assert fused_attention.attention_block("packed", 1, 264, 64, 64) == "single"
    got = fused_attention.fused_attention_packed(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _err(got, fused_attention.fused_attention_packed_plain(*args)) <= ATTN_TOL


@pytest.mark.parametrize("sq,sk", [(100, 100), (100, 12), (12, 12), (12, 100), (110, 110),
                                   (100, 1), (1, 1)])
def test_packed_attention_at_classification_shapes(dev, sq, sk):
    """The classification models' encoder attentions (64 samples, 8 heads of
    64 under a per-sample key-padding bias that masks every key of sample 0):
    the regions' self-attention, the regions over the question's keys, the
    question's self-attention, the question over the regions (the
    co-attention models) and [regions | question] over itself
    (VanillaTransformer), plus one key and one row; forward one launch within
    ATTN_TOL of plain, and in training the plain backward's gradients through
    the kernel's autograd function equal to plain's."""
    gen = torch.Generator(device=dev).manual_seed(sq * 1000 + sk)
    heads, d = 8, 64
    q = _randn(gen, 64, sq, heads * d)
    k, v = _randn(gen, 64, sk, heads * d), _randn(gen, 64, sk, heads * d)
    bias = _bias_of_form(gen, "per-sample keys", 64, sq, sk)
    args = (q, k, v, bias, d ** -0.5, heads)
    before = _cuda.launch_counts()["fused_attention_packed"]
    got = fused_attention.fused_attention_packed(*args)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["fused_attention_packed"] == before + 1
    assert bool(torch.isfinite(got).all())
    assert _err(got, fused_attention.fused_attention_packed_plain(*args)) <= ATTN_TOL

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fused_attention.fused_attention_packed(*leaves, *args[3:]).sum().backward()
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fused_attention.fused_attention_packed_plain(*plain, *args[3:]).sum().backward()
    for a, b in zip(leaves, plain):
        assert _err(a.grad, b.grad) <= ATTN_TOL * max(1.0, float(b.grad.abs().max()))


@pytest.mark.parametrize("bs,sq,sk", [(20, 149, 26), (20, 26, 149), (20, 149, 149), (20, 26, 26),
                                      (21, 200, 200), (21, 200, 12), (21, 12, 12)])
def test_packed_attention_at_the_generators_encoder_shapes(dev, bs, sq, sk):
    """The encoder attentions of the VLSP generators and ReadableIterativeMCAN
    at their beam evals' batches (8 heads of 64, a per-sample key-padding bias
    that masks every key of sample 0): the dual-stream models' and
    ExtendedMCAN's 149 vision tokens (100 regions, 49 grids) and 26 question
    tokens for 20 samples, ReadableIterativeMCAN's 200 object + OCR tokens and
    its question for 21; forward one launch within ATTN_TOL of plain, the
    kernel's autograd function's gradients equal to plain's."""
    gen = torch.Generator(device=dev).manual_seed(bs * 100000 + sq * 1000 + sk)
    heads, d = 8, 64
    q = _randn(gen, bs, sq, heads * d)
    k, v = _randn(gen, bs, sk, heads * d), _randn(gen, bs, sk, heads * d)
    bias = _bias_of_form(gen, "per-sample keys", bs, sq, sk)
    args = (q, k, v, bias, d ** -0.5, heads)
    before = _cuda.launch_counts()["fused_attention_packed"]
    got = fused_attention.fused_attention_packed(*args)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["fused_attention_packed"] == before + 1
    assert bool(torch.isfinite(got).all())
    assert _err(got, fused_attention.fused_attention_packed_plain(*args)) <= ATTN_TOL
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fused_attention.fused_attention_packed(*leaves, *args[3:]).sum().backward()
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fused_attention.fused_attention_packed_plain(*plain, *args[3:]).sum().backward()
    for a, b in zip(leaves, plain):
        assert _err(a.grad, b.grad) <= ATTN_TOL * max(1.0, float(b.grad.abs().max()))


@pytest.mark.parametrize("block", ["single", "resident", "ring"])
def test_packed_attention_blocks_agree_at_one_shape(dev, block):
    """Every packed block, forced, at one shape each can take (4 rows, 215
    keys, d 96): the choice changes the time, not the result."""
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v = _randn(gen, 3, 4, 192), _randn(gen, 3, 215, 192), _randn(gen, 3, 215, 192)
    bias = _bias_of_form(gen, "per-sample full", 3, 4, 215)
    got = fused_attention._packed_kernel(q, k, v, bias, 0.1, 2, block=block)
    want = fused_attention.fused_attention_packed_plain(q, k, v, bias, 0.1, 2)
    assert _err(got, want) <= ATTN_TOL


@pytest.mark.parametrize("sq,sk,bias_shape,rate", [
    (40, 45, (3, 1, 40, 45), 0.1), (70, 130, (3, 1, 1, 130), 0.1), (10, 10, (3, 1, 1, 10), 0.1),
    (40, 45, (1, 1, 40, 45), 0.0), (40, 45, None, 0.25),
])
def test_dropout_attention_kernels_match_plain(dev, sq, sk, bias_shape, rate):
    """Forward and backward kernels against the plain versions under the same
    seed, so the same Philox mask: the forward within ATTN_TOL; the gradients
    within 1e-2 of their largest magnitude (each bf16-rounded weight or logit
    gradient may land one ulp, 2^-8 relative, apart under another summation
    order)."""
    gen = torch.Generator(device=dev).manual_seed(sq + sk)
    q, k, v, g = (_randn(gen, 3, s, HD) for s in (sq, sk, sk, sq))
    bias = None
    if bias_shape is not None:
        bias = torch.where(torch.rand(bias_shape, generator=gen, device=dev) < 0.2, MASK, 0.0)
    seed = torch.tensor([20260], dtype=torch.int64, device=dev)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = _cuda.launch_counts()
    out = fused_attention.fused_attention_packed_dropout(*leaves, bias, seed, 0.125, HEADS, rate)
    (out * g).sum().backward()
    after = _cuda.launch_counts()
    for name in ("fused_attention_packed_dropout", "fused_attention_packed_dropout_backward"):
        assert after[name] == before[name] + 1, name
    plain = fused_attention.fused_attention_packed_dropout_plain(
        q, k, v, bias, seed, 0.125, HEADS, rate)
    assert _err(out.detach(), plain) <= ATTN_TOL
    grads = fused_attention.fused_attention_packed_dropout_backward_plain(
        q, k, v, bias, seed, g, 0.125, HEADS, rate)
    for leaf, want in zip(leaves, grads):
        assert _err(leaf.grad, want) <= 1e-2 * float(want.abs().max())


@pytest.mark.parametrize("case", ["cross 5x210", "causal 5x5"])
def test_dropout_attention_kernels_at_decoder_shapes(dev, case):
    """The Iterative M4C decoder's training shapes at its widths (hidden 512, 8
    heads): the cross-attention's 5 queries over 210 encoder keys under a
    key-only bias, and the causal 5 x 5 self-attention under a shared (1, 1,
    5, 5) bias; one q-tile and one partial key tile in the kernels' 64-row
    tiling.  Tolerances as in test_dropout_attention_kernels_match_plain."""
    hd, heads, bs = 512, 8, 64
    gen = torch.Generator(device=dev).manual_seed(11)
    sk = 210 if case.startswith("cross") else 5
    q, g = _randn(gen, bs, 5, hd), _randn(gen, bs, 5, hd)
    k, v = _randn(gen, bs, sk, hd), _randn(gen, bs, sk, hd)
    if sk == 5:
        bias = torch.triu(torch.full((5, 5), MASK, device=dev), 1)[None, None]
    else:
        bias = _key_bias(gen, bs, sk)[:, None, None, :]
        bias[0] = 0.0  # _key_bias masks every key of sample 0
    seed = torch.tensor([4242], dtype=torch.int64, device=dev)
    scale = 1.0 / (hd // heads) ** 0.5
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fused_attention.fused_attention_packed_dropout(*leaves, bias, seed, scale, heads, 0.1)
    (out * g).sum().backward()
    plain = fused_attention.fused_attention_packed_dropout_plain(q, k, v, bias, seed, scale, heads, 0.1)
    assert _err(out.detach(), plain) <= ATTN_TOL
    grads = fused_attention.fused_attention_packed_dropout_backward_plain(
        q, k, v, bias, seed, g, scale, heads, 0.1)
    for leaf, want in zip(leaves, grads):
        assert _err(leaf.grad, want) <= 1e-2 * float(want.abs().max())


@pytest.mark.parametrize("bs,total", [(16, 165)])
def test_dropout_attention_under_a_prefix_lm_bias(dev, bs, total):
    """The dropout pair at the standalone M4C's training shape (a train batch
    of 16 over its joint 165, hd 512 over 8 heads of 64) under a full (b, 1,
    L, L) prefix-LM bias with a fully masked query row: the keep bits equal
    to dropout_mask_bits; tolerances as in
    test_dropout_attention_kernels_match_plain."""
    hd, heads = 512, 8
    gen = torch.Generator(device=dev).manual_seed(bs * total)
    q, k, v, g = (_randn(gen, bs, total, hd) for _ in range(4))
    bias = _prefix_lm_bias(gen, bs, total, 5)
    seed = torch.tensor([165], dtype=torch.int64, device=dev)
    scale = 1.0 / (hd // heads) ** 0.5
    _, _, bits = fused_attention._dropout_forward_kernel(q, k, v, bias, seed, scale, heads, 0.1)
    assert torch.equal(bits, fused_attention.dropout_mask_bits(seed, bs, heads, total, total, 0.1))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fused_attention.fused_attention_packed_dropout(*leaves, bias, seed, scale, heads, 0.1)
    (out * g).sum().backward()
    assert bool(torch.isfinite(out).all())
    plain = fused_attention.fused_attention_packed_dropout_plain(q, k, v, bias, seed, scale, heads, 0.1)
    assert _err(out.detach(), plain) <= ATTN_TOL
    grads = fused_attention.fused_attention_packed_dropout_backward_plain(
        q, k, v, bias, seed, g, scale, heads, 0.1)
    for leaf, want in zip(leaves, grads):
        assert _err(leaf.grad, want) <= 1e-2 * float(want.abs().max())


def _rate0_case(dev):
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (_randn(gen, 3, 40, HD) for _ in range(3))
    bias = torch.where(torch.rand(3, 1, 40, 40, generator=gen, device=dev) < 0.2, MASK, 0.0)
    seed = torch.zeros(1, dtype=torch.int64, device=dev)
    got = fused_attention.fused_attention_packed_dropout(q, k, v, bias, seed, 0.125, HEADS, 0.0)
    return got, (q, k, v, bias, 0.125, HEADS)


def test_dropout_attention_at_rate0_is_the_packed_kernel(dev):
    """At rate 0 the dropout forward agrees with the packed entry through their
    public wrappers, within ATTN_TOL (both run block B here, and
    test_dropout_attention_at_rate0_is_block_b holds each form bit for bit)."""
    got, args = _rate0_case(dev)
    assert _err(got, fused_attention.fused_attention_packed(*args)) <= ATTN_TOL


@pytest.mark.parametrize("block", ["resident", "ring"])
def test_dropout_attention_at_rate0_is_block_b(dev, block):
    """At rate 0 the dropout forward is block B without a mask, bit for bit,
    in either form: every keep factor is 1, and a weight times 1 is itself."""
    _, (q, k, v, bias, scale, heads) = _rate0_case(dev)
    seed = torch.zeros(1, dtype=torch.int64, device=dev)
    got, _, bits = fused_attention._dropout_forward_kernel(q, k, v, bias, seed, scale, heads, 0.0,
                                                          block=block)
    assert torch.equal(got, fused_attention._packed_kernel(q, k, v, bias, scale, heads, block=block))
    assert torch.equal(bits, fused_attention.dropout_mask_bits(seed, 3, heads, 40, 40, 0.0))


# the dropout entries on each side of attention_block's resident limit, at d 96
# (272 keys resident, 273 in the ring) and d 64 (400 / 401), with Q and G past it
# for kernel 2 (273 query rows at d 96), the decoder's 5 rows and one row; sample
# 0 of a per-sample bias masks every key, so its rows are fully masked
_DROPOUT_CASES = [
    (37, 272, 96, "per-sample full"), (37, 273, 96, "per-sample full"),
    (20, 400, 64, "shared keys"), (20, 401, 64, "per-sample keys"),
    (273, 30, 96, "shared full"), (5, 210, 64, "per-sample keys"), (1, 8, 64, "none"),
]


@pytest.mark.parametrize("sq,sk,d,bias_form", _DROPOUT_CASES)
def test_dropout_attention_kernels_on_both_sides_of_the_cut_over(dev, sq, sk, d, bias_form):
    """Forward (resident or ring) and backward (each kernel resident or in the
    ring) against the plain versions under one seed, 2 heads of d; finite;
    tolerances as in test_dropout_attention_kernels_match_plain."""
    gen = torch.Generator(device=dev).manual_seed(sq * 7 + sk + d)
    heads = 2
    q, g = _randn(gen, 3, sq, heads * d), _randn(gen, 3, sq, heads * d)
    k, v = _randn(gen, 3, sk, heads * d), _randn(gen, 3, sk, heads * d)
    bias = _bias_of_form(gen, bias_form, 3, sq, sk)
    seed = torch.tensor([777 + sk], dtype=torch.int64, device=dev)
    scale = d ** -0.5
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fused_attention.fused_attention_packed_dropout(*leaves, bias, seed, scale, heads, 0.1)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    plain = fused_attention.fused_attention_packed_dropout_plain(q, k, v, bias, seed, scale, heads, 0.1)
    assert _err(out.detach(), plain) <= ATTN_TOL
    grads = fused_attention.fused_attention_packed_dropout_backward_plain(
        q, k, v, bias, seed, g, scale, heads, 0.1)
    for leaf, want in zip(leaves, grads):
        assert bool(torch.isfinite(leaf.grad).all())
        assert _err(leaf.grad, want) <= 1e-2 * float(want.abs().max())


@pytest.mark.parametrize("block", ["resident", "ring"])
def test_dropout_forward_mask_bits_match_plain(dev, block):
    """The forward's keep bits and stats: bits equal to dropout_mask_bits (215
    keys, not a multiple of 32, at rate 0.1); stats each row's max and 1 /
    denominator of its logits within 1e-4 of their largest magnitude (the
    logits are float32 sums in another order; a batch-shared bias without a
    fully masked row, where a logit near -1e5 keeps only 2^-7 of precision)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    b, sq, sk, heads, d = 3, 50, 215, 2, 96
    q, k, v = _randn(gen, b, sq, heads * d), _randn(gen, b, sk, heads * d), _randn(gen, b, sk, heads * d)
    bias = _bias_of_form(gen, "shared full", b, sq, sk)
    seed = torch.tensor([2 ** 40 + 17], dtype=torch.int64, device=dev)
    _, stats, bits = fused_attention._dropout_forward_kernel(q, k, v, bias, seed, 0.1, heads, 0.1,
                                                            block=block)
    assert torch.equal(bits, fused_attention.dropout_mask_bits(seed, b, heads, sq, sk, 0.1))
    rt = lambda x, s: x.to(torch.bfloat16).float().view(b, s, heads, d)  # noqa: E731
    logits = torch.einsum("bqhd,bkhd->bhqk", rt(q, sq), rt(k, sk)) * 0.1 + bias
    row_max = logits.max(dim=-1).values
    inv_sum = 1.0 / torch.exp(logits - row_max[..., None]).sum(dim=-1)
    assert _err(stats[..., 0], row_max) <= 1e-4 * float(row_max.abs().max())
    assert _err(stats[..., 1], inv_sum) <= 1e-4 * float(inv_sum.abs().max())


@pytest.mark.parametrize("hd,heads,bs,ctx_len,n_slots", [
    (HD, HEADS, 5, 77, 4),
    # MMF_M4C's MMT: 8 heads of 96 (the step kernel's 128 instance with a partial
    # head block), 64 rows, an odd context
    (768, 8, 64, 211, 5),
    (768, 8, 3, 1, 3),
    # the standalone M4C's joint encoder: 8 heads of 64 over its 160-key context
    (512, 8, 64, 160, 5),
])
def test_bert_self_step_kernel_matches_plain(dev, hd, heads, bs, ctx_len, n_slots):
    """Kernel D over T + 2 steps (the last two overwrite the last slot, as the
    JAX clamp does), one launch a call, output and in-place slots against the
    plain version on its own slots (each slot within one bf16 ulp of the
    plain one: the two round f32 sums taken in other orders); sample 0's
    context fully padded (its softmax then runs over the slots alone)."""
    gen = torch.Generator(device=dev).manual_seed(4 + hd + ctx_len)
    w = _attention_weights(gen, hd)
    ctx = tuple(_randn(gen, bs, ctx_len, hd, dtype=torch.bfloat16) for _ in range(2))
    cb = _key_bias(gen, bs, ctx_len)
    slots = {n: [torch.zeros(bs, n_slots, hd, dtype=torch.bfloat16, device=dev) for _ in "kv"]
             for n in ("kernel", "plain")}
    scale = (hd // heads) ** -0.5
    for step in range(n_slots + 2):
        x = _randn(gen, bs, hd)
        before = _cuda.launch_counts()["fused_bert_self_step"]
        got, *_ = decode_step.fused_bert_self_step(
            x, w, ctx, *slots["kernel"], step, cb, scale, heads, EPS)
        assert _cuda.launch_counts()["fused_bert_self_step"] == before + 1
        want, *_ = decode_step.fused_bert_self_step_plain(
            x, w, ctx, *slots["plain"], step, cb, scale, heads, EPS)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert _err(got, want) <= TOL
        for a, b in zip(slots["kernel"], slots["plain"]):
            a, b = a.float(), b.float()
            if hd == HD:
                assert _err(a, b) <= 1e-2  # one bf16 ulp at |k| in [1, 2)
            # one bf16 ulp of the stored value at any magnitude (|k| reaches [2, 8)
            # at hd 768, where an ulp is 2^-6 or 2^-5)
            assert float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) <= 2.0 ** -7


STEP_ROWS, STEP_T, STEP_SK = 63, 5, 77


def _cross_weights(gen):
    w = _attention_weights(gen)
    return {"wq": w["wqkv"][:, :HD].contiguous(), "bq": w["bqkv"][:HD].contiguous(),
            **{k: w[k] for k in ("wo", "bo", "ln_scale", "ln_bias")}}


def _ffn_weights(gen):
    return {
        "w1": _randn(gen, HD, D_FF, scale=0.05, dtype=torch.bfloat16), "b1": _randn(gen, D_FF, scale=0.1),
        "w2": _randn(gen, D_FF, HD, scale=0.05, dtype=torch.bfloat16), "b2": _randn(gen, HD, scale=0.1),
        "ln_scale": 1 + _randn(gen, HD, scale=0.1), "ln_bias": _randn(gen, HD, scale=0.1),
    }


def _rings(dtype, dev):
    """Two equal rings (kernel's and plain's): keys, values, bias."""
    return {n: [torch.zeros(STEP_ROWS, STEP_T, HD, dtype=dtype, device=dev),
                torch.zeros(STEP_ROWS, STEP_T, HD, dtype=dtype, device=dev),
                torch.zeros(STEP_ROWS, STEP_T, device=dev)] for n in ("kernel", "plain")}


def _step_bias(gen, dev):
    """Some rows' current token is padding."""
    return torch.where(torch.rand(STEP_ROWS, generator=gen, device=dev) < 0.2, MASK, 0.0)


def _reorder(rings, gen, dev):
    """What beam search does between steps: rows take other rows' histories."""
    perm = torch.randint(0, STEP_ROWS, (STEP_ROWS,), generator=gen, device=dev)
    for name in rings:
        rings[name] = [x.index_select(0, perm) for x in rings[name]]


def _ring_err(rings):
    return max(_err(a.float(), b.float()) for a, b in zip(rings["kernel"], rings["plain"]))


@pytest.mark.parametrize("ring_dtype", [torch.float32, torch.bfloat16])
def test_self_attention_step_kernel_matches_plain(dev, ring_dtype):
    """Kernel A over T + 2 steps (the last two clamp to the last slot) on 63
    rows with padded tokens and a reorder of the ring between steps.  The f32
    ring holds the GEMM's f32 sums, equal to the plain version's up to
    summation order (1e-4); a bf16 ring may round one ulp apart (1e-2)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    w = _attention_weights(gen)
    rings = _rings(ring_dtype, dev)
    for step in range(STEP_T + 2):
        x, sb = _randn(gen, STEP_ROWS, HD), _step_bias(gen, dev)
        before = _cuda.launch_counts()["fused_self_attention_step"]
        got, *same = decode_step.fused_self_attention_step(
            x, w, sb, step, *rings["kernel"], 0.125, HEADS, 1e-6)
        assert _cuda.launch_counts()["fused_self_attention_step"] == before + 1
        assert all(a is b for a, b in zip(same, rings["kernel"]))  # written in place
        want, *_ = decode_step.fused_self_attention_step_plain(
            x, w, sb, step, *rings["plain"], 0.125, HEADS, 1e-6)
        assert _err(got, want) <= TOL
        assert _ring_err(rings) <= (1e-4 if ring_dtype == torch.float32 else 1e-2)
        # both sides go on from one ring, so that a one-ulp difference in a
        # stored key is not carried into the next step's comparison
        rings["plain"] = [x.clone() for x in rings["kernel"]]
        _reorder(rings, gen, dev)


@pytest.mark.parametrize("enc_dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_step_kernel_matches_plain(dev, enc_dtype):
    gen = torch.Generator(device=dev).manual_seed(7)
    w = _cross_weights(gen)
    x = _randn(gen, STEP_ROWS, HD)
    enc_k, enc_v = (_randn(gen, STEP_ROWS, STEP_SK, HD, dtype=enc_dtype) for _ in range(2))
    eb = _key_bias(gen, STEP_ROWS, STEP_SK)  # row 0 has every key masked
    got = decode_step.fused_cross_attention_step(x, w, enc_k, enc_v, eb, 0.125, HEADS)
    want = decode_step.fused_cross_attention_step_plain(x, w, enc_k, enc_v, eb, 0.125, HEADS)
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("rows,sk,hd,heads,enc_dtype", [
    (STEP_ROWS, STEP_SK, HD, HEADS, torch.float32),
    (STEP_ROWS, STEP_SK, HD, HEADS, torch.bfloat16),
    (64, 210, 512, 8, torch.bfloat16),  # the Iterative M4C decode step
])
def test_cross_attention_streamed_kernel_matches_plain(dev, rows, sk, hd, heads, enc_dtype):
    """Kernel E at the BertLayer eps of 1e-12, with a row whose keys are all
    masked, counted by its own launch counter and not kernel B's."""
    gen = torch.Generator(device=dev).manual_seed(12)
    w = {"wq": _randn(gen, hd, hd, scale=0.05, dtype=torch.bfloat16),
         "bq": _randn(gen, hd, scale=0.1),
         "wo": _randn(gen, hd, hd, scale=0.05, dtype=torch.bfloat16),
         "bo": _randn(gen, hd, scale=0.1),
         "ln_scale": 1 + _randn(gen, hd, scale=0.1), "ln_bias": _randn(gen, hd, scale=0.1)}
    x = _randn(gen, rows, hd)
    kv = tuple(_randn(gen, rows, sk, hd, dtype=enc_dtype) for _ in range(2))
    eb = _key_bias(gen, rows, sk)
    scale = 1.0 / (hd // heads) ** 0.5
    before = _cuda.launch_counts()
    got = decode_step.fused_cross_attention_streamed(x, w, kv, eb, scale, heads, EPS)
    after = _cuda.launch_counts()
    assert after["fused_cross_attention_streamed"] == before["fused_cross_attention_streamed"] + 1
    assert after["fused_cross_attention_step"] == before["fused_cross_attention_step"]
    want = decode_step.fused_cross_attention_streamed_plain(x, w, kv, eb, scale, heads, EPS)
    assert _err(got, want) <= TOL
    with pytest.raises(ValueError, match="float32"):
        decode_step.fused_cross_attention_streamed(x, w, kv, eb.double(), scale, heads, EPS)
    with pytest.raises(ValueError, match="shape"):
        decode_step.fused_cross_attention_streamed(x, w, kv, eb[:, :-1], scale, heads, EPS)


LAYER_TOL = 1e-2


def test_decoder_layer_step_kernel_matches_its_stages_and_plain(dev):
    """The layer step is kernels A, B and C chained in one call: bit-equal to
    calling the three stage kernels in turn.  Against the plain version its
    LayerNorm output is compared at 1e-2, not the single sublayers' 2e-3: each
    sublayer's output is rounded to bf16 on its way into the next product, so
    float32 sums that differ in their last bits may round one bf16 ulp (7.8e-3
    at 1) apart there, and the difference is carried through two more
    sublayers."""
    gen = torch.Generator(device=dev).manual_seed(9)
    self_w, cross_w, ffn_w = _attention_weights(gen), _cross_weights(gen), _ffn_weights(gen)
    enc_k, enc_v = (_randn(gen, STEP_ROWS, STEP_SK, HD, dtype=torch.bfloat16) for _ in range(2))
    eb = _key_bias(gen, STEP_ROWS, STEP_SK)
    rings = _rings(torch.float32, dev)
    rings["staged"] = [x.clone() for x in rings["kernel"]]
    f = ffn_w
    for step in range(STEP_T + 1):
        x, sb = _randn(gen, STEP_ROWS, HD), _step_bias(gen, dev)
        got, *_ = decode_step.fused_decoder_layer_step(
            x, self_w, cross_w, ffn_w, sb, step, *rings["kernel"], enc_k, enc_v, eb, 0.125, HEADS)
        staged, *_ = decode_step.fused_self_attention_step(
            x, self_w, sb, step, *rings["staged"], 0.125, HEADS)
        staged = decode_step.fused_cross_attention_step(
            staged, cross_w, enc_k, enc_v, eb, 0.125, HEADS)
        staged = decode_step.fused_ffn_step(
            staged, f["w1"], f["b1"], f["w2"], f["b2"], f["ln_scale"], f["ln_bias"])
        assert torch.equal(got, staged)
        assert all(torch.equal(a, b) for a, b in zip(rings["kernel"], rings["staged"]))
        want, *_ = decode_step.fused_decoder_layer_step_plain(
            x, self_w, cross_w, ffn_w, sb, step, *rings["plain"], enc_k, enc_v, eb, 0.125, HEADS)
        assert _err(got, want) <= LAYER_TOL
        assert _ring_err({k: rings[k] for k in ("kernel", "plain")}) <= 1e-4
        rings["plain"] = [x.clone() for x in rings["kernel"]]
        _reorder(rings, gen, dev)


@pytest.mark.parametrize("rows,sk,t_len,ring_dtype", [
    (60, 324, 8, torch.float32),  # JointTransformer's beam step
    (64, 110, 5, torch.bfloat16),  # greedy rows over a bf16 ring
    (63, 101, 5, torch.float32),  # IterativeSAAA: 100 regions + the question state
    (60, 175, 8, torch.float32),  # the dual-stream generators and ExtendedMCAN
    (63, 210, 5, torch.float32),  # ReadableIterativeMCAN: 200 object + OCR tokens, question
])
def test_decoder_layer_step_at_path_shapes_matches_its_stages(dev, rows, sk, t_len, ring_dtype):
    """The persistent layer step at hd 512, 8 heads, d_ff 2048: bit-equal to
    kernels A, B and C chained over T + 1 steps with the ring reordered between
    them, within LAYER_TOL of the plain version; one launch a call."""
    gen = torch.Generator(device=dev).manual_seed(rows + sk)
    hd, heads, d_ff = 512, 8, 2048
    self_w = {"wqkv": _randn(gen, hd, 3 * hd, scale=0.02, dtype=torch.bfloat16),
              "bqkv": _randn(gen, 3 * hd, scale=0.1),
              **_step_vectors(gen, hd)}
    cross_w = {"wq": _randn(gen, hd, hd, scale=0.02, dtype=torch.bfloat16),
               "bq": _randn(gen, hd, scale=0.1), **_step_vectors(gen, hd)}
    f = {"w1": _randn(gen, hd, d_ff, scale=0.02, dtype=torch.bfloat16), "b1": _randn(gen, d_ff, scale=0.1),
         "w2": _randn(gen, d_ff, hd, scale=0.02, dtype=torch.bfloat16), "b2": _randn(gen, hd, scale=0.1),
         "ln_scale": 1 + _randn(gen, hd, scale=0.1), "ln_bias": _randn(gen, hd, scale=0.1)}
    enc_k, enc_v = (_randn(gen, rows, sk, hd, dtype=torch.bfloat16) for _ in range(2))
    eb = _key_bias(gen, rows, sk)
    scale = (hd // heads) ** -0.5
    ring = [torch.zeros(rows, t_len, hd, dtype=ring_dtype, device=dev),
            torch.zeros(rows, t_len, hd, dtype=ring_dtype, device=dev),
            torch.zeros(rows, t_len, device=dev)]
    rings = {"kernel": ring, "staged": [x.clone() for x in ring], "plain": [x.clone() for x in ring]}
    for step in range(t_len + 1):
        x = _randn(gen, rows, hd)
        sb = torch.where(torch.rand(rows, generator=gen, device=dev) < 0.2, MASK, 0.0)
        before = _cuda.launch_counts()["fused_decoder_layer_step"]
        got, *_ = decode_step.fused_decoder_layer_step(
            x, self_w, cross_w, f, sb, step, *rings["kernel"], enc_k, enc_v, eb, scale, heads)
        assert _cuda.launch_counts()["fused_decoder_layer_step"] == before + 1
        staged, *_ = decode_step.fused_self_attention_step(
            x, self_w, sb, step, *rings["staged"], scale, heads)
        staged = decode_step.fused_cross_attention_step(staged, cross_w, enc_k, enc_v, eb, scale,
                                                        heads)
        staged = decode_step.fused_ffn_step(
            staged, f["w1"], f["b1"], f["w2"], f["b2"], f["ln_scale"], f["ln_bias"])
        assert torch.equal(got, staged)
        assert all(torch.equal(a, b) for a, b in zip(rings["kernel"], rings["staged"]))
        want, *_ = decode_step.fused_decoder_layer_step_plain(
            x, self_w, cross_w, f, sb, step, *rings["plain"], enc_k, enc_v, eb, scale, heads)
        assert _err(got, want) <= LAYER_TOL
        rings["plain"] = [x.clone() for x in rings["kernel"]]
        perm = torch.randint(0, rows, (rows,), generator=gen, device=dev)
        rings = {name: [x.index_select(0, perm) for x in value] for name, value in rings.items()}


@pytest.mark.parametrize("rows,hd,heads", [(600, 512, 8), (330, 768, 12)])
def test_decoder_layer_step_past_kernel_cs_split_route(dev, rows, hd, heads):
    """At a row count where kernel C leaves its 64 x 64 split route (an eval or
    SCST batch of 200 x beam 3; 330 rows at hd 768) the layer step still runs in
    one launch: its ring equal to kernels A and B's, its output within LN_TOL of
    A, B, C chained and within LAYER_TOL of the plain version."""
    gen = torch.Generator(device=dev).manual_seed(rows + hd)
    d_ff, sk, t_len = 4 * hd, 110, 5
    self_w = {"wqkv": _randn(gen, hd, 3 * hd, scale=0.02, dtype=torch.bfloat16),
              "bqkv": _randn(gen, 3 * hd, scale=0.1), **_step_vectors(gen, hd)}
    cross_w = {"wq": _randn(gen, hd, hd, scale=0.02, dtype=torch.bfloat16),
               "bq": _randn(gen, hd, scale=0.1), **_step_vectors(gen, hd)}
    f = {"w1": _randn(gen, hd, d_ff, scale=0.02, dtype=torch.bfloat16), "b1": _randn(gen, d_ff, scale=0.1),
         "w2": _randn(gen, d_ff, hd, scale=0.02, dtype=torch.bfloat16), "b2": _randn(gen, hd, scale=0.1),
         "ln_scale": 1 + _randn(gen, hd, scale=0.1), "ln_bias": _randn(gen, hd, scale=0.1)}
    enc_k, enc_v = (_randn(gen, rows, sk, hd, dtype=torch.bfloat16) for _ in range(2))
    eb = _key_bias(gen, rows, sk)
    scale = (hd // heads) ** -0.5
    ring = [_randn(gen, rows, t_len, hd), _randn(gen, rows, t_len, hd),
            torch.where(torch.rand(rows, t_len, generator=gen, device=dev) < 0.2, MASK, 0.0)]
    rings = {"kernel": ring, "staged": [x.clone() for x in ring], "plain": [x.clone() for x in ring]}
    x = _randn(gen, rows, hd)
    sb = torch.where(torch.rand(rows, generator=gen, device=dev) < 0.2, MASK, 0.0)
    before = _cuda.launch_counts()["fused_decoder_layer_step"]
    got, *_ = decode_step.fused_decoder_layer_step(
        x, self_w, cross_w, f, sb, 2, *rings["kernel"], enc_k, enc_v, eb, scale, heads)
    assert _cuda.launch_counts()["fused_decoder_layer_step"] == before + 1
    staged, *_ = decode_step.fused_self_attention_step(
        x, self_w, sb, 2, *rings["staged"], scale, heads)
    staged = decode_step.fused_cross_attention_step(staged, cross_w, enc_k, enc_v, eb, scale, heads)
    staged = decode_step.fused_ffn_step(
        staged, f["w1"], f["b1"], f["w2"], f["b2"], f["ln_scale"], f["ln_bias"])
    assert all(torch.equal(a, b) for a, b in zip(rings["kernel"], rings["staged"]))
    assert _err(got, staged) <= TOL
    want, *_ = decode_step.fused_decoder_layer_step_plain(
        x, self_w, cross_w, f, sb, 2, *rings["plain"], enc_k, enc_v, eb, scale, heads)
    assert _err(got, want) <= LAYER_TOL
    assert _ring_err({k: rings[k] for k in ("kernel", "plain")}) <= 1e-4


@pytest.mark.parametrize("hd,heads", [(384, 32), (384, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_kernels_at_a_head_dim_off_the_16_byte_grain(dev, hd, heads, dtype):
    """Kernels A and B at head dims 12 and 3, whose rows the attention phases
    read element by element: within TOL of the plain version, A's ring within
    1e-4 (f32) or 1e-2 (bf16)."""
    gen = torch.Generator(device=dev).manual_seed(hd + heads)
    rows, t_len, sk = 37, 5, 45
    self_w = {"wqkv": _randn(gen, hd, 3 * hd, scale=0.05, dtype=torch.bfloat16),
              "bqkv": _randn(gen, 3 * hd, scale=0.1), **_step_vectors(gen, hd)}
    cross_w = {"wq": _randn(gen, hd, hd, scale=0.05, dtype=torch.bfloat16),
               "bq": _randn(gen, hd, scale=0.1), **_step_vectors(gen, hd)}
    scale = (hd // heads) ** -0.5
    ring = [_randn(gen, rows, t_len, hd, dtype=dtype), _randn(gen, rows, t_len, hd, dtype=dtype),
            torch.zeros(rows, t_len, device=dev)]
    rings = {"kernel": ring, "plain": [x.clone() for x in ring]}
    x = _randn(gen, rows, hd)
    sb = torch.where(torch.rand(rows, generator=gen, device=dev) < 0.2, MASK, 0.0)
    got, *_ = decode_step.fused_self_attention_step(x, self_w, sb, 3, *rings["kernel"], scale, heads)
    want, *_ = decode_step.fused_self_attention_step_plain(
        x, self_w, sb, 3, *rings["plain"], scale, heads)
    assert _err(got, want) <= TOL
    assert _ring_err(rings) <= (1e-4 if dtype == torch.float32 else 1e-2)
    enc_k, enc_v = (_randn(gen, rows, sk, hd, dtype=dtype) for _ in range(2))
    eb = _key_bias(gen, rows, sk)
    got = decode_step.fused_cross_attention_step(x, cross_w, enc_k, enc_v, eb, scale, heads)
    want = decode_step.fused_cross_attention_step_plain(x, cross_w, enc_k, enc_v, eb, scale, heads)
    assert _err(got, want) <= TOL


def _step_vectors(gen, hd):
    return {"wo": _randn(gen, hd, hd, scale=0.02, dtype=torch.bfloat16),
            "bo": _randn(gen, hd, scale=0.1), "ln_scale": 1 + _randn(gen, hd, scale=0.1),
            "ln_bias": _randn(gen, hd, scale=0.1)}


def test_step_kernel_refused_cooperative_launch_is_an_error(dev, monkeypatch):
    """A grid larger than the card holds at once is refused by the cooperative
    launch; the wrapper raises and counts no launch."""
    gen = torch.Generator(device=dev).manual_seed(13)
    w = _cross_weights(gen)
    x = _randn(gen, STEP_ROWS, HD)
    enc_k, enc_v = (_randn(gen, STEP_ROWS, STEP_SK, HD, dtype=torch.bfloat16) for _ in range(2))
    eb = _key_bias(gen, STEP_ROWS, STEP_SK)
    real_plan = decode_step.step_plan

    def too_many(*args):
        return real_plan(*args)._replace(ctas=64 * real_plan(*args).ctas)

    monkeypatch.setattr(decode_step, "step_plan", too_many)
    before = _cuda.launch_counts()["fused_cross_attention_step"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        decode_step.fused_cross_attention_step(x, w, enc_k, enc_v, eb, 0.125, HEADS)
    assert _cuda.launch_counts()["fused_cross_attention_step"] == before
    monkeypatch.setattr(decode_step, "step_plan", real_plan)
    got = decode_step.fused_cross_attention_step(x, w, enc_k, enc_v, eb, 0.125, HEADS)
    want = decode_step.fused_cross_attention_step_plain(x, w, enc_k, enc_v, eb, 0.125, HEADS)
    assert _err(got, want) <= TOL


def test_step_wrappers_refuse_a_wrong_dtype_and_a_non_contiguous_tensor(dev):
    """A CUDA input to kernels A, B or the layer step launches the kernel or
    raises ValueError; nothing falls back to the plain version."""
    gen = torch.Generator(device=dev).manual_seed(10)
    self_w, cross_w, ffn_w = _attention_weights(gen), _cross_weights(gen), _ffn_weights(gen)
    x, sb = _randn(gen, STEP_ROWS, HD), _step_bias(gen, dev)
    ring = _rings(torch.float32, dev)["kernel"]
    enc_k, enc_v = (_randn(gen, STEP_ROWS, STEP_SK, HD, dtype=torch.bfloat16) for _ in range(2))
    eb = _key_bias(gen, STEP_ROWS, STEP_SK)
    f32_w = dict(self_w, wqkv=self_w["wqkv"].float())
    strided_ring = [torch.zeros(STEP_ROWS, STEP_T, 2 * HD, device=dev)[:, :, :HD], *ring[1:]]
    strided_enc = _randn(gen, STEP_ROWS, STEP_SK, 2 * HD, dtype=torch.bfloat16)[:, :, :HD]
    counts = _cuda.launch_counts()
    with pytest.raises(ValueError, match="bfloat16"):
        decode_step.fused_self_attention_step(x, f32_w, sb, 0, *ring, 0.125, HEADS)
    with pytest.raises(ValueError, match="contiguous"):
        decode_step.fused_self_attention_step(x, self_w, sb, 0, *strided_ring, 0.125, HEADS)
    with pytest.raises(ValueError, match="float32"):
        decode_step.fused_cross_attention_step(x.double(), cross_w, enc_k, enc_v, eb, 0.125, HEADS)
    with pytest.raises(ValueError, match="contiguous"):
        decode_step.fused_cross_attention_step(x, cross_w, strided_enc, enc_v, eb, 0.125, HEADS)
    with pytest.raises(ValueError, match="bfloat16"):
        decode_step.fused_decoder_layer_step(
            x, f32_w, cross_w, ffn_w, sb, 0, *ring, enc_k, enc_v, eb, 0.125, HEADS)
    with pytest.raises(ValueError, match="contiguous"):
        decode_step.fused_decoder_layer_step(
            x, self_w, cross_w, ffn_w, sb, 0, *ring, strided_enc, enc_v, eb, 0.125, HEADS)
    with pytest.raises(ValueError, match="float16"):
        decode_step.fused_decoder_layer_step(
            x, self_w, cross_w, ffn_w, sb, 0, ring[0].half(), ring[1].half(), ring[2],
            enc_k, enc_v, eb, 0.125, HEADS)
    assert _cuda.launch_counts() == counts


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    x = _randn(gen, 4, HD)
    w1_f32 = _randn(gen, HD, D_FF)
    rest = (_randn(gen, D_FF), _randn(gen, D_FF, HD, dtype=torch.bfloat16),
            _randn(gen, HD), _randn(gen, HD), _randn(gen, HD))
    with pytest.raises(ValueError, match="bfloat16"):
        decode_step.fused_ffn_step(x, w1_f32, *rest)
    narrow = _randn(gen, 4, 96)
    with pytest.raises(ValueError, match="multiple of 128"):
        decode_step.fused_ffn_step(narrow, *(torch.zeros(1, device=dev),) * 6)
    with pytest.raises(ValueError):
        decode_step.fused_ffn_step(x, w1_f32.cpu(), *rest)


T5_HEADS, T5_HD = 6, 384  # mT5-small: 6 heads of 64, inner width 384


@pytest.mark.parametrize("form,sq,sk,bs", [
    ("table + padding", 27, 27, 5), ("table + padding", 40, 70, 5),
    ("per-sample head bias", 27, 27, 5), ("per-sample head bias, row bias", 40, 70, 5),
    # the mT5 train batch, one query row, and a key count past block B's resident reach
    ("table + padding", 26, 26, 60), ("per-sample head bias, row bias", 1, 26, 5),
    ("table + padding", 1, 40, 5), ("table + padding", 20, 401, 3),
    ("per-sample head bias, row bias", 20, 401, 3),
])
def test_two_bias_attention_kernel_matches_plain(dev, form, sq, sk, bs):
    """The two-bias attention at T5's geometry (hd 384 over 6 heads, scale 1)
    against its plain version: the (1, h, Sq, Sk) table beside a (b, 1, 1, Sk)
    padding bias, and per-sample (b, h, Sq, Sk) head biases with no or a
    (b, 1, Sq, Sk) head-shared bias.  Sample 0 has every key masked: it stays
    finite and agrees too (its logits sit near -1e5, where one float32 ulp is
    7.8e-3, but kernel and plain round the same sums)."""
    gen = torch.Generator(device=dev).manual_seed(sq + sk)
    q, k, v = _randn(gen, bs, sq, T5_HD), _randn(gen, bs, sk, T5_HD), _randn(gen, bs, sk, T5_HD)
    padding = _key_bias(gen, bs, sk)[:, None, None, :].contiguous()
    table = _randn(gen, 1, T5_HEADS, sq, sk)
    if form == "table + padding":
        bias, head_bias = padding, table
    elif form == "per-sample head bias":
        bias, head_bias = None, (table + padding).contiguous()
    else:
        bias = torch.where(torch.rand(bs, 1, sq, sk, generator=gen, device=dev) < 0.2, MASK, 0.0)
        head_bias = (table + padding).contiguous()
    args = (q, k, v, bias, head_bias, 1.0, T5_HEADS)
    before = _cuda.launch_counts()["fused_attention_packed_2bias"]
    got = fused_attention.fused_attention_packed_2bias(*args)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["fused_attention_packed_2bias"] == before + 1
    assert bool(torch.isfinite(got).all())
    assert _err(got, fused_attention.fused_attention_packed_2bias_plain(*args)) <= ATTN_TOL


@pytest.mark.parametrize("block", ["resident", "ring"])
@pytest.mark.parametrize("sq,sk", [(26, 26), (1, 26), (20, 130)])
def test_two_bias_attention_on_both_blocks(dev, block, sq, sk):
    """Block B's two-bias instance forced resident and ring at one shape, each
    within ATTN_TOL of the plain version, a per-sample head bias beside a
    head-shared row bias, sample 0 fully masked."""
    gen = torch.Generator(device=dev).manual_seed(3 * sq + sk)
    bs = 4
    q, k, v = _randn(gen, bs, sq, T5_HD), _randn(gen, bs, sk, T5_HD), _randn(gen, bs, sk, T5_HD)
    padding = _key_bias(gen, bs, sk)[:, None, None, :]
    head_bias = (_randn(gen, 1, T5_HEADS, sq, sk) + padding).contiguous()
    bias = torch.where(torch.rand(bs, 1, sq, sk, generator=gen, device=dev) < 0.2, MASK, 0.0)
    args = (q, k, v, bias, head_bias, 1.0, T5_HEADS)
    with torch.no_grad():
        got = fused_attention._packed_2bias_kernel(*args, block=block)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _err(got, fused_attention.fused_attention_packed_2bias_plain(*args)) <= ATTN_TOL


def test_two_bias_attention_forms_agree(dev):
    """T5's two forms of one bias: the padding as the head-shared operand beside
    the shared table, or the two added into one (b, h, L, L) head bias (the
    JAX package's form)."""
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v = (_randn(gen, 4, 24, T5_HD) for _ in range(3))
    padding = _key_bias(gen, 4, 24)[:, None, None, :].contiguous()
    table = _randn(gen, 1, T5_HEADS, 24, 24)
    shared = fused_attention.fused_attention_packed_2bias(q, k, v, padding, table, 1.0, T5_HEADS)
    summed = fused_attention.fused_attention_packed_2bias(
        q, k, v, None, (table + padding).contiguous(), 1.0, T5_HEADS)
    assert _err(shared, summed) <= ATTN_TOL


def test_two_bias_wrapper_refuses_what_the_kernel_does_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(22)
    q = _randn(gen, 2, 8, T5_HD)
    table = _randn(gen, 1, T5_HEADS, 8, 8)
    counts = _cuda.launch_counts()
    with pytest.raises(ValueError, match="head_bias"):
        fused_attention.fused_attention_packed_2bias(q, q, q, None, table[:, :3], 1.0, T5_HEADS)
    with pytest.raises(ValueError, match="float32"):
        fused_attention.fused_attention_packed_2bias(q, q, q, None, table.double(), 1.0, T5_HEADS)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention.fused_attention_packed_2bias(
            q, q, q, None, table.transpose(2, 3), 1.0, T5_HEADS)
    with pytest.raises(ValueError, match="no backward kernel"):
        fused_attention.fused_attention_packed_2bias(
            q.clone().requires_grad_(), q, q, None, table, 1.0, T5_HEADS)
    with pytest.raises(ValueError):
        fused_attention.fused_attention_packed_2bias(q, q, q, None, table.cpu(), 1.0, T5_HEADS)
    assert _cuda.launch_counts() == counts


# -- the flat attention ---------------------------------------------------------------------
FLAT_B, FLAT_H = 3, 4


_FLAT_CUT = fused_attention.SINGLE_QUERY_MAX_ROWS["flat"]
_FLAT_BIASES = ("per-sample keys", "none", "constant", "per-head", "per-sample full",
                 "head keys", "shared full", "per-head keys", "head full")
_FLAT_CASES = [
    (1, 324, 64, 64, "per-sample keys"),  # a decode step over the joint stream
    (1, 6, 64, 64, "per-sample keys"),  # a decode step over a ring of 6 slots
    (40, 45, 64, 64, "none"),
    (40, 45, 64, 64, "constant"),
    (40, 45, 32, 32, "shared full"),
    (40, 45, 64, 64, "per-sample full"),
    (70, 130, 64, 64, "per-head"),  # ragged key chunk
    (70, 130, 64, 32, "per-head keys"),  # d_k != d_v
    (17, 100, 16, 128, "per-sample full"),
    (5, 333, 128, 48, "head full"),
    # each side of the single-query block's key limit
    (1, fused_attention.SINGLE_QUERY_MAX_KEYS, 64, 64, "per-sample keys"),
    (1, fused_attention.SINGLE_QUERY_MAX_KEYS + 1, 64, 64, "per-sample keys"),
] + [
    # each side of the single-query cut-over, every key count and head dims, the
    # bias forms in turn
    (sq, sk, dk, dv, _FLAT_BIASES[n % len(_FLAT_BIASES)])
    for n, (sq, sk, (dk, dv)) in enumerate(itertools.product(
        (1, _FLAT_CUT, _FLAT_CUT + 1), (1, 8, 63, 64, 65, 215, 324, 1601),
        ((64, 64), (96, 96), (64, 32))))
]


@pytest.mark.parametrize("sq,sk,dk,dv,bias_form", _FLAT_CASES)
def test_flat_attention_kernel_matches_plain(dev, sq, sk, dk, dv, bias_form):
    """Split-head views of packed projections (read through their strides)
    against the plain version on the same tensors; sample 0 of a per-sample
    bias has every key masked and must average its values, finite."""
    gen = torch.Generator(device=dev).manual_seed(sq + sk + dk + dv)

    def heads(s, d):
        return _randn(gen, FLAT_B, s, FLAT_H * d).view(FLAT_B, s, FLAT_H, d).transpose(1, 2)

    q, k, v = heads(sq, dk), heads(sk, dk), heads(sk, dv)
    bias = _bias_of_form(gen, bias_form, FLAT_B, sq, sk, FLAT_H)
    scale = dk ** -0.5
    before = _cuda.launch_counts()["fused_attention"]
    got = fused_attention.fused_attention(q, k, v, bias, scale)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["fused_attention"] == before + 1
    assert tuple(got.shape) == (FLAT_B, FLAT_H, sq, dv) and bool(torch.isfinite(got).all())
    assert _err(got, fused_attention.fused_attention_plain(q, k, v, bias, scale)) <= ATTN_TOL


@pytest.mark.parametrize("block", ["single", "tile"])
def test_flat_attention_blocks_agree_at_one_shape(dev, block):
    """Both flat blocks, forced, at the cross step's geometry with 2 rows."""
    gen = torch.Generator(device=dev).manual_seed(12)
    q, k, v = (_randn(gen, 6, 8, s, 64) for s in (2, 324, 324))
    bias = _bias_of_form(gen, "per-sample keys", 6, 2, 324)
    got = fused_attention._flat_kernel(q, k, v, bias, 0.125, block=block)
    assert _err(got, fused_attention.fused_attention_plain(q, k, v, bias, 0.125)) <= ATTN_TOL


def test_flat_attention_contiguous_operands_and_gradients(dev):
    """Contiguous (b, h, S, d) operands (the JAX layout) and the autograd
    function: the kernel's forward, the plain analytic backward with the
    bias gradient."""
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v = (_randn(gen, 2, 3, s, 32) for s in (9, 70, 70))
    bias = _randn(gen, 2, 3, 9, 70)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, bias)]
    out = fused_attention.fused_attention(*leaves, 0.2)
    assert _err(out.detach(), fused_attention.fused_attention_plain(q, k, v, bias, 0.2)) <= ATTN_TOL
    g = _randn(gen, 2, 3, 9, 32)
    out.backward(g)
    for leaf, want in zip(leaves, fused_attention.fused_attention_backward_plain(
            q, k, v, bias, g, 0.2)):
        assert _err(leaf.grad, want) <= 1e-5 * max(1.0, float(want.abs().max()))


def test_flat_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q = torch.zeros(2, 3, 4, 64, device=dev)
    k = torch.zeros(2, 3, 8, 64, device=dev)
    for args, match in (
        ((q, k, torch.zeros(2, 3, 8, 130, device=dev)), "head dims"),
        ((q[..., :6], k[..., :6], k[..., :6]), "head dims"),
        ((q.double(), k.double(), k.double()), "float32"),
        ((torch.zeros(2, 3, 4, 128, device=dev)[..., ::2],) * 3, "unit stride"),
    ):
        with pytest.raises(ValueError, match=match):
            fused_attention.fused_attention(*args, None, 0.125)


# -- the streamed attention -------------------------------------------------------------------
@pytest.mark.parametrize("sq,sk,d,masked_row", [
    (40, 300, 32, True),   # query rows not a multiple of the CTA's 128
    (130, 300, 96, True),  # a head dim padded to 128 columns
    (130, 70, 128, False),
    (64, 1601, 64, True),
])
def test_streamed_attention_block_at_odd_rows_and_head_dims(dev, sq, sk, d, masked_row):
    """The one-walk block at Sq not a multiple of 128, head dims 32, 96 and 128,
    a per-query-row bias with one row whose keys are all masked (finite, as
    the plain version), one launch counted."""
    gen = torch.Generator(device=dev).manual_seed(sq * 7 + d)
    heads = 4
    hd = heads * d
    q, k, v = _randn(gen, 2, sq, hd), _randn(gen, 2, sk, hd), _randn(gen, 2, sk, hd)
    bias = torch.where(torch.rand((2, 1, sq, sk), generator=gen, device=dev) < 0.2, MASK, 0.0)
    if masked_row:
        bias[1, 0, sq - 1] = MASK
    scale = d ** -0.5
    before = _cuda.launch_counts()["fused_attention_packed_streamed"]
    got = fused_attention.fused_attention_packed_streamed(q, k, v, bias, scale, heads)
    assert _cuda.launch_counts()["fused_attention_packed_streamed"] == before + 1
    want = fused_attention.fused_attention_packed_streamed_plain(q, k, v, bias, scale, heads)
    assert bool(torch.isfinite(got).all())
    assert _err(got, want) <= ATTN_TOL


@pytest.mark.parametrize("sq,sk,bias_shape", [
    (64, 1536, (2, 1, 1, 1536)),
    (40, 1601, (2, 1, 40, 1601)),  # a ragged 64-key chunk
    (33, 45, None),
])
def test_streamed_attention_kernel_matches_plain(dev, sq, sk, bias_shape):
    gen = torch.Generator(device=dev).manual_seed(sq + sk)
    hd, heads = 512, 8
    q, k, v = _randn(gen, 2, sq, hd), _randn(gen, 2, sk, hd), _randn(gen, 2, sk, hd)
    bias = None
    if bias_shape is not None:
        bias = torch.where(torch.rand(bias_shape, generator=gen, device=dev) < 0.2, MASK, 0.0)
    scale = (hd // heads) ** -0.5
    before = _cuda.launch_counts()["fused_attention_packed_streamed"]
    got = fused_attention.fused_attention_packed_streamed(q, k, v, bias, scale, heads)
    assert _cuda.launch_counts()["fused_attention_packed_streamed"] == before + 1
    want = fused_attention.fused_attention_packed_streamed_plain(q, k, v, bias, scale, heads)
    assert _err(got, want) <= ATTN_TOL
