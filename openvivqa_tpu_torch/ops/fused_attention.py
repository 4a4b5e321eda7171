"""Packed attention, softmax(scale * Q K^T + bias) V on the raw (b, S, h * d)
projections, with and without in-kernel dropout on the attention weights, with
a second, per-head bias, and streamed over long key streams; and the flat
attention on split-head (b, h, S, d) operands; each beside its plain PyTorch
version.

Counterparts of ``fused_attention_packed``, ``fused_attention_packed_dropout``,
``fused_attention_packed_2bias``, ``fused_attention_packed_streamed`` and
``fused_attention`` in ``openvivqa_tpu/ops/fused_attention.py``; the CUDA
sources are ``csrc/fused_attention.cu`` (block B: the packed entry, the
dropout forward and the two-bias entry), ``csrc/fused_attention_dropout.cu``
(the dropout backward), ``csrc/fused_attention_streamed.cu`` and
``csrc/fused_attention_flat.cu``.  Which device block serves a call of the
packed, the dropout, the two-bias or the flat entry is a function of its
shapes alone (:func:`attention_block`).  The packed kernels' bias is
head-shared, ``(bb, 1, bq, Sk)`` with ``bb`` in {1, b} and ``bq`` in {1, Sq}, and
is never broadcast in memory.  It is a mask constant: neither gradient flows to
it (the JAX package returns zeros for it under dropout and never uses the
packed one's).  The flat attention's bias is any (b|1, h|1, Sq|1, Sk|1) form,
read through strides of 0 over its broadcast axes, and gets its gradient.

Dot operands and softmax weights are rounded to ``op_dtype`` (bf16 on the card,
as in the TPU kernels; float32 on the CPU unless asked otherwise); the softmax
and accumulators are float32.

The two-bias attention is forward only on the card: the backbones that call it
(T5, DeBERTa) run frozen, under ``torch.no_grad()``.

Gradients:
  * ``fused_attention_packed`` and ``fused_attention_packed_streamed``: the
    analytic formula of the JAX package's ``_packed_bwd`` in plain PyTorch, in
    float32, as XLA computes it there (the JAX package pairs its streamed
    forward with the same backward);
  * ``fused_attention``: ``_bwd``'s formula in plain PyTorch, float32, with
    the bias gradient summed over the bias's broadcast axes;
  * ``fused_attention_packed_dropout``: two CUDA kernels on the card (dq and
    the row terms D, then dk and dv), the plain version of the TPU backward
    kernel on the CPU.  The mask is Philox4x32-10 keyed by the per-call seed,
    counted by (key column // 4, query row, head, sample), word key column % 4
    (``philox4x32_10``, the same function as ``csrc/common.cuh``'s).  The
    forward kernel draws it and leaves it as bits (``dropout_mask_bits``'s
    layout) beside each row's (max, 1 / denominator), and the backward kernels
    read both; the plain versions regenerate it.  Kernel and plain version use
    identical masks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import _cuda

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _check_bias(bias: torch.Tensor, b: int, sq: int, sk: int) -> Tuple[int, int]:
    """(bb, bq) of a head-shared (bb, 1, bq, Sk) additive bias; ValueError
    unless bb is 1 or b and bq is 1 or Sq."""
    if bias.ndim != 4 or bias.shape[1] != 1:
        raise ValueError(f"packed attention needs a (b, 1, q, k) bias, got {tuple(bias.shape)}")
    bb, _, bq, bk = bias.shape
    if bb not in (1, b) or bq not in (1, sq) or bk != sk:
        raise ValueError(
            f"bias {tuple(bias.shape)} does not broadcast to ({b}, 1, {sq}, {sk}) "
            "with its batch and query dims each 1 or full"
        )
    return bb, bq


def _bias_3d(bias: Optional[torch.Tensor], b: int, sq: int, sk: int, device):
    """(bb, 1, bq, Sk) additive bias -> (bb, bq, Sk) float32, validated."""
    if bias is None:
        return torch.zeros((1, 1, sk), dtype=torch.float32, device=device)
    _check_bias(bias, b, sq, sk)
    return bias[:, 0].to(torch.float32)


def _heads(x, num_heads: int, op_dtype):
    b, s, hd = x.shape
    return x.to(op_dtype).float().reshape(b, s, num_heads, hd // num_heads)


def _softmax_weights(qh, kh, bias, scale: float):
    """(b, h, Sq, Sk) float32 softmax of the head-split operands."""
    b, sq = qh.shape[:2]
    sk = kh.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    logits = logits + _bias_3d(bias, b, sq, sk, qh.device)[:, None]
    return torch.softmax(logits, dim=-1)


def fused_attention_packed_plain(
    q, k, v, bias, scale: float, num_heads: int, op_dtype: Optional[torch.dtype] = None
):
    op_dtype = op_dtype or _cuda.kernel_dtype(q.device)
    b, sq, hd = q.shape
    weights = _softmax_weights(_heads(q, num_heads, op_dtype), _heads(k, num_heads, op_dtype),
                               bias, scale).to(op_dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", weights, _heads(v, num_heads, op_dtype))
    return out.reshape(b, sq, hd)


def fused_attention_packed_backward_plain(q, k, v, bias, g, scale: float, num_heads: int):
    """(dq, dk, dv) of the packed attention: ``_packed_bwd``'s analytic
    formula, in float32 (no operand rounding, as XLA computes it)."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    f32 = torch.float32
    qh, kh, vh, gh = (_heads(x, num_heads, f32) for x in (q, k, v, g))
    weights = _softmax_weights(qh, kh, bias, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", weights, gh)
    dw = torch.einsum("bqhd,bkhd->bhqk", gh, vh)
    dlogits = weights * (dw - (dw * weights).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", dlogits, kh) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dlogits, qh) * scale
    return dq.reshape(b, sq, hd), dk.reshape(b, sk, hd), dv.reshape(b, sk, hd)


def _check_packed(q, k, v, num_heads: int, what: str):
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"{what}: q must be (b, Sq, hd) and k, v (b, Sk, hd)")
    b, sq, hd = q.shape
    sk = k.shape[1]
    _cuda.require_attention_shape(sk, hd, num_heads, what)
    _cuda.require(q, "q", torch.float32, (b, sq, hd))
    _cuda.require(k, "k", torch.float32, (b, sk, hd))
    _cuda.require(v, "v", torch.float32, (b, sk, hd))
    return b, sq, sk, hd


def _bias_strides(bias3):
    bb, bq, sk = bias3.shape
    return 0 if bb == 1 else bq * sk, 0 if bq == 1 else sk


# -- which device block serves a call ------------------------------------------------
# Block A, the single-query block (csrc/fused_attention_flat.cu), serves each
# entry up to this many query rows: above it the flat entry's 64-row tile block
# and the packed entry's block B are faster (chip_smoke.py times both sides at
# 1, 2, 4, 8 and 16 rows; on the H100 block A leads the tile block through 4 rows
# at the 324-key cross step, and block B from 2 rows at the 215-key MMT shape).
SINGLE_QUERY_MAX_ROWS = {"flat": 4, "packed": 1}
# dynamic shared memory one block may take on the H100
MAX_SMEM_BYTES = 232448
# block A keeps one row of Sk float32 logits in shared memory beside its 8 warps'
# partial outputs of up to 128 floats and 16 floats of scratch
# (fused_attention_flat.cu::single_query_smem_bytes): up to 57072 keys
SINGLE_QUERY_MAX_KEYS = (MAX_SMEM_BYTES // 4 - 8 * 128 - 16) // 4 * 4
# block B (csrc/fused_attention.cu) keeps its head's K and V as bf16 in shared
# memory while they take at most this much, so that two blocks share an SM (from
# 401 keys at d 64, 273 at d 96, 209 at d 128); past it K and V stream through a
# two-slot ring
RESIDENT_KV_BYTES = MAX_SMEM_BYTES // 2


def attention_block(entry: str, sq: int, sk: int, dk: int, dv: int) -> str:
    """The device block that serves one call, from its shapes alone: the
    ``flat`` entry takes ``single`` (block A) or ``tile``; the ``packed`` entry
    ``single``, ``resident`` or ``ring`` (block B); the ``dropout`` entry
    ``resident`` or ``ring`` (block B's dropout instance, at any row count);
    the ``encoder`` entry (kernel F's attention, block B's bf16 instance on the
    packed q|k|v projection) and the ``2bias`` entry (block B's two-bias
    instance) ``resident`` or ``ring`` at any row count;
    the ``streamed`` entry always ``streamed`` (its one-walk wgmma block).
    The dropout backward keeps K and V resident by this rule on (sq, sk), and
    Q and G by it on (sk, sq)."""
    if entry == "streamed":
        return "streamed"
    if entry not in ("flat", "packed", "dropout", "encoder", "2bias"):
        raise ValueError(f"attention_block: unknown entry {entry!r}")
    if (entry in SINGLE_QUERY_MAX_ROWS and sq <= SINGLE_QUERY_MAX_ROWS[entry]
            and sk <= SINGLE_QUERY_MAX_KEYS):
        return "single"
    if entry == "flat":
        return "tile"
    return "resident" if 4 * (-(-sk // 16) * 16) * (dk + 8) <= RESIDENT_KV_BYTES else "ring"


def _packed_bias(bias, b: int, sq: int, sk: int, device):
    """(bias3 or None, batch stride, row stride) of a packed call's bias."""
    if bias is None:
        return None, 0, 0
    bias3 = _bias_3d(bias, b, sq, sk, device).contiguous()
    return (bias3, *_bias_strides(bias3))


def _packed_kernel(q, k, v, bias, scale: float, num_heads: int, streamed: bool = False,
                   block: Optional[str] = None):
    """The packed attention's kernel (block A or B, as `attention_block` or
    `block` says), or with `streamed` the streamed one's (its own entry and
    launch counter)."""
    name = "fused_attention_packed_streamed" if streamed else "fused_attention_packed"
    b, sq, sk, hd = _check_packed(q, k, v, num_heads, name)
    d = hd // num_heads
    p = _cuda.ptr
    out = torch.empty_like(q)
    if streamed:
        bias3 = _bias_3d(bias, b, sq, sk, q.device).contiguous()
        plan = streamed_plan(b, sq, sk, hd, num_heads)
        kv = torch.empty(plan.workspace_elements, dtype=torch.bfloat16, device=q.device)
        _cuda.launch("ovq_streamed_attention_forward", p(q), p(k), p(v), p(bias3),
                     *_bias_strides(bias3), p(out), p(kv), b, sq, sk, hd, num_heads,
                     *plan[:5], scale)
        _cuda.count(name)
        return out
    block = block or attention_block("packed", sq, sk, d, d)
    bias3, bias_bs, bias_qs = _packed_bias(bias, b, sq, sk, q.device)
    if block == "single":
        # packed (b, S, h * d) rows as flat operands: head stride d, row stride h * d
        _cuda.launch(
            "ovq_single_query_attention_forward",
            p(q), sq * hd, d, hd, p(k), sk * hd, d, hd, p(v), sk * hd, d, hd,
            p(bias3), bias_bs, 0, bias_qs, 1, p(out), sq * hd, d, hd,
            b, num_heads, sq, sk, d, d, scale,
        )
    elif block in ("resident", "ring"):
        _cuda.launch("ovq_packed_attention_forward", p(q), p(k), p(v), p(bias3), bias_bs,
                     bias_qs, p(out), b, sq, sk, hd, num_heads, scale, int(block == "resident"))
    else:
        raise ValueError(f"fused_attention_packed: no block {block!r}")
    _cuda.count(name)
    return out


def _needs_grad(tensors) -> bool:
    """Whether autograd would record a call on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class PackedAttention(torch.autograd.Function):
    """The packed (or, with `streamed`, the streamed) attention with the
    analytic backward in plain PyTorch."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale: float, num_heads: int, use_kernel: bool,
                streamed: bool = False):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale, ctx.num_heads = scale, num_heads
        if use_kernel:
            return _packed_kernel(q, k, v, bias, scale, num_heads, streamed)
        if streamed:
            return fused_attention_packed_streamed_plain(q, k, v, bias, scale, num_heads)
        return fused_attention_packed_plain(q, k, v, bias, scale, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = fused_attention_packed_backward_plain(
            q, k, v, bias, g, ctx.scale, ctx.num_heads
        )
        return dq, dk, dv, None, None, None, None, None


def fused_attention_packed(q, k, v, bias, scale: float, num_heads: int):
    """q (b, Sq, h*d), k/v (b, Sk, h*d) float32; bias (bb, 1, bq, Sk) or None.
    Returns (b, Sq, h*d) float32, the layout the out projection consumes."""
    tensors = (q, k, v) if bias is None else (q, k, v, bias)
    use_kernel = _cuda.uses_kernel(*tensors)
    if use_kernel and not _needs_grad(tensors):
        return _packed_kernel(q, k, v, bias, scale, num_heads)  # no graph to record
    return PackedAttention.apply(q, k, v, bias, scale, num_heads, use_kernel)


# -- the streamed attention: the packed contract over long key streams -------------
# The JAX package's VMEM budget, kept as a number so both packages route the same
# shapes: on the card it is a rule on the key count (and widths), not a memory limit.
_VMEM_BUDGET = 12 * 1024 * 1024


def plan_q_block(sq: int, sk: int, hd: int, full_bias: bool) -> Optional[int]:
    """The JAX package's ``plan_q_block``: the largest q-block (the whole Sq
    first) whose TPU blocks fit its VMEM budget, or None."""
    candidates = [sq] + [blk for blk in (512, 384, 256, 128, 64, 32, 16, 8) if sq % blk == 0]
    for qblk in candidates:
        kv_bytes = 2 * sk * hd * 4 * 2
        q_bytes = 2 * qblk * hd * 4 * 2
        bias_bytes = (qblk if full_bias else 1) * sk * 4 * 2
        logits_bytes = 2 * qblk * sk * 4
        if kv_bytes + q_bytes + bias_bytes + logits_bytes <= _VMEM_BUDGET:
            return qblk
    return None


def packed_attention_viable(sq: int, sk: int, hd: int, num_heads: int) -> bool:
    """Whether the JAX package takes the packed kernel for these shapes.  On
    the card the packed kernel streams keys in 64-key chunks and takes any key
    count; this copy of the TPU's VMEM rule only decides where the port hands
    over to the streamed kernel, so both packages send the same shapes to
    counterpart kernels (from 1536 keys at hd 512, from 1024 at hd 768)."""
    return hd % num_heads == 0 and plan_q_block(sq, sk, hd, full_bias=True) is not None


def plan_streamed_blocks(sq: int, sk: int, hd: int, h: int) -> Optional[Tuple[int, int]]:
    """The JAX package's ``plan_streamed_blocks``: (q_block, k_block) of the
    TPU's streamed kernel, whose key blocks divide Sk, or None.  On the card
    it is a rule on the key count: the streamed kernel walks 64-key chunks
    with a count for the ragged end and needs no plan."""
    for qblk in [blk for blk in (256, 128, 64, 32, 16, 8) if sq % blk == 0] or [sq]:
        for kblk in (512, 384, 256, 128, 64):
            if sk % kblk or sk <= kblk:
                continue
            kv_bytes = 2 * kblk * hd * 4 * 2
            q_bytes = 2 * qblk * hd * 4 * 2
            bias_bytes = qblk * kblk * 4 * 2
            scratch = (2 * h * qblk + qblk * hd + 2 * qblk * kblk) * 4
            if kv_bytes + q_bytes + bias_bytes + scratch <= _VMEM_BUDGET:
                return qblk, kblk
    return None


def streamed_attention_viable(sq: int, sk: int, hd: int, h: int) -> bool:
    """Whether the JAX package takes the streamed kernel where the packed one
    is not viable (a key-count rule on the card, see plan_streamed_blocks)."""
    return hd % h == 0 and plan_streamed_blocks(sq, sk, hd, h) is not None


class StreamedPlan(NamedTuple):
    """How csrc/fused_attention_streamed.cu cuts one call: CTAs of `q_rows`
    query rows (consumer warpgroups of 64), a ring of `stages` chunks of
    `chunk` keys of K and V in bf16 padded to `head_block` columns, `smem`
    bytes of shared memory a CTA (the ring and each warpgroup's bf16 Q tile),
    and the bf16 K/V workspace the cast pass writes.  The C entry takes the first five and refuses a call whose plan
    is not its own."""

    q_rows: int
    stages: int
    chunk: int
    head_block: int
    smem: int
    workspace_elements: int


STREAMED_CHUNK, STREAMED_STAGES = 64, 4


def streamed_plan(b: int, sq: int, sk: int, hd: int, num_heads: int) -> StreamedPlan:
    """The streamed kernel's cut of one call: a head dim up to 64 padded to 64
    columns with three consumer warpgroups a CTA, up to 128 to 128 with two;
    one CTA per (query tile, head, sample)."""
    _cuda.require_attention_shape(sk, hd, num_heads, "fused_attention_packed_streamed")
    d = hd // num_heads
    head_block = 64 if d <= 64 else 128
    q_rows = 192 if head_block == 64 else 128
    stage = 2 * (head_block // 64) * STREAMED_CHUNK * 128
    q_tiles = (q_rows // 64) * (head_block // 64) * 64 * 128  # each consumer's bf16 Q
    smem = 1024 + STREAMED_STAGES * stage + q_tiles + 2 * STREAMED_STAGES * 8
    return StreamedPlan(q_rows, STREAMED_STAGES, STREAMED_CHUNK, head_block, smem,
                        2 * b * num_heads * sk * head_block)


def fused_attention_packed_streamed_plain(
    q, k, v, bias, scale: float, num_heads: int, op_dtype: Optional[torch.dtype] = None
):
    """The packed attention's arithmetic: the weights are normalised before
    they are rounded to op_dtype.  (The streamed kernels, the TPU's and the
    card's, round each key block's unnormalised weights and divide at the
    end, one bf16 rounding of a weight apart.)"""
    return fused_attention_packed_plain(q, k, v, bias, scale, num_heads, op_dtype)


def fused_attention_packed_streamed(q, k, v, bias, scale: float, num_heads: int):
    """The packed attention's contract for key streams past the packed
    kernel's reach (``packed_attention_viable``): q (b, Sq, h*d), k/v (b, Sk,
    h*d) float32, bias (bb, 1, bq, Sk) or None; returns (b, Sq, h*d).  Keys
    stream through the kernel in 64-key chunks under an online softmax, one
    walk, any key count (``streamed_plan``).  Its backward is the packed
    attention's."""
    tensors = (q, k, v) if bias is None else (q, k, v, bias)
    use_kernel = _cuda.uses_kernel(*tensors)
    if use_kernel and not _needs_grad(tensors):
        return _packed_kernel(q, k, v, bias, scale, num_heads, True)  # no graph to record
    return PackedAttention.apply(q, k, v, bias, scale, num_heads, use_kernel, True)


# -- dropout on the attention weights ----------------------------------------------
def dropout_threshold(rate: float) -> int:
    """Drop an element when (bits >> 9) < threshold (``_dropout_threshold``)."""
    return min(int(rate * (1 << 23)), (1 << 23) - 1)


def _mulhilo(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of a * m for int64 tensors a in [0, 2^32), in
    16-bit halves so that no int64 product overflows."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    a_hi, a_lo = a >> 16, a & 0xFFFF
    mid = a_hi * m_lo + a_lo * m_hi
    low = a_lo * m_lo + ((mid & 0xFFFF) << 16)
    high = a_hi * m_hi + (mid >> 16) + (low >> 32)
    return high & _MASK32, low & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit words (broadcasting):
    the four output words of counter (c0, c1, c2, c3) under key (k0, k1)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def _philox_words(seed: torch.Tensor, b: int, heads: int, sq: int, sk: int):
    """(b, heads, Sq, Sk) int64: the Philox word of each attention weight."""
    device = seed.device

    def axis(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)

    seed = seed.reshape(1, 1, 1, 1).to(torch.int64)
    words = philox4x32_10(
        axis(-(-sk // 4), 3), axis(sq, 2), axis(heads, 1), axis(b, 0),
        seed & _MASK32, (seed >> 32) & _MASK32,
    )
    return torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(b, heads, sq, -1)[..., :sk]


def dropout_factors(seed: torch.Tensor, b: int, heads: int, sq: int, sk: int, rate: float):
    """(b, heads, Sq, Sk) float32: 1 / (1 - rate) where the Philox mask keeps
    the weight, 0 where it drops it."""
    keep = (_philox_words(seed, b, heads, sq, sk) >> 9) >= dropout_threshold(rate)
    device = seed.device
    return torch.where(keep, torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=device),
                       torch.tensor(0.0, dtype=torch.float32, device=device))


def dropout_mask_bits(seed: torch.Tensor, b: int, heads: int, sq: int, sk: int, rate: float):
    """(b, heads, Sq, ceil(Sk / 32)) int32: the Philox mask as the forward
    kernel writes it, bit j % 32 of word j // 32 set where key j is kept (bits
    past Sk clear)."""
    keep = ((_philox_words(seed, b, heads, sq, sk) >> 9) >= dropout_threshold(rate)).to(torch.int64)
    n_words = -(-sk // 32)
    keep = torch.nn.functional.pad(keep, (0, 32 * n_words - sk)).reshape(b, heads, sq, n_words, 32)
    place = torch.arange(32, dtype=torch.int64, device=seed.device)
    words = (keep << place).sum(dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def fused_attention_packed_dropout_plain(
    q, k, v, bias, seed, scale: float, num_heads: int, rate: float,
    op_dtype: Optional[torch.dtype] = None,
):
    """out = bf16(keep * softmax / (1 - rate)) V per head, the mask from
    ``dropout_factors(seed, ...)``; seed is a (1,) int64 tensor."""
    op_dtype = op_dtype or _cuda.kernel_dtype(q.device)
    b, sq, hd = q.shape
    weights = _softmax_weights(_heads(q, num_heads, op_dtype), _heads(k, num_heads, op_dtype),
                               bias, scale)
    factors = dropout_factors(seed, b, num_heads, sq, k.shape[1], rate)
    dropped = (weights * factors).to(op_dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", dropped, _heads(v, num_heads, op_dtype))
    return out.reshape(b, sq, hd)


def fused_attention_packed_dropout_backward_plain(
    q, k, v, bias, seed, g, scale: float, num_heads: int, rate: float,
    op_dtype: Optional[torch.dtype] = None,
):
    """(dq, dk, dv) float32 with the forward's mask regenerated: the TPU
    backward kernel's arithmetic (``_packed_dropout_bwd_kernel``)."""
    op_dtype = op_dtype or _cuda.kernel_dtype(q.device)
    b, sq, hd = q.shape
    sk = k.shape[1]
    qh, kh, vh, gh = (_heads(x, num_heads, op_dtype) for x in (q, k, v, g))
    weights = _softmax_weights(qh, kh, bias, scale)
    factors = dropout_factors(seed, b, num_heads, sq, sk, rate)
    dropped = (weights * factors).to(op_dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", dropped, gh)
    dw = torch.einsum("bqhd,bkhd->bhqk", gh, vh) * factors
    dlogits = (weights * (dw - (dw * weights).sum(dim=-1, keepdim=True))).to(op_dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dlogits, kh) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dlogits, qh) * scale
    return dq.reshape(b, sq, hd), dk.reshape(b, sk, hd), dv.reshape(b, sk, hd)


def _check_seed(seed):
    _cuda.require(seed, "seed", torch.int64, (1,))


def _dropout_forward_kernel(q, k, v, bias, seed, scale: float, num_heads: int, rate: float,
                            block: Optional[str] = None):
    """Block B's dropout instance (resident or ring, as `attention_block` or
    `block` says): out, the rows' (max, 1 / denominator) as (b, h, Sq, 2)
    float32 and the keep mask as (b, h, Sq, ceil(Sk / 32)) int32 bits
    (``dropout_mask_bits``), both for the backward kernels."""
    b, sq, sk, hd = _check_packed(q, k, v, num_heads, "fused_attention_packed_dropout")
    _check_seed(seed)
    d = hd // num_heads
    block = block or attention_block("dropout", sq, sk, d, d)
    if block not in ("resident", "ring"):
        raise ValueError(f"fused_attention_packed_dropout: no block {block!r}")
    bias3, bias_bs, bias_qs = _packed_bias(bias, b, sq, sk, q.device)
    out = torch.empty_like(q)
    stats = torch.empty((b, num_heads, sq, 2), dtype=torch.float32, device=q.device)
    bits = torch.empty((b, num_heads, sq, -(-sk // 32)), dtype=torch.int32, device=q.device)
    p = _cuda.ptr
    _cuda.launch(
        "ovq_packed_dropout_forward", p(q), p(k), p(v), p(bias3), bias_bs, bias_qs,
        p(seed), dropout_threshold(rate), 1.0 / (1.0 - rate), p(stats), p(bits), p(out),
        b, sq, sk, hd, num_heads, scale, int(block == "resident"),
    )
    _cuda.count("fused_attention_packed_dropout")
    return out, stats, bits


def _dropout_backward_kernel(q, k, v, bias, stats, bits, g, scale: float, num_heads: int,
                             rate: float):
    """(dq, dk, dv) from the forward kernel's stats and mask bits: kernel 1
    (dq, D) with K and V resident or in a ring, kernel 2 (dk, dv) with Q and G
    resident or in a ring, each by `attention_block`'s rule."""
    b, sq, sk, hd = _check_packed(q, k, v, num_heads, "fused_attention_packed_dropout backward")
    _cuda.require(g, "g", torch.float32, (b, sq, hd))
    _cuda.require(stats, "stats", torch.float32, (b, num_heads, sq, 2))
    _cuda.require(bits, "bits", torch.int32, (b, num_heads, sq, -(-sk // 32)))
    d = hd // num_heads
    kv_block = attention_block("dropout", sq, sk, d, d)
    qg_block = attention_block("dropout", sk, sq, d, d)
    bias3, bias_bs, bias_qs = _packed_bias(bias, b, sq, sk, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, num_heads, sq), dtype=torch.float32, device=q.device)
    p = _cuda.ptr
    _cuda.launch(
        "ovq_packed_dropout_backward", p(q), p(k), p(v), p(g), p(bias3), bias_bs, bias_qs,
        1.0 / (1.0 - rate), p(stats), p(bits), p(delta), p(dq), p(dk), p(dv),
        b, sq, sk, hd, num_heads, scale, int(kv_block == "resident"), int(qg_block == "resident"),
    )
    _cuda.count("fused_attention_packed_dropout_backward")
    return dq, dk, dv


class PackedDropoutAttention(torch.autograd.Function):
    """The dropout attention: both directions through the kernels when
    `use_kernel`, else through the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale: float, num_heads: int, rate: float,
                use_kernel: bool):
        stats = bits = None
        if use_kernel:
            out, stats, bits = _dropout_forward_kernel(q, k, v, bias, seed, scale, num_heads, rate)
        else:
            out = fused_attention_packed_dropout_plain(q, k, v, bias, seed, scale, num_heads, rate)
        ctx.save_for_backward(q, k, v, bias, seed, stats, bits)
        ctx.args = (scale, num_heads, rate, use_kernel)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, seed, stats, bits = ctx.saved_tensors
        scale, num_heads, rate, use_kernel = ctx.args
        g = g.float().contiguous()
        if use_kernel:
            grads = _dropout_backward_kernel(q, k, v, bias, stats, bits, g, scale, num_heads, rate)
        else:
            grads = fused_attention_packed_dropout_backward_plain(
                q, k, v, bias, seed, g, scale, num_heads, rate
            )
        return (*grads, None, None, None, None, None, None)


def fused_attention_packed_dropout(q, k, v, bias, seed, scale: float, num_heads: int,
                                   rate: float):
    """Packed attention with dropout on the attention weights, rate in [0, 1);
    seed a (1,) int64 tensor on q's device (one draw per call)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    tensors = (q, k, v, seed) if bias is None else (q, k, v, seed, bias)
    return PackedDropoutAttention.apply(
        q, k, v, bias, seed, scale, num_heads, rate, _cuda.uses_kernel(*tensors)
    )


# -- a second, per-head bias (T5 relative positions, DeBERTa) ------------------------
def _check_2bias_shapes(q, k, v, bias, head_bias, num_heads: int) -> None:
    """Raise ValueError unless q is (b, Sq, h * d), k and v (b, Sk, h * d), bias
    broadcasts as a head-shared (bb, 1, bq, Sk) and head_bias is a float32
    (hb, h, Sq, Sk) with hb in {1, b}."""
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError("fused_attention_packed_2bias: q must be (b, Sq, hd) and k, v (b, Sk, hd)")
    b, sq, hd = q.shape
    sk = k.shape[1]
    if num_heads <= 0 or hd % num_heads:
        raise ValueError(f"fused_attention_packed_2bias: {num_heads} heads do not tile width {hd}")
    if bias is not None:
        _check_bias(bias, b, sq, sk)
    if head_bias.ndim != 4 or head_bias.shape[0] not in (1, b) \
            or tuple(head_bias.shape[1:]) != (num_heads, sq, sk):
        raise ValueError(
            f"fused_attention_packed_2bias: head_bias {tuple(head_bias.shape)} is not "
            f"(1 or {b}, {num_heads}, {sq}, {sk})"
        )
    if head_bias.dtype != torch.float32:
        raise ValueError(f"fused_attention_packed_2bias: head_bias must be float32, "
                         f"got {head_bias.dtype}")


def fused_attention_packed_2bias_plain(
    q, k, v, bias, head_bias, scale: float, num_heads: int,
    op_dtype: Optional[torch.dtype] = None,
):
    """The TPU kernel's arithmetic: logits (scale * q k^T + bias) + head_bias in
    float32 on op_dtype-rounded operands, the softmax weights rounded to
    op_dtype before the product with V."""
    op_dtype = op_dtype or _cuda.kernel_dtype(q.device)
    b, sq, hd = q.shape
    sk = k.shape[1]
    qh, kh, vh = (_heads(x, num_heads, op_dtype) for x in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    logits = logits + _bias_3d(bias, b, sq, sk, q.device)[:, None] + head_bias.float()
    weights = torch.softmax(logits, dim=-1).to(op_dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", weights, vh).reshape(b, sq, hd)


def _packed_2bias_kernel(q, k, v, bias, head_bias, scale: float, num_heads: int,
                         block: Optional[str] = None):
    """Block B's two-bias instance (resident or ring, as `attention_block` or
    `block` says) on operands whose shapes passed ``_check_2bias_shapes``: the
    checks the kernel adds (float32, contiguous, the head dim), then the
    launch.  The bias is read through strides of 0 where it is shared, as laid
    out in memory; an absent one is a null pointer."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    for name, x in (("q", q), ("k", k), ("v", v), ("head_bias", head_bias)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: expected torch.float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    _cuda.require_attention_shape(sk, hd, num_heads, "fused_attention_packed_2bias")
    d = hd // num_heads
    block = block or attention_block("2bias", sq, sk, d, d)
    if block not in ("resident", "ring"):
        raise ValueError(f"fused_attention_packed_2bias: no block {block!r}")
    bias_ptr, bias_bs, bias_qs = None, 0, 0
    if bias is not None:
        if bias.dtype != torch.float32 or not bias.is_contiguous():
            bias = bias.float().contiguous()
        bb, _, bq, _ = bias.shape
        bias_ptr, bias_bs, bias_qs = bias.data_ptr(), 0 if bb == 1 else bq * sk, 0 if bq == 1 else sk
    out = torch.empty_like(q)
    _cuda.launch(
        "ovq_packed_2bias_attention_forward", q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
        bias_bs, bias_qs, head_bias.data_ptr(),
        0 if head_bias.shape[0] == 1 else num_heads * sq * sk, out.data_ptr(),
        b, sq, sk, hd, num_heads, scale, int(block == "resident"),
    )
    _cuda.count("fused_attention_packed_2bias")
    return out


def fused_attention_packed_2bias(q, k, v, bias, head_bias, scale: float, num_heads: int):
    """softmax(scale * Q K^T + bias + head_bias) V on packed projections: q (b,
    Sq, h*d), k/v (b, Sk, h*d) float32; bias head-shared (bb, 1, bq, Sk) or None;
    head_bias (hb, h, Sq, Sk) float32 with hb in {1, b} (T5's relative-position
    table shared by the batch, or per-sample terms).  Returns (b, Sq, h*d).

    On the card it launches the kernel, forward only: it raises when a gradient
    would be needed.  On the CPU the plain version runs, with autograd."""
    _check_2bias_shapes(q, k, v, bias, head_bias, num_heads)
    tensors = (q, k, v, head_bias) if bias is None else (q, k, v, head_bias, bias)
    if not _cuda.uses_kernel(*tensors):
        return fused_attention_packed_2bias_plain(q, k, v, bias, head_bias, scale, num_heads)
    if _needs_grad(tensors):
        raise ValueError(
            "fused_attention_packed_2bias has no backward kernel: call it on frozen "
            "inputs or under torch.no_grad()"
        )
    return _packed_2bias_kernel(q, k, v, bias, head_bias, scale, num_heads)


# -- the flat attention: split-head (b, h, S, d) operands ------------------------------
def _check_flat(q, k, v, bias):
    """Raise ValueError unless q is (b, h, Sq, d_k), k (b, h, Sk, d_k), v (b,
    h, Sk, d_v) and bias, if given, broadcasts as (b|1, h|1, Sq|1, Sk|1)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("fused_attention: q, k and v must be (b, h, S, d)")
    b, h, sq, dk = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (b, h, sk, dk) or tuple(v.shape[:3]) != (b, h, sk):
        raise ValueError(f"fused_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} are not (b, h, Sq, d_k), (b, h, Sk, d_k), "
                         "(b, h, Sk, d_v)")
    if bias is not None and (bias.ndim != 4 or any(
            n not in (1, full) for n, full in zip(bias.shape, (b, h, sq, sk)))):
        raise ValueError(f"fused_attention: bias {tuple(bias.shape)} does not broadcast to "
                         f"({b}, {h}, {sq}, {sk}) with each axis 1 or full")


def fused_attention_plain(q, k, v, bias, scale: float, op_dtype: Optional[torch.dtype] = None):
    """The flat kernel's arithmetic (the TPU's ``_flat_kernel``): logits
    scale * q k^T + bias in float32 on op_dtype-rounded operands, the softmax
    weights rounded to op_dtype before the product with v.  Returns (b, h, Sq,
    d_v) float32."""
    op_dtype = op_dtype or _cuda.kernel_dtype(q.device)
    qh, kh, vh = (x.to(op_dtype).float() for x in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1).to(op_dtype).float()
    return torch.einsum("bhqk,bhkd->bhqd", weights, vh)


def fused_attention_backward_plain(q, k, v, bias, g, scale: float):
    """(dq, dk, dv, dbias) of the flat attention: the JAX package's ``_bwd``
    in float32 (no operand rounding, as XLA computes it); dbias is summed over
    the axes the bias broadcasts along, or None without a bias."""
    f32 = torch.float32
    q, k, v, g = (x.to(f32) for x in (q, k, v, g))
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        logits = logits + bias.to(f32)
    weights = torch.softmax(logits, dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", weights, g)
    dw = torch.einsum("bhqd,bhkd->bhqk", g, v)
    dlogits = weights * (dw - (dw * weights).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", dlogits, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dlogits, q) * scale
    dbias = None
    if bias is not None:
        axes = [axis for axis, (n, full) in enumerate(zip(bias.shape, dlogits.shape))
                if n == 1 and full != 1]
        dbias = (dlogits.sum(dim=axes, keepdim=True) if axes else dlogits).to(bias.dtype)
    return dq, dk, dv, dbias


def _flat_strides(x, name: str):
    """(batch, head, row) element strides of a float32 operand the flat
    kernel reads or writes: unit stride on the last axis, the others
    multiples of 4 and a 16-byte aligned start (16-byte loads and stores)."""
    if x.dtype != torch.float32:
        raise ValueError(f"fused_attention: {name} must be float32, got {x.dtype}")
    s = x.stride()
    if s[3] == 1 and not (s[0] | s[1] | s[2]) % 4 and not x.data_ptr() % 16:
        return s[:3]
    # a size-1 axis may carry any stride: the kernel never steps along it
    s = [0 if n == 1 else st for n, st in zip(x.shape, s)]
    if s[3] not in (0, 1) or any(st % 4 for st in s[:3]) or x.data_ptr() % 16:
        raise ValueError(f"fused_attention: {name} with strides {tuple(x.stride())} needs a unit "
                         "stride on its last axis, the other strides multiples of 4 and a "
                         "16-byte aligned start")
    return s[:3]


def _flat_kernel(q, k, v, bias, scale: float, block: Optional[str] = None):
    """The flat kernel (block A or the tile block, as `attention_block` or
    `block` says) on operands that passed ``_check_flat``."""
    b, h, sq, dk = q.shape
    sk, dv = v.shape[2], v.shape[3]
    if dk % 4 or dv % 4 or not (0 < dk <= 128 and 0 < dv <= 128):
        raise ValueError(f"fused_attention: head dims d_k {dk}, d_v {dv}: the kernel takes "
                         "multiples of 4 up to 128")
    block = block or attention_block("flat", sq, sk, dk, dv)
    if block not in ("single", "tile"):
        raise ValueError(f"fused_attention: no block {block!r}")
    if bias is not None and (bias.dtype != torch.float32
                             or (bias.shape[3] > 1 and bias.stride(3) != 1)):
        bias = bias.float().contiguous()
    # broadcast axes read through a stride of 0
    bias_strides = (0, 0, 0, 0) if bias is None else bias.expand(b, h, sq, sk).stride()
    out = torch.empty((b, sq, h, dv), dtype=torch.float32, device=q.device).transpose(1, 2)
    p = _cuda.ptr
    _cuda.launch(
        "ovq_single_query_attention_forward" if block == "single" else "ovq_flat_attention_forward",
        p(q), *_flat_strides(q, "q"), p(k), *_flat_strides(k, "k"), p(v), *_flat_strides(v, "v"),
        p(bias), *bias_strides, p(out), sq * h * dv, dv, h * dv,
        b, h, sq, sk, dk, dv, scale,
    )
    _cuda.count("fused_attention")
    return out


class FlatAttention(torch.autograd.Function):
    """The flat attention with ``_bwd``'s analytic backward in plain PyTorch."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale: float, use_kernel: bool):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        if use_kernel:
            return _flat_kernel(q, k, v, bias, scale)
        return fused_attention_plain(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = fused_attention_backward_plain(q, k, v, bias, g, ctx.scale)
        return dq, dk, dv, dbias if ctx.needs_input_grad[3] else None, None, None


def fused_attention(q, k, v, bias, scale: float):
    """softmax(q k^T * scale + bias) v on split-head operands: q (b, h, Sq,
    d_k), k (b, h, Sk, d_k), v (b, h, Sk, d_v) float32, read through their
    strides (head-split views of packed projections pass without a copy);
    bias (b|1, h|1, Sq|1, Sk|1) or None: a constant, per-sample, per-head or
    key-padding bias, never broadcast in memory.  Returns (b, h, Sq, d_v),
    laid out as (b, Sq, h, d_v) on the card so that merging the heads is a
    view.  d_k may differ from d_v (the TPU kernel takes v at q's width only)."""
    _check_flat(q, k, v, bias)
    tensors = (q, k, v) if bias is None else (q, k, v, bias)
    use_kernel = _cuda.uses_kernel(*tensors)
    if use_kernel and not _needs_grad(tensors):
        return _flat_kernel(q, k, v, bias, scale)  # no graph to record
    return FlatAttention.apply(q, k, v, bias, scale, use_kernel)
