"""The decode-step kernels, each beside its plain PyTorch version: kernel C (the
FFN sublayer on rows), kernel D (one M4C decode token's self-attention sublayer
over [frozen context | decoded slots]), kernel A (one decode token's stateful
self-attention sublayer over a ring cache), kernel B (its cross-attention
sublayer over cached encoder K/V), kernel E (the Iterative M4C family's
cross-attention sublayer over frozen encoder K/V, LayerNorm eps an argument)
and the decoder-layer step (A, B, then C in one call).

Counterparts of ``fused_ffn_step``, ``fused_bert_self_step``,
``fused_self_attention_step``, ``fused_cross_attention_step``,
``fused_cross_attention_streamed`` and ``fused_decoder_layer_step`` in
``openvivqa_tpu/ops/decode_step.py``.  The CUDA
sources are ``csrc/ffn.cu`` and ``csrc/decoder_layer_step.cu``; their notes
say what bounds each on the H100.

Numerics, the same in a kernel and its plain version: activations, softmax,
LayerNorm and accumulators are float32; every projection casts its activation
to the weight's dtype (bf16 on the card, where the weights are pre-cast once,
float32 on the CPU) and accumulates in float32; an attention reads float32
queries against keys and values as their cache stores them.  The GELU is the
exact erf one everywhere (the TPU FFN kernel's A&S 7.1.26 erf is a Mosaic
workaround, not carried over).

Kernel C's two products run on gemm_sm90.cu's wgmma + TMA core under the plans
of ``_cuda.gemm_plan`` (``ffn_plans``), in its own entry and inside the layer step.
Kernels A, B, D, E and the layer step are one persistent cooperative launch
each (``csrc/decoder_layer_step.cu``), cut over the card by ``step_plan``: the
grid, its shared memory, each product's K slice and the one workspace's buffers.
The ring caches and slot caches are written IN PLACE; the wrappers return the
tensors they were given.
"""

from __future__ import annotations

import os
import functools
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import _cuda

MASK_VALUE = -10e4  # equal to models/modules/masks.py MASK_VALUE
_LN_EPS = 1e-6  # flax nn.LayerNorm default, as in the JAX package


_PARTS = {"layer", "self", "cross", "ffn", "none"}


def decode_kernel_parts() -> frozenset:
    """Which fused decode stages engage, from OPENVIVQA_DECODE_KERNEL_PARTS: a
    comma-separated subset of {layer, self, cross, ffn, none}.  'layer' (the
    default) is the whole-decoder-layer step; the stage kernels exist for
    attribution; 'none' leaves every stage to the modules' plain route."""
    parts = os.environ.get("OPENVIVQA_DECODE_KERNEL_PARTS", "")
    if not parts:
        return frozenset({"layer"})
    chosen = frozenset(p.strip().lower() for p in parts.split(",") if p.strip())
    unknown = chosen - _PARTS
    if unknown:
        # a mistyped value would otherwise silently disable every fused stage
        raise ValueError(
            f"OPENVIVQA_DECODE_KERNEL_PARTS: unknown part(s) {sorted(unknown)}; "
            "expected comma-separated subset of layer,self,cross,ffn,none"
        )
    return chosen


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with a rounded to w's dtype and a float32 result."""
    return a.to(w.dtype).float() @ w.float()


def _single_query_attention(q, keys, values, bias, scale: float, h: int):
    """softmax(scale * q . keys + bias) values per head: q (rows, hd) float32,
    keys/values (rows, S, hd) as stored, bias (rows, S).  Returns (rows, hd)."""
    rows, hd = q.shape
    d = hd // h
    k = keys.float().view(rows, -1, h, d)
    v = values.float().view(rows, -1, h, d)
    logits = torch.einsum("bhd,bkhd->bhk", q.view(rows, h, d), k) * scale
    weights = torch.softmax(logits + bias[:, None, :], dim=-1)
    return torch.einsum("bhk,bkhd->bhd", weights, v).reshape(rows, hd)


def _out_residual_ln(x, context, w, eps: float):
    out = _dot(context, w["wo"]) + w["bo"]
    return F.layer_norm(x + out, (x.shape[-1],), w["ln_scale"], w["ln_bias"], eps)


def _require_rows(x, what: str) -> Tuple[int, int]:
    """(rows, hd) of the float32 row block every step kernel takes."""
    if x.ndim != 2:
        raise ValueError(f"{what}: x must be (rows, hd), got {tuple(x.shape)}")
    rows, hd = x.shape
    _cuda.require_width(hd, what)
    _cuda.require(x, "x", torch.float32, (rows, hd))
    return rows, hd


def _require_ffn_weights(w1, b1, w2, b2, ln_scale, ln_bias, hd: int) -> int:
    d_ff = w1.shape[-1]
    if d_ff % 8:
        raise ValueError(f"d_ff {d_ff} is not a multiple of 8 (16-byte TMA strides)")
    _cuda.require(w1, "w1", torch.bfloat16, (hd, d_ff))
    _cuda.require(w2, "w2", torch.bfloat16, (d_ff, hd))
    for name, vec, n in (("b1", b1, d_ff), ("b2", b2, hd),
                         ("ln_scale", ln_scale, hd), ("ln_bias", ln_bias, hd)):
        _cuda.require(vec, name, torch.float32, (n,))
    return d_ff


def _require_attention_weights(w, in_name: str, in_width: int, hd: int, h: int) -> None:
    """The bf16 in-projection w[in_name] (hd, in_width) with its bias
    'b' + in_name[1:], the bf16 out projection and the float32 vectors."""
    if h <= 0 or hd % h or hd // h > 256:
        raise ValueError(f"head dim {hd}/{h} must be an integer of at most 256")
    _cuda.require(w[in_name], in_name, torch.bfloat16, (hd, in_width))
    _cuda.require(w["b" + in_name[1:]], "b" + in_name[1:], torch.float32, (in_width,))
    _cuda.require(w["wo"], "wo", torch.bfloat16, (hd, hd))
    for name in ("bo", "ln_scale", "ln_bias"):
        _cuda.require(w[name], name, torch.float32, (hd,))


def _require_kv(k, v, names, rows: int, hd: int) -> Tuple[int, int]:
    """(keys, 1 if bf16 else 0) of a (rows, keys, hd) float32 or bf16 K/V pair."""
    if k.ndim != 3 or k.shape[1] == 0:
        raise ValueError(f"{names[0]}: expected (rows, keys >= 1, hd), got {tuple(k.shape)}")
    if k.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{names[0]}: expected float32 or bfloat16, got {k.dtype}")
    keys = k.shape[1]
    _cuda.require(k, names[0], k.dtype, (rows, keys, hd))
    _cuda.require(v, names[1], k.dtype, (rows, keys, hd))
    return keys, int(k.dtype == torch.bfloat16)


# ---------------------------------------------------------------------------
# kernel C
# ---------------------------------------------------------------------------
def fused_ffn_step_plain(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float = _LN_EPS):
    hidden = F.gelu(_dot(x, w1) + b1)
    out = _dot(hidden, w2) + b2
    return F.layer_norm(x + out, (x.shape[-1],), ln_scale, ln_bias, eps)


def ffn_plans(rows: int, hd: int, d_ff: int) -> Tuple[_cuda.GemmPlan, _cuda.GemmPlan]:
    """Kernel C's two products: x @ w1 with the GELU epilogue, hidden @ w2 with
    the residual + LayerNorm one."""
    return _cuda.gemm_plan(rows, d_ff, hd, "bias"), _cuda.gemm_plan(rows, hd, d_ff, "ln")


def _ffn_workspace(rows: int, hd: int, d_ff: int, plans, device):
    """Kernel C's bf16 x, bf16 hidden and the split route's f32 partial tiles
    (a 1-element placeholder when no product splits)."""
    floats = max(plans[0].partial_floats(rows, d_ff), plans[1].partial_floats(rows, hd), 1)
    return (torch.empty((rows, hd), dtype=torch.bfloat16, device=device),
            torch.empty((rows, d_ff), dtype=torch.bfloat16, device=device),
            torch.empty(floats, dtype=torch.float32, device=device))


def _ffn_launch(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float):
    """Kernel C's launch on checked operands, under ffn_plans."""
    rows, hd = x.shape
    d_ff = w1.shape[1]
    plans = ffn_plans(rows, hd, d_ff)
    xb, hidden, partial = _ffn_workspace(rows, hd, d_ff, plans, x.device)
    y = torch.empty_like(x)
    p = _cuda.ptr
    _cuda.launch(
        "ovq_ffn_forward", p(x), p(w1), p(b1), p(w2), p(b2), p(ln_scale), p(ln_bias), p(xb),
        p(hidden), p(partial), p(y), rows, hd, d_ff, *plans[0], *plans[1], eps,
    )
    return y


def fused_ffn_step(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float = _LN_EPS):
    """LayerNorm(x + GELU(x @ w1 + b1) @ w2 + b2) on (rows, hd) float32 rows.
    On the card w1 (hd, d_ff) and w2 (d_ff, hd) are bf16, the rest float32."""
    if not _cuda.uses_kernel(x, w1, b1, w2, b2, ln_scale, ln_bias):
        return fused_ffn_step_plain(x, w1, b1, w2, b2, ln_scale, ln_bias, eps)
    rows, hd = _require_rows(x, "fused_ffn_step")
    _require_ffn_weights(w1, b1, w2, b2, ln_scale, ln_bias, hd)
    y = _ffn_launch(x, w1, b1, w2, b2, ln_scale, ln_bias, eps)
    _cuda.count("fused_ffn_step", rows)
    return y


# ---------------------------------------------------------------------------
# the persistent step kernel's plan (kernels A, B, D, E and the layer step)
# ---------------------------------------------------------------------------
STEP_TILE = 64  # the products' 64 x 64 output tiles and 64-deep K blocks
STEP_RING_BYTES = 1024 + 4 * (2 * 64 * 64 * 2) + 2 * 4 * 8  # alignment, 4 stages, barriers
STEP_ITEM_WARPS = 4  # one attention item: a warpgroup
# A's, D's and B's products (q|k|v or q, then the out projection) in the C
# entry's order: their widths N in units of hd (K is hd)
_STEP_PRODUCTS = {"self": (3, 1), "bert_self": (3, 1), "cross": (1, 1)}


class StepPlan(NamedTuple):
    """How one call of the step kernel is cut over the card."""

    ctas: int  # the persistent grid: every CTA resident at once
    smem: int  # dynamic shared memory of a CTA
    k_slices: Tuple[int, ...]  # each product's K slice, in the C entry's order
    splits: Tuple[int, ...]  # and its K splits
    # the workspace's buffers: (name, byte offset, bytes), in the C entry's order
    buffers: Tuple[Tuple[str, int, int], ...]
    workspace_bytes: int


def step_head_block(d: int) -> int:
    """The head-dim instance of the step kernel's attention (64, 128 or 256)."""
    return 64 if d <= 64 else (128 if d <= 128 else 256)


def step_smem_bytes(d: int, keys: int) -> int:
    """The step kernel's dynamic shared memory: the TMA ring, the LayerNorm's 8
    words and two attention items' scratch (q, the logits of `keys` keys, four
    warps' partial outputs, four words); decoder_layer_step.cu checks it."""
    dn = step_head_block(d)
    item = dn + -(-keys // 4) * 4 + STEP_ITEM_WARPS * dn + STEP_ITEM_WARPS
    return STEP_RING_BYTES + 4 * 8 + 2 * 4 * item


def step_prefetch_lines(nbytes: int, ctas: int, cta: int) -> range:
    """The 128-byte lines of an nbytes buffer that CTA `cta` of the step
    kernel's grid asks L2 to prefetch (decoder_layer_step.cu's
    prefetch_share)."""
    lines = -(-nbytes // 128)
    per = -(-lines // ctas)
    return range(min(cta * per, lines), min((cta + 1) * per, lines))


def _split_slice(m: int, n: int, k: int) -> int:
    """The K slice of one of A's or B's products (and of the layer step's FFN
    products past kernel C's split route): gemm_plan's split where it splits,
    else all of K in one slice (the step kernel's products always write
    partial tiles and sum them where they are read)."""
    plan = _cuda.gemm_plan(m, n, k, "bias")
    return plan.k_slice if plan.cluster == 0 else -(-k // STEP_TILE) * STEP_TILE


def _align(n: int) -> int:
    return -(-n // 256) * 256


@functools.lru_cache(maxsize=None)
def step_plan(kind: str, rows: int, hd: int, heads: int, keys: int, d_ff: int = 0,
              sm_count: int = _cuda.SM_COUNT) -> StepPlan:
    """The plan of one call of the step kernel: `kind` "self" (kernel A, `keys`
    = the ring's T), "bert_self" (kernel D, `keys` = C + T: the frozen
    context's keys and the slots in one logits row), "cross" (kernels B and E,
    `keys` = Sk) or "layer" (`keys` = max(T, Sk), with kernel C's FFN of width
    d_ff).  A's, D's and B's products
    take gemm_plan's split of K.  The layer step's FFN phase takes ffn_plans
    exactly where kernel C's route at this row count is the 64 x 64 split one
    (or the unsplit 64 x 64 bias tile for the first product, the same sums), so
    that it is bit-equal to kernel C there; at more rows (past 512 at hd 512,
    320 at hd 768) its products take A's and B's rule.  Two CTAs per SM where
    their shared memory fits, else one."""
    _cuda.require_width(hd, "step_plan")
    d = hd // heads
    if kind not in ("self", "bert_self", "cross", "layer"):
        raise ValueError(f"step_plan: unknown kind {kind!r}")
    products = []  # (splits, k_slice, n) of each product
    for sublayer in (("self", "cross") if kind == "layer" else (kind,)):
        for n in _STEP_PRODUCTS[sublayer]:
            k_slice = _split_slice(rows, n * hd, hd)
            products.append((-(-hd // k_slice), k_slice, n * hd))
    if kind == "layer":
        # the GELU product may run its epilogue in the GEMM (cluster 1: one split,
        # whose sum the reduce pass repeats), the LayerNorm product must split
        plans = ffn_plans(rows, hd, d_ff)
        if all((plan.bm, plan.bn) == (STEP_TILE, STEP_TILE) and plan.cluster <= most
               for plan, most in zip(plans, (1, 0))):
            products += [(plan.splits, plan.k_slice, n) for plan, n in zip(plans, (d_ff, hd))]
        else:
            for n, k in ((d_ff, hd), (hd, d_ff)):
                k_slice = _split_slice(rows, n, k)
                products.append((-(-k // k_slice), k_slice, n))
    smem = step_smem_bytes(d, keys)
    if smem > _cuda.MAX_SMEM_BYTES:
        raise ValueError(f"step_plan: {keys} keys need {smem} bytes of shared memory")
    per_sm = 2 if smem <= _cuda.SMEM_PER_SM // 2 - 1024 else 1
    bf16_rows, f32_rows = rows * hd * 2, rows * hd * 4
    sizes = [("xb", bf16_rows)]
    if kind == "layer":
        sizes += [("ctx_s", bf16_rows), ("y1", f32_rows), ("y1b", bf16_rows),
                  ("ctx_c", bf16_rows), ("y2", f32_rows), ("y2b", bf16_rows),
                  ("hidden", rows * d_ff * 2)]
    else:
        sizes.append(("ctx", bf16_rows))
    sizes.append(("partial", 4 * max(splits * rows * n for splits, _, n in products)))
    buffers, offset = [], 0
    for name, size in sizes:
        buffers.append((name, offset, size))
        offset += _align(size)
    return StepPlan(per_sm * sm_count, smem, tuple(k for _, k, _ in products),
                    tuple(s for s, _, _ in products), tuple(buffers), offset)


def _step_workspace(plan: StepPlan, device):
    """The one workspace tensor of a step call (the caller holds it until the
    launch is enqueued) and its buffers' addresses."""
    workspace = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=device)
    base = workspace.data_ptr()
    return workspace, [base + offset for _, offset, _ in plan.buffers]


def _attention_pointers(w, in_name: str):
    p = _cuda.ptr
    return (p(w[in_name]), p(w["b" + in_name[1:]]), p(w["wo"]), p(w["bo"]),
            p(w["ln_scale"]), p(w["ln_bias"]))


# ---------------------------------------------------------------------------
# kernel D
# ---------------------------------------------------------------------------
def _slot(step: int, n_slots: int) -> int:
    # a step past the last slot overwrites the last slot, like the JAX
    # package's clamped dynamic_update_slice
    return min(int(step), n_slots - 1)


def fused_bert_self_step_plain(
    x, w: Dict[str, torch.Tensor], ctx_kv, slot_k, slot_v, step: int, ctx_bias,
    scale: float, h: int, eps: float,
):
    bs, hd = x.shape
    n_slots = slot_k.shape[1]
    t = _slot(step, n_slots)
    q, k_new, v_new = (_dot(x, w["wqkv"]) + w["bqkv"]).split(hd, dim=-1)
    slot_k[:, t] = k_new.to(slot_k.dtype)
    slot_v[:, t] = v_new.to(slot_v.dtype)
    slot_bias = torch.where(
        torch.arange(n_slots, device=x.device) <= t, 0.0, MASK_VALUE
    ).to(torch.float32)
    bias = torch.cat([ctx_bias, slot_bias.expand(bs, n_slots)], dim=1)
    context = _single_query_attention(
        q, torch.cat([ctx_kv[0], slot_k], dim=1), torch.cat([ctx_kv[1], slot_v], dim=1),
        bias, scale, h,
    )
    return _out_residual_ln(x, context, w, eps), slot_k, slot_v


def fused_bert_self_step(
    x, w: Dict[str, torch.Tensor], ctx_kv: Tuple[torch.Tensor, torch.Tensor],
    slot_k, slot_v, step: int, ctx_bias, scale: float, h: int, eps: float,
):
    """One decode token's self-attention sublayer: q|k|v projection of x (bs, hd),
    the new k/v written into slot min(step, T-1) of slot_k/slot_v (bs, T, hd) IN
    PLACE, one softmax over [ctx K/V (bs, C, hd), read-only | slots <= that slot],
    out projection, residual and LayerNorm.  ctx_bias (bs, C) float32 carries
    MASK_VALUE on padded context keys.  w holds wqkv (hd, 3hd), bqkv, wo (hd, hd),
    bo, ln_scale, ln_bias.  On the card the context and the slots are bf16, and
    the call is one launch of the step kernel (``step_plan("bert_self", ...)``);
    a context too long for its shared memory raises.  Returns (y, slot_k,
    slot_v)."""
    tensors = (x, ctx_kv[0], ctx_kv[1], slot_k, slot_v, ctx_bias, *w.values())
    if not _cuda.uses_kernel(*tensors):
        return fused_bert_self_step_plain(
            x, w, ctx_kv, slot_k, slot_v, step, ctx_bias, scale, h, eps
        )
    if slot_k.ndim != 3 or ctx_kv[0].ndim != 3:
        raise ValueError("ctx K/V and slots must be (bs, rows, hd)")
    bs, hd = _require_rows(x, "fused_bert_self_step")
    ctx_len, n_slots = ctx_kv[0].shape[1], slot_k.shape[1]
    _require_attention_weights(w, "wqkv", 3 * hd, hd, h)
    for name, cache in (("ctx_k", ctx_kv[0]), ("ctx_v", ctx_kv[1])):
        _cuda.require(cache, name, torch.bfloat16, (bs, ctx_len, hd))
    if n_slots == 0:
        raise ValueError("slot_k: expected (bs, T >= 1, hd), got T = 0")
    for name, cache in (("slot_k", slot_k), ("slot_v", slot_v)):
        _cuda.require(cache, name, torch.bfloat16, (bs, n_slots, hd))
    _cuda.require(ctx_bias, "ctx_bias", torch.float32, (bs, ctx_len))
    plan = step_plan("bert_self", bs, hd, h, ctx_len + n_slots, 0, _cuda.sm_count(x.device))
    workspace, buffers = _step_workspace(plan, x.device)
    y = torch.empty_like(x)
    p = _cuda.ptr
    _cuda.launch(
        "ovq_bert_self_step_forward", p(x), *_attention_pointers(w, "wqkv"),
        p(ctx_kv[0]), p(ctx_kv[1]), p(ctx_bias), p(slot_k), p(slot_v), *buffers, p(y),
        bs, ctx_len, n_slots, _slot(step, n_slots), hd, h, *plan.k_slices, plan.ctas, plan.smem,
        scale, eps,
    )
    _cuda.count("fused_bert_self_step")
    return y, slot_k, slot_v


# ---------------------------------------------------------------------------
# kernel A
# ---------------------------------------------------------------------------
def fused_self_attention_step_plain(
    x, w: Dict[str, torch.Tensor], step_bias, step: int, cache_k, cache_v, cache_bias,
    scale: float, h: int, eps: float = _LN_EPS,
):
    hd = x.shape[1]
    max_len = cache_k.shape[1]
    t = _slot(step, max_len)
    q, k_new, v_new = (_dot(x, w["wqkv"]) + w["bqkv"]).split(hd, dim=-1)
    cache_k[:, t] = k_new.to(cache_k.dtype)
    cache_v[:, t] = v_new.to(cache_v.dtype)
    cache_bias[:, t] = step_bias
    future = torch.where(
        torch.arange(max_len, device=x.device) > t, MASK_VALUE, 0.0
    ).to(torch.float32)
    context = _single_query_attention(q, cache_k, cache_v, cache_bias + future, scale, h)
    return _out_residual_ln(x, context, w, eps), cache_k, cache_v, cache_bias


def _require_ring(step_bias, cache_k, cache_v, cache_bias, rows: int, hd: int) -> Tuple[int, int]:
    max_len, is_bf16 = _require_kv(cache_k, cache_v, ("cache_k", "cache_v"), rows, hd)
    _cuda.require(cache_bias, "cache_bias", torch.float32, (rows, max_len))
    _cuda.require(step_bias, "step_bias", torch.float32, (rows,))
    return max_len, is_bf16


def fused_self_attention_step(
    x, w: Dict[str, torch.Tensor], step_bias, step: int, cache_k, cache_v, cache_bias,
    scale: float, h: int, eps: float = _LN_EPS,
):
    """One stateful decode step of a self-attention sublayer: q|k|v projection of
    x (rows, hd), the new k, v and the token's padding bias step_bias (rows,)
    written IN PLACE at slot min(step, T-1) of the ring cache_k/cache_v (rows, T,
    hd; float32 or bf16) and cache_bias (rows, T), attention over the ring with
    slots past that one masked, out projection, residual and LayerNorm(eps).  w
    holds wqkv (hd, 3hd), bqkv, wo (hd, hd), bo, ln_scale, ln_bias.  Returns
    (y, cache_k, cache_v, cache_bias)."""
    tensors = (x, step_bias, cache_k, cache_v, cache_bias, *w.values())
    if not _cuda.uses_kernel(*tensors):
        return fused_self_attention_step_plain(
            x, w, step_bias, step, cache_k, cache_v, cache_bias, scale, h, eps
        )
    rows, hd = _require_rows(x, "fused_self_attention_step")
    _require_attention_weights(w, "wqkv", 3 * hd, hd, h)
    max_len, cache_bf16 = _require_ring(step_bias, cache_k, cache_v, cache_bias, rows, hd)
    plan = step_plan("self", rows, hd, h, max_len, 0, _cuda.sm_count(x.device))
    workspace, buffers = _step_workspace(plan, x.device)
    y = torch.empty_like(x)
    p = _cuda.ptr
    _cuda.launch(
        "ovq_self_attention_step_forward", p(x), *_attention_pointers(w, "wqkv"), p(step_bias),
        p(cache_k), p(cache_v), p(cache_bias), *buffers, p(y), rows, max_len,
        _slot(step, max_len), hd, h, cache_bf16, *plan.k_slices, plan.ctas, plan.smem, scale, eps,
    )
    _cuda.count("fused_self_attention_step")
    return y, cache_k, cache_v, cache_bias


# ---------------------------------------------------------------------------
# kernel B
# ---------------------------------------------------------------------------
def fused_cross_attention_step_plain(
    x, w: Dict[str, torch.Tensor], enc_k, enc_v, enc_bias, scale: float, h: int,
    eps: float = _LN_EPS,
):
    q = _dot(x, w["wq"]) + w["bq"]
    context = _single_query_attention(q, enc_k, enc_v, enc_bias, scale, h)
    return _out_residual_ln(x, context, w, eps)


def _cross_attention_kernel(entry: str, what: str, x, w, enc_k, enc_v, enc_bias, scale: float,
                            h: int, eps: float):
    """Kernels B and E: validate, launch `entry`, count `what`."""
    rows, hd = _require_rows(x, what)
    _require_attention_weights(w, "wq", hd, hd, h)
    sk, enc_bf16 = _require_kv(enc_k, enc_v, ("enc_k", "enc_v"), rows, hd)
    _cuda.require(enc_bias, "enc_bias", torch.float32, (rows, sk))
    plan = step_plan("cross", rows, hd, h, sk, 0, _cuda.sm_count(x.device))
    workspace, buffers = _step_workspace(plan, x.device)
    y = torch.empty_like(x)
    p = _cuda.ptr
    _cuda.launch(
        entry, p(x), *_attention_pointers(w, "wq"), p(enc_k), p(enc_v), p(enc_bias), *buffers,
        p(y), rows, sk, hd, h, enc_bf16, *plan.k_slices, plan.ctas, plan.smem, scale, eps,
    )
    _cuda.count(what)
    return y


def fused_cross_attention_step(
    x, w: Dict[str, torch.Tensor], enc_k, enc_v, enc_bias, scale: float, h: int,
    eps: float = _LN_EPS,
):
    """One decode step of a cross-attention sublayer: q projection of x (rows,
    hd), attention over the cached encoder projections enc_k/enc_v (rows, Sk,
    hd; float32 or bf16) under enc_bias (rows, Sk) float32, out projection,
    residual and LayerNorm.  w holds wq (hd, hd), bq, wo, bo, ln_scale, ln_bias.
    Returns the post-LN rows (rows, hd)."""
    tensors = (x, enc_k, enc_v, enc_bias, *w.values())
    if not _cuda.uses_kernel(*tensors):
        return fused_cross_attention_step_plain(x, w, enc_k, enc_v, enc_bias, scale, h, eps)
    return _cross_attention_kernel("ovq_cross_attention_step_forward",
                                   "fused_cross_attention_step",
                                   x, w, enc_k, enc_v, enc_bias, scale, h, eps)


# ---------------------------------------------------------------------------
# kernel E
# ---------------------------------------------------------------------------
def fused_cross_attention_streamed_plain(
    x, w: Dict[str, torch.Tensor], enc_kv, enc_bias, scale: float, h: int, eps: float,
):
    return fused_cross_attention_step_plain(x, w, *enc_kv, enc_bias, scale, h, eps)


def fused_cross_attention_streamed(
    x, w: Dict[str, torch.Tensor], enc_kv: Tuple[torch.Tensor, torch.Tensor], enc_bias,
    scale: float, h: int, eps: float,
):
    """One decode token's cross-attention sublayer over the frozen encoder
    projections of the Iterative M4C family: q projection of x (rows, hd), one
    softmax per head over enc_kv = (k, v) (rows, S, hd; bf16 on the card, float32
    also taken) under enc_bias (rows, S) float32, out projection, residual and
    LayerNorm(eps).  w holds wq (hd, hd), bq, wo, bo, ln_scale, ln_bias.  The
    encoder K/V is not padded to a chunk multiple, as the JAX package's VMEM
    layout needs.  Kernel B's function behind its own entry and launch count.
    Returns the post-LN rows (rows, hd)."""
    tensors = (x, *enc_kv, enc_bias, *w.values())
    if not _cuda.uses_kernel(*tensors):
        return fused_cross_attention_streamed_plain(x, w, enc_kv, enc_bias, scale, h, eps)
    return _cross_attention_kernel("ovq_cross_attention_streamed_forward",
                                   "fused_cross_attention_streamed",
                                   x, w, *enc_kv, enc_bias, scale, h, eps)


# ---------------------------------------------------------------------------
# the decoder-layer step: A, then B, then C
# ---------------------------------------------------------------------------
def fused_decoder_layer_step_plain(
    x, self_w, cross_w, ffn_w, step_bias, step: int, cache_k, cache_v, cache_bias,
    enc_k, enc_v, enc_bias, scale: float, h: int,
):
    y, _, _, _ = fused_self_attention_step_plain(
        x, self_w, step_bias, step, cache_k, cache_v, cache_bias, scale, h
    )
    y = fused_cross_attention_step_plain(y, cross_w, enc_k, enc_v, enc_bias, scale, h)
    f = ffn_w
    y = fused_ffn_step_plain(y, f["w1"], f["b1"], f["w2"], f["b2"], f["ln_scale"], f["ln_bias"])
    return y, cache_k, cache_v, cache_bias


def fused_decoder_layer_step(
    x, self_w, cross_w, ffn_w, step_bias, step: int, cache_k, cache_v, cache_bias,
    enc_k, enc_v, enc_bias, scale: float, h: int,
):
    """One whole decoder-layer decode step in one call: the stateful
    self-attention sublayer (``fused_self_attention_step``), the cross-attention
    sublayer over the cached encoder K/V (``fused_cross_attention_step``) and the
    FFN sublayer (``fused_ffn_step``), LayerNorm eps 1e-6 throughout.  Weight
    dicts: self_w wqkv, bqkv, wo, bo, ln_scale, ln_bias; cross_w wq, bq, wo, bo,
    ln_scale, ln_bias; ffn_w w1, b1, w2, b2, ln_scale, ln_bias.  On the card the
    weight matrices are bf16 and the encoder K/V usually too (pre-cast once per
    generate); the ring is written in place.  Returns (y, cache_k, cache_v,
    cache_bias)."""
    tensors = (x, step_bias, cache_k, cache_v, cache_bias, enc_k, enc_v, enc_bias,
               *self_w.values(), *cross_w.values(), *ffn_w.values())
    if not _cuda.uses_kernel(*tensors):
        return fused_decoder_layer_step_plain(
            x, self_w, cross_w, ffn_w, step_bias, step, cache_k, cache_v, cache_bias,
            enc_k, enc_v, enc_bias, scale, h,
        )
    rows, hd = _require_rows(x, "fused_decoder_layer_step")
    _require_attention_weights(self_w, "wqkv", 3 * hd, hd, h)
    _require_attention_weights(cross_w, "wq", hd, hd, h)
    f = ffn_w
    d_ff = _require_ffn_weights(f["w1"], f["b1"], f["w2"], f["b2"], f["ln_scale"], f["ln_bias"], hd)
    max_len, cache_bf16 = _require_ring(step_bias, cache_k, cache_v, cache_bias, rows, hd)
    sk, enc_bf16 = _require_kv(enc_k, enc_v, ("enc_k", "enc_v"), rows, hd)
    _cuda.require(enc_bias, "enc_bias", torch.float32, (rows, sk))

    plan = step_plan("layer", rows, hd, h, max(max_len, sk), d_ff, _cuda.sm_count(x.device))
    workspace, buffers = _step_workspace(plan, x.device)
    y = torch.empty_like(x)
    p = _cuda.ptr
    _cuda.launch(
        "ovq_decoder_layer_step_forward", p(x), *_attention_pointers(self_w, "wqkv"),
        *_attention_pointers(cross_w, "wq"), p(f["w1"]), p(f["b1"]), p(f["w2"]), p(f["b2"]),
        p(f["ln_scale"]), p(f["ln_bias"]), p(step_bias), p(cache_k), p(cache_v), p(cache_bias),
        p(enc_k), p(enc_v), p(enc_bias), *buffers, p(y), rows, max_len, _slot(step, max_len), sk,
        hd, h, d_ff, cache_bf16, enc_bf16, *plan.k_slices, plan.ctas, plan.smem, scale, _LN_EPS,
    )
    _cuda.count("fused_decoder_layer_step")
    return y, cache_k, cache_v, cache_bias
