"""Plain PyTorch building blocks of the references: BERT layers, the M4C
feature encodings and pointer net, the dropout stream, the loss and Adam,
written from the published descriptions over weights held by name.

Nothing here imports the port.  Products go through :class:`Precision`: float32
with TF32 off for the reference itself, or a lower precision for the control
(each operand rounded to bf16, or to fp8 e4m3 under a per-tensor scale).

Dropout follows the training run's stream: one generator on the device seeded
with TRAINING.SEED, drawn in the order the model reads it: a uniform draw of
the activation's shape for each dropout, and one int64 seed in [0, 2^31 - 1)
for each attention's weights, whose keep mask is Philox4x32-10 keyed by that
seed, counted by (key column // 4, query row, head, sample), word key column
% 4, dropped where (word >> 9) < rate * 2^23 (the attention kernels' mask,
worked out again here).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F

MASK_VALUE = -1e5  # the additive mask of M4C's attention biases
BERT_LN_EPS = 1e-12
TORCH_LN_EPS = 1e-5  # the feature encodings' nn.LayerNorm
DROPOUT = 0.1
FP8_MAX = 448.0  # largest finite float8 e4m3


@contextlib.contextmanager
def float32_products() -> Iterator[None]:
    """TF32 off while the reference runs; the settings found are restored."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Precision:
    """How the reference computes a product: "fp32", "bf16" (operands and
    result rounded to bf16, float32 accumulation: an autocast bf16 GEMM),
    "fp8" (operands rounded to e4m3 under a per-tensor scale), or
    "bf16_attention" (float32, but the attention products' operands rounded
    to bf16: the precision the training configurations state, a witness of
    what rounding alone moves)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "bf16", "fp8", "bf16_attention"):
            raise ValueError(f"no precision {name!r}")
        self.name = name

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
            return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "bf16":
            return torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16)).float()
        return torch.matmul(self.operand(a), self.operand(b))

    def einsum(self, spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "bf16_attention":
            return torch.einsum(spec, a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())
        if self.name == "bf16":
            return torch.einsum(spec, a.to(torch.bfloat16), b.to(torch.bfloat16)).float()
        return torch.einsum(spec, self.operand(a), self.operand(b))


class Dropout:
    """The training run's dropout stream (see the module docstring); None
    where the model runs without dropout."""

    def __init__(self, seed: int, device):
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(seed))
        self.device = device

    def __call__(self, x: torch.Tensor, rate: float = DROPOUT) -> torch.Tensor:
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= rate
        return x * keep / (1.0 - rate)

    def attention_factors(self, b: int, heads: int, sq: int, sk: int,
                          rate: float = DROPOUT) -> torch.Tensor:
        seed = torch.randint(0, 2**31 - 1, (1,), generator=self.generator, device=self.device)
        keep = (philox_words(seed, b, heads, sq, sk) >> 9) >= min(int(rate * (1 << 23)),
                                                                  (1 << 23) - 1)
        return keep.float() / (1.0 - rate)


_MASK32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int):
    m_hi, m_lo = m >> 16, m & 0xFFFF
    a_hi, a_lo = a >> 16, a & 0xFFFF
    mid = a_hi * m_lo + a_lo * m_hi
    low = a_lo * m_lo + ((mid & 0xFFFF) << 16)
    high = a_hi * m_hi + (mid >> 16) + (low >> 32)
    return high & _MASK32, low & _MASK32


def philox_words(seed: torch.Tensor, b: int, heads: int, sq: int, sk: int) -> torch.Tensor:
    """(b, heads, Sq, Sk) int64: Philox4x32-10 of counter (key column // 4,
    query row, head, sample) under key (seed low, seed high), word key
    column % 4."""
    device = seed.device

    def axis(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)

    seed = seed.reshape(1, 1, 1, 1).to(torch.int64)
    c0, c1, c2, c3 = axis(-(-sk // 4), 3), axis(sq, 2), axis(heads, 1), axis(b, 0)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK32
        k1 = (k1 + 0xBB67AE85) & _MASK32
    words = torch.stack(torch.broadcast_tensors(c0, c1, c2, c3), dim=-1)
    return words.reshape(b, heads, sq, -1)[..., :sk]


class Blocks:
    """The model's pieces over weights `w` (by the HF / reference parameter
    names), computing products at `precision`, drawing dropout from `drop`
    (None: no dropout)."""

    def __init__(self, w: Dict[str, torch.Tensor], precision: Precision,
                 drop: Optional[Dropout]):
        self.w, self.p, self.drop = w, precision, drop

    def dropout(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.drop is None else self.drop(x)

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        out = self.p.matmul(x, self.w[f"{name}.weight"].t())
        bias = self.w.get(f"{name}.bias")
        return out if bias is None else out + bias

    def layer_norm(self, x: torch.Tensor, name: str, eps: float) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                            eps)

    def attention(self, q, k, v, bias, heads: int) -> torch.Tensor:
        """softmax(q k^T / sqrt(d) + bias) v over `heads` heads of (b, S, h)
        projections, the weights dropped out in training."""
        b, sq, hd = q.shape
        sk, d = k.shape[1], hd // heads
        qh = q.reshape(b, sq, heads, d)
        kh = k.reshape(b, sk, heads, d)
        vh = v.reshape(b, sk, heads, d)
        logits = self.p.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(d) + bias
        weights = torch.softmax(logits, dim=-1)
        if self.drop is not None:
            weights = weights * self.drop.attention_factors(b, heads, sq, sk)
        return self.p.einsum("bhqk,bkhd->bqhd", weights, vh).reshape(b, sq, hd)

    def bert_attention(self, x, bias, name: str, heads: int, kv=None) -> torch.Tensor:
        """BERT's attention sublayer (post-LN); a cross-attention when `kv`
        holds the states its keys and values project."""
        kv = x if kv is None else kv
        q = self.linear(x, f"{name}.self.query")
        k = self.linear(kv, f"{name}.self.key")
        v = self.linear(kv, f"{name}.self.value")
        context = self.attention(q, k, v, bias, heads)
        out = self.dropout(self.linear(context, f"{name}.output.dense"))
        return self.layer_norm(x + out, f"{name}.output.LayerNorm", BERT_LN_EPS)

    def bert_layer(self, x, bias, name: str, heads: int, cross=None,
                   cross_bias=None) -> torch.Tensor:
        x = self.bert_attention(x, bias, f"{name}.attention", heads)
        if cross is not None:
            x = self.bert_attention(x, cross_bias, f"{name}.crossattention", heads, kv=cross)
        hidden = F.gelu(self.linear(x, f"{name}.intermediate.dense"))
        out = self.dropout(self.linear(hidden, f"{name}.output.dense"))
        return self.layer_norm(x + out, f"{name}.output.LayerNorm", BERT_LN_EPS)

    def bert_stack(self, x, bias, name: str, layers: int, heads: int, cross=None,
                   cross_bias=None) -> torch.Tensor:
        for i in range(layers):
            x = self.bert_layer(x, bias, f"{name}.layer.{i}", heads, cross, cross_bias)
        return x

    def bert_embeddings(self, ids: torch.Tensor, name: str) -> torch.Tensor:
        positions = torch.arange(ids.shape[1], device=ids.device)
        out = (self.w[f"{name}.word_embeddings.weight"][ids]
               + self.w[f"{name}.position_embeddings.weight"][positions][None]
               + self.w[f"{name}.token_type_embeddings.weight"][torch.zeros_like(ids)])
        return self.dropout(self.layer_norm(out, f"{name}.LayerNorm", BERT_LN_EPS))

    def feature_box(self, features, boxes, stream: str) -> torch.Tensor:
        """dropout(LN(W features) + LN(W boxes)), M4C's object and OCR
        encodings (nn.LayerNorm's eps)."""
        feat = self.layer_norm(self.linear(features, f"linear_{stream}_feat_to_mmt_in"),
                               f"{stream}_feat_layer_norm", TORCH_LN_EPS)
        box = self.layer_norm(self.linear(boxes, f"linear_{stream}_bbox_to_mmt_in"),
                              f"{stream}_bbox_layer_norm", TORCH_LN_EPS)
        return self.dropout(feat + box)

    def prev_pred_embeddings(self, ocr_emb, prev_inds, name: str) -> torch.Tensor:
        """Decoder inputs: the LayerNormed answer row (the classifier's weight)
        or OCR row of each previous token, plus dropout(LN(position + type))."""
        answers = self.layer_norm(self.w["classifier.weight"], f"{name}.ans_layer_norm",
                                  BERT_LN_EPS)
        ocr = self.layer_norm(ocr_emb, f"{name}.ocr_layer_norm", BERT_LN_EPS)
        n_ans = answers.shape[0]
        is_ocr = prev_inds >= n_ans
        rows = torch.where(
            is_ocr[..., None],
            torch.gather(ocr, 1, (prev_inds - n_ans).clamp(0, ocr.shape[1] - 1)[..., None]
                         .expand(-1, -1, ocr.shape[2])),
            answers[prev_inds.clamp(0, n_ans - 1)])
        positions = torch.arange(prev_inds.shape[1], device=prev_inds.device)
        extra = (self.w[f"{name}.position_embeddings.weight"][positions][None]
                 + self.w[f"{name}.token_type_embeddings.weight"][is_ocr.long()])
        return rows + self.dropout(self.layer_norm(extra, f"{name}.emb_layer_norm",
                                                   BERT_LN_EPS))

    def scores(self, dec, ocr_out, ocr_bias) -> torch.Tensor:
        """[classifier(dec) | pointer scores over the OCR tokens]."""
        fixed = self.linear(dec, "classifier")
        query = self.linear(dec, "ocr_ptr_net.query")
        key = self.linear(ocr_out, "ocr_ptr_net.key")
        pointer = self.p.matmul(query, key.transpose(1, 2)) / math.sqrt(query.shape[-1])
        return torch.cat([fixed, pointer + ocr_bias[:, 0]], dim=-1)


def padding_bias(x: torch.Tensor, pad: float = 0.0) -> torch.Tensor:
    """(b, 1, 1, L): MASK_VALUE where a token is `pad` or a feature row is all
    zero."""
    is_pad = (x == pad) if x.ndim == 2 else (x == 0).all(dim=-1)
    return (is_pad.float() * MASK_VALUE)[:, None, None, :]


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def ocr_features(batch) -> torch.Tensor:
    return torch.cat([l2_normalize(batch["ocr_fasttext_features"]),
                      l2_normalize(batch["ocr_rec_features"]),
                      l2_normalize(batch["ocr_det_features"])], dim=-1)


def ocr_bias(batch) -> torch.Tensor:
    return padding_bias(torch.cat([batch["ocr_fasttext_features"], batch["ocr_rec_features"],
                                   batch["ocr_det_features"]], dim=-1))


def xe_loss(scores: torch.Tensor, batch, pad: int = 0) -> torch.Tensor:
    """Mean NLL of log_softmax(scores) at the shifted answers over the real
    rows' non-pad targets."""
    logprobs = torch.log_softmax(scores, dim=-1)
    targets = batch["shifted_right_answer_tokens"].long()
    picked = logprobs.gather(-1, targets[..., None])[..., 0]
    weights = (targets != pad).float() * batch["sample_valid"][:, None]
    return -(picked * weights).sum() / weights.sum().clamp(min=1.0)


def noam(d_model: int, warmup: int) -> Callable[[int], float]:
    def factor(step: int) -> float:
        s = step + 1.0
        return d_model ** -0.5 * min(s ** -0.5, s * warmup ** -1.5)
    return factor


def train_readings(loss_fn: Callable, weights: Dict[str, torch.Tensor], batches: List,
                   lr: float, factor: Callable[[int], float]) -> Dict:
    """len(batches) steps of Adam (betas 0.9 / 0.98, eps 1e-8) under a LambdaLR
    of `factor` on loss_fn(weights, batch): each step's loss, each leaf's
    first-gradient norm, each leaf's change after the steps."""
    params = {name: value.detach().clone().requires_grad_(True)
              for name, value in weights.items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.98), eps=1e-8,
                                 foreach=False)
    schedule = torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
    losses, grad_norms = [], {}
    for step, batch in enumerate(batches):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch)
        loss.backward()
        if step == 0:
            grad_norms = {name: float(p.grad.norm()) if p.grad is not None else 0.0
                          for name, p in params.items()}
        optimizer.step()
        schedule.step()
        losses.append(float(loss.detach()))
    change_norms = {name: float((p.detach() - weights[name]).norm())
                    for name, p in params.items()}
    return {"loss": losses, "grad_norms": grad_norms, "change_norms": change_norms}
