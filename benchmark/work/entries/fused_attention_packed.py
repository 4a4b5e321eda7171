"""The packed attention's work: softmax(scale q k^T + bias) v over (b, S,
h * d) projections; each input read once and the output written once."""

from portbench.trace import tensor_bytes

MODULE = "openvivqa_tpu_torch.ops.fused_attention"
ATTRIBUTE = "fused_attention_packed"


def forward(args, kwargs, out):
    q, k, v, bias = args[:4]
    b, sq, hd = q.shape
    return 4.0 * b * sq * k.shape[1] * hd, tensor_bytes(q, k, v, bias, out)
