"""The dropout attention's work: softmax(scale q k^T + bias) with dropout on
the weights, times v, over (b, S, h * d) projections; its backward gives dq,
dk and dv.  Each input read once and each output written once (the state a
forward hands its backward is the design's, not the function's)."""

from portbench.trace import tensor_bytes

MODULE = "openvivqa_tpu_torch.ops.fused_attention"
ATTRIBUTE = "fused_attention_packed_dropout"
BACKWARD_OWNER = "PackedDropoutAttention"  # its backward is wrapped too


def forward(args, kwargs, out):
    q, k, v, bias, seed = args[:5]
    b, sq, hd = q.shape
    return 4.0 * b * sq * k.shape[1] * hd, tensor_bytes(q, k, v, bias, seed, out)


def backward(args, kwargs, out):
    """dq, dk, dv from q, k, v, the bias and the output's gradient: the
    forward's two products again, and three more."""
    q, k, v, bias = args[:4]
    b, sq, hd = q.shape
    return 10.0 * b * sq * k.shape[1] * hd, tensor_bytes(q, k, v, out, bias, q, k, v)
