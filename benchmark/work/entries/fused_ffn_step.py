"""Kernel C's work: a BERT FFN sublayer over (rows, hd): two products through
d_ff, GELU, the residual LayerNorm; each input read once, the output written
once."""

from portbench.trace import tensor_bytes

MODULE = "openvivqa_tpu_torch.ops.decode_step"
ATTRIBUTE = "fused_ffn_step"


def forward(args, kwargs, out):
    x, w1 = args[0], args[1]
    rows, hd = x.shape
    return 4.0 * rows * hd * w1.shape[1], tensor_bytes(args[:7], out)
