"""Kernel F's work: a BERT self-attention sublayer over (b, S, hd) rows: the
q|k|v and out projections, the attention under a key-only bias, the residual
LayerNorm; each input (rows, weight bundle, bias) read once, the output
written once."""

from portbench.trace import tensor_bytes

MODULE = "openvivqa_tpu_torch.ops.encoder_layer"
ATTRIBUTE = "fused_encoder_self_attention"


def forward(args, kwargs, out):
    x, weights, key_bias = args[:3]
    b, s, hd = x.shape
    return 2.0 * b * s * hd * 4 * hd + 4.0 * b * s * s * hd, tensor_bytes(x, weights, key_bias, out)
