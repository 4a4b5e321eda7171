"""Matmul FLOPs of the M4C family's pieces, per sample: 2 m n k a product.

Training counts the forward pass and the backward's products: the gradient
of each weight, and of each input that needs one (the feature and box
projections read the data, whose gradient nobody needs).  Nothing is
recomputed in these configurations.
"""


def bert_layer(rows: int, width: int, d_ff: int, keys: int, q_rows: int = None) -> float:
    """One post-LN BERT self-attention layer over `rows` tokens attending to
    `keys` keys: q, k, v, out and the FFN's two products, then q k^T and
    p v."""
    return 2.0 * rows * width * width * 4 + 2.0 * rows * width * d_ff * 2 + 4.0 * rows * keys * width


def features(config, shapes, width: int) -> float:
    """The object and OCR feature and box projections."""
    regions, ocr = shapes["regions"], shapes["ocr"]
    return (2.0 * regions * (config["MODEL.OBJECT_EMBEDDING.D_FEATURE"] + 4) * width
            + 2.0 * ocr * (config["MODEL.OCR_EMBEDDING.D_FEATURE"] + 4) * width)


def heads_out(rows: int, width: int, vocab: int, ocr: int, keys_projected: bool = True) -> float:
    """The classifier and the OCR pointer net over `rows` answer rows (the
    pointer keys projected once)."""
    return (2.0 * rows * width * vocab + 2.0 * rows * width * width
            + (2.0 * ocr * width * width if keys_projected else 0.0) + 2.0 * rows * ocr * width)
