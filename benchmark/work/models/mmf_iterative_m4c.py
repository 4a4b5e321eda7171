"""MMF_IterativeM4C's model FLOPs per sample (see ``_common``).

forward: TextBert over the question, the feature encodings, the joint
encoder over [question, objects, OCR], the decoder over the answer rows (its
causal self-attention, its cross-attention over the encoder's states, whose
keys and values it projects once) and the two heads on the answer rows.
eval: what a greedy answer needs: one encode, each decoder layer's
cross-attention keys and values once a sequence, then each step's new answer
row through every decoder layer (against the rows before it and the
encoder's states) and the heads on that row; the quadratic decode's re-runs
of the decoder over the whole prefix are not needed work.
"""

from portbench.files import BENCH, load_module

_c = load_module(BENCH / "work" / "models" / "_common.py", "work.models._common")


def cross_attention(rows: int, width: int, keys: int) -> float:
    """A cross-attention sublayer's q and out projections over `rows` rows
    and its attention over `keys` encoder states (their k and v projections
    apart: `cross_keys_values`)."""
    return 2.0 * rows * width * width * 2 + 4.0 * rows * keys * width


def cross_keys_values(keys: int, width: int) -> float:
    """The k and v projections of `keys` encoder states."""
    return 2.0 * keys * width * width * 2


def flops(config, shapes):
    h = int(config["MODEL.ENCODER.D_MODEL"])
    ht = int(config["MODEL.TEXT_BERT.HIDDEN_SIZE"])
    encoder_layers = int(config["MODEL.ENCODER.LAYERS"])
    decoder_layers = int(config["MODEL.DECODER.LAYERS"])
    text_layers = int(config["MODEL.TEXT_BERT.NUM_HIDDEN_LAYERS"])
    q, t, vocab, ocr = shapes["question"], shapes["answer"], shapes["vocab"], shapes["ocr"]
    context = q + shapes["regions"] + ocr
    text = text_layers * _c.bert_layer(q, ht, 4 * ht, q)
    if ht != h:
        text += 2.0 * q * ht * h
    encode = text + _c.features(config, shapes, h) \
        + encoder_layers * _c.bert_layer(context, h, 4 * h, context)
    decoder = decoder_layers * (_c.bert_layer(t, h, 4 * h, t) + cross_attention(t, h, context)
                                + cross_keys_values(context, h))
    forward = encode + decoder + _c.heads_out(t, h, vocab, ocr)
    train = 3 * forward - _c.features(config, shapes, h)
    steps = sum(_c.bert_layer(1, h, 4 * h, s) + cross_attention(1, h, context)
                for s in range(1, t + 1))
    evaluate = (encode + decoder_layers * (cross_keys_values(context, h) + steps)
                + t * _c.heads_out(1, h, vocab, ocr, keys_projected=False) + 2.0 * ocr * h * h)
    return {"forward": forward, "train": train, "eval": evaluate}
