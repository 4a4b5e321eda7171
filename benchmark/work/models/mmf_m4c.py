"""MMF_M4C's model FLOPs per sample (see ``_common``).

forward: TextBert over the question, the feature encodings, the MMT over
[question, objects, OCR, answer] and the two heads on the answer rows.
eval: what a greedy answer needs: one encode of [question, objects, OCR],
then each step's new answer row against the cached context and the rows
before it, and the heads on that row; the quadratic decode's re-encodes are
not needed work.
"""

from portbench.files import BENCH, load_module

_c = load_module(BENCH / "work" / "models" / "_common.py", "work.models._common")


def flops(config, shapes):
    h = int(config["MODEL.MMT.HIDDEN_SIZE"])
    ht = int(config["MODEL.TEXT_BERT.HIDDEN_SIZE"])
    layers = int(config["MODEL.MMT.NUM_HIDDEN_LAYERS"])
    text_layers = int(config["MODEL.TEXT_BERT.NUM_HIDDEN_LAYERS"])
    q, t, vocab, ocr = shapes["question"], shapes["answer"], shapes["vocab"], shapes["ocr"]
    context = q + shapes["regions"] + ocr
    text = text_layers * _c.bert_layer(q, ht, 4 * ht, q)
    if h != 768 or ht != h:
        text += 2.0 * q * ht * h
    feats = _c.features(config, shapes, h)
    joint = context + t
    forward = text + feats + layers * _c.bert_layer(joint, h, 4 * h, joint) \
        + _c.heads_out(t, h, vocab, ocr)
    train = 3 * forward - feats
    steps = sum(layers * _c.bert_layer(1, h, 4 * h, context + s) for s in range(1, t + 1))
    evaluate = (text + feats + layers * _c.bert_layer(context, h, 4 * h, context) + steps
                + t * _c.heads_out(1, h, vocab, ocr, keys_projected=False)
                + 2.0 * ocr * h * h)
    return {"forward": forward, "train": train, "eval": evaluate}
