"""The embedding-table size of a BERT-layout pretrained backbone.

The port's own copy of ``backbone_table_rows`` and the vocab sizes it knows
(``openvivqa_tpu/models/modules/pretrained_embeddings.py``); the pretrained
wrappers themselves wait for the backbones' slice.
"""

from __future__ import annotations

# real vocab sizes of the BERT-layout checkpoints the reference configs name
_BERT_FAMILY_VOCABS = {
    "bert-base-uncased": 30522,
    "bert-base-cased": 28996,
    "bert-base-multilingual-uncased": 105879,
    "bert-base-multilingual-cased": 119547,
    "xlm-roberta-base": 250002,
    "xlm-roberta-large": 250002,
    "roberta-base": 50265,
    "vinai/phobert-base": 64001,
    "vinai/phobert-large": 64001,
}


def backbone_table_rows(config, vocab_len: int = 0) -> int:
    """Embedding-table rows for a BERT-layout backbone: the explicit
    PRETRAINED_VOCAB_SIZE, else the known checkpoint size, and at least
    `vocab_len`.  An unknown checkpoint name without an explicit size raises:
    a table too small for the tokenizer's ids would be read out of range."""
    name = config.get("PRETRAINED_NAME")
    configured = config.get("PRETRAINED_VOCAB_SIZE")
    if configured:
        rows = int(configured)
    elif not name:
        rows = 30522  # BERT-base layout default (no checkpoint named)
    elif name in _BERT_FAMILY_VOCABS:
        rows = _BERT_FAMILY_VOCABS[name]
    else:
        raise ValueError(
            f"PRETRAINED_NAME {name!r} has no known vocab size; set "
            "PRETRAINED_VOCAB_SIZE to the checkpoint's real vocab rows"
        )
    return max(vocab_len, rows)
