"""Host-side HuggingFace tokenisation of the raw questions.

The port's copy of ``openvivqa_tpu/data/hf_tokenization.py``.  A dataset whose
config sets ``HF_TOKENIZER: <name-or-path>`` tokenises every unique raw question
of its split once, padded to the split's longest, and its items carry
``question_backbone_tokens`` (the tokenizer's ids) and
``question_backbone_mask`` (its attention mask) beside the vocab-encoded
``question_tokens``; the pretrained text wrappers read the former.

The tokenizer resolves from local files only (``local_files_only=True``), and
``transformers`` is imported only when one is configured.  A configured
tokenizer that does not resolve is an error: falling back to the vocab's ids
would feed the backbone a different model's ids.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..logging_utils import setup_logger

logger = setup_logger()


class HostTokenizer:
    """A local AutoTokenizer giving static-shape id and mask matrices."""

    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer

        try:
            self.tokenizer = AutoTokenizer.from_pretrained(name_or_path, local_files_only=True)
        except Exception as exc:  # noqa: BLE001
            raise FileNotFoundError(
                f"HF_TOKENIZER={name_or_path!r} is configured but no local tokenizer files "
                "resolve. Give a local path holding the tokenizer files, or remove the key; "
                "the vocab's ids are a different model's input"
            ) from exc
        if self.tokenizer.pad_token_id is None:
            # pad-less tokenizers (the GPT-2 family): pad with EOS; validity
            # comes from the attention mask, so a real trailing EOS stays valid
            self.tokenizer.pad_token = self.tokenizer.eos_token
        self.pad_id = int(self.tokenizer.pad_token_id or 0)

    def encode_all(self, texts: Sequence[str]):
        """Every string in one call, padded to the longest and truncated at
        the tokenizer's model maximum; returns (ids (n, L) int32, validity
        (n, L) float32)."""
        encoded = self.tokenizer(list(texts), padding="longest", truncation=True,
                                 return_tensors="np")
        return (encoded["input_ids"].astype(np.int32),
                encoded["attention_mask"].astype(np.float32))


def backbone_token_table(config, annotations):
    """{raw question: ((L,) int32 ids, (L,) float32 validity)} over the unique
    raw questions of `annotations`, or None when HF_TOKENIZER is unset.  The
    mask is the tokenizer's own, so a model never guesses a pad id (the
    RoBERTa family pads with 1)."""
    name = config.get("HF_TOKENIZER")
    if not name:
        return None
    tokenizer = HostTokenizer(name)
    uniques: List[str] = list(dict.fromkeys(ann["raw_question"] for ann in annotations))
    if not uniques:
        return {}
    ids, masks = tokenizer.encode_all(uniques)
    logger.info("HF-tokenised %d unique questions with %s (max len %d, pad id %d)",
                len(uniques), name, ids.shape[1], tokenizer.pad_id)
    return {question: (ids[i], masks[i]) for i, question in enumerate(uniques)}
