"""Text preprocessing: tokenizer dispatch + sentence normalisation.

The port's copy of ``openvivqa_tpu/data/text_utils.py``.  All host-side.
"""

from __future__ import annotations

import re
from typing import Callable, List, Union

# every punctuation mark the reference spaces out, as one pass
_PUNCT_RE = re.compile(r"([!?:;,\"'()\[\]/.\-$&*])")
_QUOTES_RE = re.compile(r"[“”]")
_JA_RE = re.compile(
    r"[　-〿]|[぀-ゟ]|[゠-ヿ]|[＀-￯]"
    r"|[一-龯]|[★-☆]|[←-↕]|※"
)

TokenizerLike = Union[None, str, Callable[[str], str]]


def get_tokenizer(tokenizer: TokenizerLike) -> Callable[[str], str]:
    """Resolve the TOKENIZER config key to a callable (utils.py:7-50 parity).

    `None` -> identity; "pyvi"/"spacy"/"vncorenlp" dispatch to the optional
    Vietnamese tokenizers when installed (they are not baked into this image,
    so we raise a clear error instead of printing and returning None).
    """
    if callable(tokenizer):
        return tokenizer
    if tokenizer is None:
        return lambda s: s
    if tokenizer == "pyvi":
        try:
            from pyvi import ViTokenizer  # type: ignore

            return ViTokenizer.tokenize
        except ImportError as exc:
            raise ImportError(
                "pyvi is not installed; install it or set TOKENIZER: null"
            ) from exc
    if tokenizer == "spacy":
        try:
            from spacy.lang.vi import Vietnamese  # type: ignore

            return Vietnamese()
        except ImportError as exc:
            raise ImportError(
                "spacy (+vi) is not installed; install it or set TOKENIZER: null"
            ) from exc
    if tokenizer == "vncorenlp":
        try:
            from vncorenlp import VnCoreNLP  # type: ignore

            annotator = VnCoreNLP(
                address="http://127.0.0.1", port=9000, max_heap_size="-Xmx500m"
            )

            def tokenize(s: str) -> str:
                return " ".join(annotator.tokenize(s)[0])

            return tokenize
        except ImportError as exc:
            raise ImportError(
                "vncorenlp is not installed; install it or set TOKENIZER: null"
            ) from exc
    raise ValueError(f"Unknown tokenizer '{tokenizer}'")


def preprocess_sentence(sentence: str, tokenizer: TokenizerLike = None) -> List[str]:
    """Lowercase, space out punctuation, tokenize, split (utils.py:52-78 parity)."""
    sentence = sentence.lower()
    sentence = _QUOTES_RE.sub('"', sentence)
    sentence = _PUNCT_RE.sub(r" \1 ", sentence)
    tok = get_tokenizer(tokenizer)
    sentence = tok(sentence)
    return sentence.strip().split()


def is_japanese_sentence(text: str) -> bool:
    """Unicode-range check used for EVJVQA char-level handling."""
    return _JA_RE.search(text) is not None
