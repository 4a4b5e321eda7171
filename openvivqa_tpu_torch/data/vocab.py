"""Vocabulary base class and the classification vocab.

The port's copy of Vocab and ClassificationVocab from
``openvivqa_tpu/data/vocab.py``: the reference's special tokens,
frequency-then-alphabetical ordering, +2 (bos/eos) length accounting and
encode/decode behaviour.  Encoded vectors are numpy int32 padded to the
dataset-level maxima so every batch has a static shape.  ClassificationVocab
sorts its answer set before assigning class ids, as the JAX package does (the
reference enumerates a python ``set``, whose order depends on PYTHONHASHSEED).
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, List, Sequence, Union

import numpy as np

from ..builders import META_VOCAB
from .text_utils import preprocess_sentence


@META_VOCAB.register()
class Vocab:
    """Token vocabulary built from train+dev+test annotation JSONs."""

    def __init__(self, config):
        self.tokenizer = config.TOKENIZER

        self.padding_token = config.PAD_TOKEN
        self.bos_token = config.BOS_TOKEN
        self.eos_token = config.EOS_TOKEN
        self.unk_token = config.UNK_TOKEN

        self.make_vocab(self.vocab_json_paths(config))
        counter = self.freqs.copy()

        min_freq = max(config.get("MIN_FREQ", 1) or 1, 1)

        specials = self.special_tokens()
        itos = list(specials)
        for tok in specials:
            del counter[tok]

        # sort alphabetically, then (stably) by frequency descending
        words_and_frequencies = sorted(counter.items(), key=lambda t: t[0])
        words_and_frequencies.sort(key=lambda t: t[1], reverse=True)
        for word, freq in words_and_frequencies:
            if freq < min_freq:
                break
            itos.append(word)

        self.itos: Dict[int, str] = dict(enumerate(itos))
        self.stoi: Dict[str, int] = {tok: i for i, tok in enumerate(itos)}
        self.specials = list(specials)

        self.padding_idx = self.stoi[self.padding_token]
        self.bos_idx = self.stoi[self.bos_token]
        self.eos_idx = self.stoi[self.eos_token]
        self.unk_idx = self.stoi[self.unk_token]
        self.register_special_indices()

        self.word_embeddings = None
        if config.get("WORD_EMBEDDING") is not None:
            from ..builders import build_word_embedding

            self.load_word_embeddings(build_word_embedding(config))

    # -- hooks for subclasses --------------------------------------------------
    def vocab_json_paths(self, config) -> List[str]:
        """Which splits the vocab is built from (all three by default;
        EVJVQA vocabs restrict to train+dev)."""
        return [
            config.JSON_PATH.TRAIN,
            config.JSON_PATH.DEV,
            config.JSON_PATH.get("TEST"),
        ]

    def special_tokens(self) -> List[str]:
        return [
            self.padding_token,
            self.bos_token,
            self.eos_token,
            self.unk_token,
        ]

    def register_special_indices(self) -> None:
        """Subclasses resolve their extra special-token indices here."""

    # -- construction --------------------------------------------------------
    def make_vocab(self, json_paths: Sequence[str]) -> None:
        self.freqs: Counter = Counter()
        self.max_question_length = 0
        self.max_answer_length = 0
        for json_path in json_paths:
            if json_path is None:
                continue
            with open(json_path) as handle:
                json_data = json.load(handle)
            for ann in json_data["annotations"]:
                question = preprocess_sentence(ann["question"], self.tokenizer)
                for answer in ann["answers"]:
                    answer_tokens = preprocess_sentence(answer, self.tokenizer)
                    self.freqs.update(question)
                    self.freqs.update(answer_tokens)
                    self.max_question_length = max(
                        self.max_question_length, len(question) + 2
                    )
                    self.max_answer_length = max(
                        self.max_answer_length, len(answer_tokens) + 2
                    )

    # -- encode ---------------------------------------------------------------
    def encode_question(self, question: List[str]) -> np.ndarray:
        vec = np.full((self.max_question_length,), self.padding_idx, dtype=np.int32)
        tokens = [self.bos_token] + list(question) + [self.eos_token]
        for i, token in enumerate(tokens[: self.max_question_length]):
            vec[i] = self.stoi.get(token, self.unk_idx)
        return vec

    def encode_answer(self, answer: List[str]) -> np.ndarray:
        vec = np.full((self.max_answer_length,), self.padding_idx, dtype=np.int32)
        tokens = [self.bos_token] + list(answer) + [self.eos_token]
        for i, token in enumerate(tokens[: self.max_answer_length]):
            vec[i] = self.stoi.get(token, self.unk_idx)
        return vec

    # -- decode ---------------------------------------------------------------
    def _decode(self, vecs, join_words: bool):
        sentences = []
        for vec in np.asarray(vecs):
            words = [
                self.itos[int(idx)]
                for idx in np.atleast_1d(vec)
                if self.itos[int(idx)] not in self.specials
            ]
            sentence = " ".join(words)
            sentences.append(sentence if join_words else sentence.strip().split())
        return sentences

    def decode_question(self, question_vecs, join_words: bool = True) -> List:
        return self._decode(question_vecs, join_words)

    def decode_answer(self, answer_vecs, join_words: bool = True, **kwargs) -> List:
        join_words = kwargs.get("join_word", join_words)
        return self._decode(answer_vecs, join_words)

    def __len__(self) -> int:
        return len(self.itos)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Vocab):
            return NotImplemented
        return self.stoi == other.stoi and self.freqs == other.freqs

    def extend(self, other: "Vocab", sort: bool = False) -> None:
        """Merge another vocab's tokens (vocab.py:134-140 parity)."""
        words = (
            sorted(other.itos.values()) if sort else list(other.itos.values())
        )
        for word in words:
            if word not in self.stoi:
                index = len(self.itos)
                self.itos[index] = word
                self.stoi[word] = index

    def set_vectors(self, stoi, word_embeddings, dim: int) -> None:
        """Assign word vectors from an external table (vocab.py:155-176)."""
        from .word_embedding import unk_init

        table = np.zeros((len(self), dim), dtype=np.float32)
        for i, token in self.itos.items():
            index = stoi.get(token)
            if index is not None:
                table[i] = np.asarray(word_embeddings[index])
            else:
                table[i] = unk_init(token, dim)
        self.word_embeddings = table

    # -- pretrained word vectors ----------------------------------------------
    def load_word_embeddings(self, word_embeddings) -> None:
        if not isinstance(word_embeddings, list):
            word_embeddings = [word_embeddings]
        total_dim = sum(emb.dim for emb in word_embeddings)
        table = np.zeros((len(self), total_dim), dtype=np.float32)
        for i, token in self.itos.items():
            start = 0
            for emb in word_embeddings:
                table[i, start : start + emb.dim] = emb[token.strip()]
                start += emb.dim
        self.word_embeddings = table


@META_VOCAB.register()
class ClassificationVocab(Vocab):
    """Answers as class ids: each distinct answer string, sorted, is one class."""

    def make_vocab(self, json_paths: Sequence[str]) -> None:
        self.freqs = Counter()
        answers = set()
        self.max_question_length = 0
        self.max_answer_length = 1
        for json_path in json_paths:
            if json_path is None:
                continue
            with open(json_path) as handle:
                json_data = json.load(handle)
            for ann in json_data["annotations"]:
                question = preprocess_sentence(ann["question"], self.tokenizer)
                for answer in ann["answers"]:
                    self.freqs.update(question)
                    answers.add(" ".join(preprocess_sentence(answer, self.tokenizer)))
                self.max_question_length = max(self.max_question_length, len(question) + 2)

        self.itoa: Dict[int, str] = dict(enumerate(sorted(answers)))
        self.atoi: Dict[str, int] = {a: i for i, a in self.itoa.items()}
        self.total_answers = len(self.atoi)

    def encode_answer(self, answer: List[str]) -> np.ndarray:
        return np.asarray([self.atoi[" ".join(answer)]], dtype=np.int32)

    def decode_answer(self, answer_vecs, join_words: bool = False,
                      **kwargs) -> Union[List[str], List[List[str]]]:
        # the reference's task layer passes the `join_word` spelling
        join_words = kwargs.get("join_word", join_words)
        answers = []
        for idx in np.asarray(answer_vecs).reshape(-1).tolist():
            text = self.itoa[int(idx)]
            answers.append(text if join_words else text.split())
        return answers
