"""OCR-aware vocabulary.

The port's copy of OcrVocab from ``openvivqa_tpu/data/ocr_vocab.py``: 12
special tokens, answer encoding against fixed-vocab ∪ per-sample OCR slots
(OCR index space starts at len(stoi)), decode with per-sample OCR tables,
decode_answer_with_determination; OcrClassificationVocab, LoRRA's classes
over the answers and the OCR slots; and CharacterVocab, word-level questions
with character-level answers.
"""

from __future__ import annotations

import json
from collections import Counter, defaultdict
from typing import Dict, List, Union

import numpy as np

from ..builders import META_VOCAB
from .text_utils import preprocess_sentence
from .vocab import ClassificationVocab, Vocab


@META_VOCAB.register()
class OcrVocab(Vocab):
    """VQA-with-reading-comprehension vocabulary."""

    def __init__(self, config):
        self.img_token = config.get("IMG_TOKEN", "<img>")
        self.feat_token = config.get("FEAT_TOKEN", "<feat>")
        self.box_token = config.get("BOX_TOKEN", "<box>")
        self.ocr_token = config.get("OCR_TOKEN", "<ocr>")
        self.ocr_det_token = config.get("OCR_DET_TOKEN", "<ocr_det>")
        self.ocr_rec_token = config.get("OCR_REC_TOKEN", "<ocr_rec>")
        self.question_token = config.get("QUESTION_TOKEN", "<question>")
        self.answer_token = config.get("ANSWER_TOKEN", "<answer>")
        super().__init__(config)

    def special_tokens(self) -> List[str]:
        return [
            self.padding_token, self.bos_token, self.eos_token, self.unk_token,
            self.img_token, self.feat_token, self.box_token, self.ocr_token,
            self.ocr_det_token, self.ocr_rec_token, self.question_token,
            self.answer_token,
        ]

    def register_special_indices(self) -> None:
        self.img_idx = self.stoi[self.img_token]
        self.feat_idx = self.stoi[self.feat_token]
        self.box_idx = self.stoi[self.box_token]
        self.ocr_idx = self.stoi[self.ocr_token]
        self.ocr_det_idx = self.stoi[self.ocr_det_token]
        self.ocr_rec_idx = self.stoi[self.ocr_rec_token]
        self.question_idx = self.stoi[self.question_token]
        self.answer_idx = self.stoi[self.answer_token]

    # -- OCR copy index space ----------------------------------------------------
    def match_text_to_indices(
        self, text: List[str], oov2inds: Dict[str, List[int]]
    ) -> List[int]:
        """Each answer word maps to its fixed-vocab id or (randomly, when it
        also appears in the OCR tokens) to an OCR slot id
        (ocr_vocab.py:84-100 parity).  Divergence: the reference indexes
        stoi[word] directly and CRASHES on an out-of-vocab answer word
        (plain dict, vocab.py:51); here the fixed-vocab id participates
        only when the word is in vocab, and <unk> is used only when no OCR
        slot matches either — so copy-head targets are never diluted by
        <unk> when the word exists in the scene text."""
        indices = []
        for word in text:
            matched = []
            if word in self.stoi:
                matched.append(self.stoi[word])
            matched.extend(oov2inds.get(word, []))
            if not matched:
                matched = [self.unk_idx]
            indices.append(matched[np.random.choice(len(matched))])
        return indices

    def encode_answer(self, answer: List[str], ocr_tokens: List[str]) -> np.ndarray:
        assert isinstance(answer, list)
        oov2inds: Dict[str, List[int]] = defaultdict(list)
        for offset, token in enumerate(ocr_tokens):
            oov2inds[token].append(len(self.stoi) + offset)
        ids = self.match_text_to_indices(answer, oov2inds)

        vec = np.full((self.max_answer_length,), self.padding_idx, np.int32)
        tokens = [self.bos_idx] + ids + [self.eos_idx]
        for i, idx in enumerate(tokens[: self.max_answer_length]):
            vec[i] = idx
        return vec

    def _ocr_table(self, ocr_tokens: List[str]) -> Dict[int, str]:
        return {len(self.stoi) + i: tok for i, tok in enumerate(ocr_tokens)}

    def decode_answer(
        self, answer_vecs, list_ocr_tokens: List[List[str]], join_words: bool = True,
        **kwargs,
    ) -> List:
        join_words = kwargs.get("join_word", join_words)
        answers = []
        for row, vec in enumerate(np.asarray(answer_vecs)):
            table = self._ocr_table(list_ocr_tokens[row])
            words = []
            for idx in vec.tolist():
                word = table.get(int(idx), self.itos.get(int(idx), self.unk_token))
                if word == self.eos_token:
                    break
                if word not in self.specials:
                    words.append(word)
            text = " ".join(words)
            answers.append(text if join_words else text.strip().split())
        return answers

    def decode_answer_with_determination(
        self, answer_vecs, list_ocr_tokens: List[List[str]], join_words: bool = True
    ):
        """Also report, per decoded step, whether the token came from the
        fixed vocab (ocr_vocab.py:146-176 parity)."""
        answers, in_fixed_vocab = [], []
        for row, vec in enumerate(np.asarray(answer_vecs)):
            table = self._ocr_table(list_ocr_tokens[row])
            words, flags = [], []
            for idx in vec.tolist():
                idx = int(idx)
                if idx in table:
                    word = table[idx]
                    flags.append(False)
                else:
                    word = self.itos.get(idx, self.unk_token)
                    flags.append(True)
                if word == self.eos_token:
                    break
                if word not in self.specials:
                    words.append(word)
            text = " ".join(words)
            answers.append(text if join_words else text.strip().split())
            in_fixed_vocab.append(flags)
        return answers, in_fixed_vocab


@META_VOCAB.register()
class OcrClassificationVocab(ClassificationVocab):
    """LoRRA-style classification: the answer classes, then MAX_SCENE_TEXT OCR
    slots."""

    def __init__(self, config):
        super().__init__(config)
        self.max_scene_text = config.MAX_SCENE_TEXT
        self.num_choices = self.total_answers + config.MAX_SCENE_TEXT

    def encode_answer(self, answer: List[str], ocr_tokens: List[str]) -> np.ndarray:
        """The answer's class id, else the first OCR slot that holds it.  An
        answer that is neither is a data error and raises (labelling slot 0
        would corrupt the targets)."""
        text = " ".join(answer)
        if text in self.atoi:
            return np.asarray([self.atoi[text]], np.int32)
        for offset, token in enumerate(ocr_tokens):
            if token == text:
                return np.asarray([self.total_answers + offset], np.int32)
        raise KeyError(
            f"answer '{text}' is neither a known class nor among the sample's OCR tokens "
            "- rebuild the vocab with every split's answers (JSON_PATH.TEST included)"
        )

    def decode_answer(self, answer_vecs, list_ocr_tokens: List[List[str]],
                      join_words: bool = True, **kwargs) -> Union[List[str], List[List[str]]]:
        """Class ids -> answers; an OCR slot past the sample's table reads as
        the padding token."""
        join_words = kwargs.get("join_word", join_words)
        answers = []
        for row, idx in enumerate(np.asarray(answer_vecs).reshape(-1).tolist()):
            idx = int(idx)
            if idx >= self.total_answers:
                offset, ocr = idx - self.total_answers, list_ocr_tokens[row]
                text = ocr[offset] if offset < len(ocr) else self.padding_token
            else:
                text = self.itoa[idx]
            answers.append(text if join_words else text.split())
        return answers


@META_VOCAB.register()
class CharacterVocab(Vocab):
    """Word-level questions, character-level answers: an answer is encoded
    one character per position between <bos> and <eos>."""

    def make_vocab(self, json_paths) -> None:
        self.freqs = Counter()
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
                    answer_text = " ".join(preprocess_sentence(answer, self.tokenizer))
                    self.freqs.update(question)
                    self.freqs.update(list(answer_text))
                    self.max_question_length = max(self.max_question_length, len(question) + 2)
                    self.max_answer_length = max(self.max_answer_length, len(answer_text) + 2)

    def encode_answer(self, answer: Union[str, List[str]]) -> np.ndarray:
        if isinstance(answer, list):
            answer = " ".join(answer)
        vec = np.full((self.max_answer_length,), self.padding_idx, np.int32)
        chars = [self.bos_token] + list(answer) + [self.eos_token]
        for i, ch in enumerate(chars[: self.max_answer_length]):
            vec[i] = self.stoi.get(ch, self.unk_idx)
        return vec

    def decode_answer(self, answer_vecs, join_words: bool = True, **kwargs) -> List:
        join_words = kwargs.get("join_word", join_words)
        answers = []
        for vec in np.asarray(answer_vecs):
            chars = [self.itos[int(i)] for i in np.atleast_1d(vec)
                     if self.itos[int(i)] not in self.specials]
            text = "".join(chars).strip()
            answers.append(text if join_words else text.split())
        return answers
