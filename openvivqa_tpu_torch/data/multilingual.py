"""Multilingual (EVJVQA) vocabularies and datasets.

The port's copy of the generative part of ``openvivqa_tpu/data/multilingual.py``:
Japanese questions are tokenised by character, Vietnamese and English ones by
word; the EVJVQA vocab is built from train + dev only (the test answers are
unseen); the multimodal vocabs add the modality special tokens of the
single-stream models (``MultiModalVocab``); the RawQuestion datasets keep the
raw question string on the host beside its vocab-encoded ``question_tokens``.
The classification vocab goes with the classification slice.

With ``HF_TOKENIZER`` set in a dataset's config the JAX package also emits the
questions in a pretrained tokenizer's ids; the port has no tokenizer files, and
such a config raises (ROADMAP), it never falls back to the vocab's ids.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, List

from ..builders import META_DATASET, META_VOCAB
from ..utils.instance import Instance
from .datasets import DictionaryDataset, FeatureDataset, teacher_forcing_pair
from .multimodal_vocab import MultiModalVocab
from .text_utils import is_japanese_sentence, preprocess_sentence
from .vocab import Vocab


def multilingual_tokenize(text: str, tokenizer) -> List[str]:
    """Char-level for Japanese, preprocess_sentence otherwise."""
    if is_japanese_sentence(text):
        return list(text)
    return preprocess_sentence(text, tokenizer)


class _MultilingualMakeVocabMixin:
    """Vocab counts over multilingual questions and answers: a Japanese
    question and its answers by character, the others by word."""

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
                question = multilingual_tokenize(ann["question"], self.tokenizer)
                for answer in ann["answers"]:
                    if is_japanese_sentence(ann["question"]):
                        answer_tokens = list(answer)
                    else:
                        answer_tokens = preprocess_sentence(answer, self.tokenizer)
                    self.freqs.update(question)
                    self.freqs.update(answer_tokens)
                    self.max_question_length = max(self.max_question_length, len(question) + 2)
                    self.max_answer_length = max(self.max_answer_length, len(answer_tokens) + 2)


@META_VOCAB.register()
class MultilingualVocab(_MultilingualMakeVocabMixin, Vocab):
    pass


@META_VOCAB.register()
class MultilingualMultiModalVocab(_MultilingualMakeVocabMixin, MultiModalVocab):
    pass


@META_VOCAB.register()
class VlspEvjVqaVocab(MultilingualVocab):
    """The EVJVQA vocab, built from train + dev only."""

    def vocab_json_paths(self, config):
        return [config.JSON_PATH.TRAIN, config.JSON_PATH.DEV]


@META_VOCAB.register()
class VlspVqaMultiModalVocab(MultilingualMultiModalVocab):
    """The EVJVQA vocab of the single-stream models, built from train + dev only."""

    def vocab_json_paths(self, config):
        return [config.JSON_PATH.TRAIN, config.JSON_PATH.DEV]


class _MultilingualAnnotationsMixin:
    """One sample per (question, answer); a Japanese question's answers are
    tokenised by character too."""

    def load_annotations(self, json_data: Dict) -> List[Dict]:
        images = {img["id"]: img for img in json_data["images"]}
        annotations = []
        for ann in json_data["annotations"]:
            image = images.get(ann["image_id"])
            if image is None:
                continue
            is_ja = is_japanese_sentence(ann["question"])
            question = multilingual_tokenize(ann["question"], self.vocab.tokenizer)
            for answer in ann["answers"]:
                answer_tokens = (
                    list(answer) if is_ja else preprocess_sentence(answer, self.vocab.tokenizer)
                )
                annotations.append({
                    "question": question,
                    "raw_question": ann["question"],
                    "answer": answer_tokens,
                    "image_id": ann["image_id"],
                    "filename": image["filename"],
                })
        return annotations


@META_DATASET.register()
class MultilingualFeatureDataset(_MultilingualAnnotationsMixin, FeatureDataset):
    pass


@META_DATASET.register()
class MultilingualDictionaryDataset(DictionaryDataset):
    def load_annotations(self, json_data: Dict) -> List[Dict]:
        images = {img["id"]: img for img in json_data["images"]}
        annotations = []
        for ann in json_data["annotations"]:
            image = images.get(ann["image_id"])
            if image is None:
                continue
            # the metrics read word-level answer strings, Japanese ones included
            answers = [
                " ".join(preprocess_sentence(a, self.vocab.tokenizer)) for a in ann["answers"]
            ]
            annotations.append({
                "question_id": ann["id"],
                "type": ann.get("QA-type"),
                "question": multilingual_tokenize(ann["question"], self.vocab.tokenizer),
                "raw_question": ann["question"],
                "answers": answers,
                "image_id": ann["image_id"],
                "filename": image["filename"],
            })
        return annotations


class _RawQuestionItemMixin:
    """The raw question string on the host beside its vocab encoding."""

    def __init__(self, json_path: str, vocab, config) -> None:
        if config.get("HF_TOKENIZER"):
            raise NotImplementedError(
                f"HF_TOKENIZER {config.HF_TOKENIZER!r}: questions in a pretrained tokenizer's "
                "ids need its tokenizer files, which are not in the repository; the port does "
                "not tokenise them yet (ROADMAP), unset HF_TOKENIZER to use the vocab's ids"
            )
        super().__init__(json_path, vocab, config)

    def _question_payload(self, item):
        return {
            "question": item["raw_question"],
            "question_tokens": self.vocab.encode_question(item["question"]),
        }


@META_DATASET.register()
class RawQuestionFeatureDataset(_RawQuestionItemMixin, FeatureDataset):
    def load_annotations(self, json_data: Dict) -> List[Dict]:
        images = {img["id"]: img for img in json_data["images"]}
        annotations = []
        for ann in json_data["annotations"]:
            image = images.get(ann["image_id"])
            if image is None:
                continue
            question = preprocess_sentence(ann["question"], self.vocab.tokenizer)
            for answer in ann["answers"]:
                annotations.append({
                    "question": question,
                    "raw_question": ann["question"],
                    "answer": preprocess_sentence(answer, self.vocab.tokenizer),
                    "image_id": ann["image_id"],
                    "filename": image["filename"],
                })
        return annotations

    def __getitem__(self, idx: int) -> Instance:
        item = self.annotations[idx]
        answer, shifted_right = teacher_forcing_pair(
            self.vocab.encode_answer(item["answer"]), self.vocab.padding_idx, self.vocab.eos_idx
        )
        return Instance(
            image_id=item["image_id"],
            filename=item["filename"],
            answer_tokens=answer,
            shifted_right_answer_tokens=shifted_right,
            **self._question_payload(item),
            **self.load_features(item["image_id"]),
        )


@META_DATASET.register()
class RawQuestionDictionaryDataset(_RawQuestionItemMixin, DictionaryDataset):
    def load_annotations(self, json_data: Dict) -> List[Dict]:
        annotations = super().load_annotations(json_data)
        raw = {ann["id"]: ann["question"] for ann in json_data["annotations"]}
        for ann in annotations:
            ann["raw_question"] = raw.get(ann["question_id"], "")
        return annotations

    def __getitem__(self, idx: int) -> Instance:
        item = self.annotations[idx]
        return Instance(
            question_id=item["question_id"],
            type=item["type"],
            image_id=item["image_id"],
            filename=item["filename"],
            answers=item["answers"],
            **self._question_payload(item),
            **self.load_features(item["image_id"]),
        )
