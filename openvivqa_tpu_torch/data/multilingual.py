"""Multilingual (EVJVQA) vocabularies and datasets.

The port's copy of the generative part of ``openvivqa_tpu/data/multilingual.py``:
Japanese questions are tokenised by character, Vietnamese and English ones by
word; the EVJVQA vocab is built from train + dev only (the test answers are
unseen); the multimodal vocabs add the modality special tokens of the
single-stream models (``MultiModalVocab``); the classification vocab's answer
classes are the answers as the datasets tokenise them (a Japanese answer as its
characters joined by spaces); the RawQuestion datasets keep the raw question
string on the host beside its vocab-encoded ``question_tokens``.

With ``HF_TOKENIZER`` set in a dataset's config, the RawQuestion datasets also
emit each question in that pretrained tokenizer's ids and validity mask
(``question_backbone_tokens``, ``question_backbone_mask``;
``hf_tokenization.py``), tokenised once per split when the dataset is built.
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
from .vocab import ClassificationVocab, Vocab


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
class MultilingualClassificationVocab(ClassificationVocab):
    """Answer classes over multilingual annotations: a Japanese question's
    answers as their characters joined by spaces, the form the datasets give
    ``encode_answer``; the others by word."""

    def make_vocab(self, json_paths) -> None:
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
                question = multilingual_tokenize(ann["question"], self.tokenizer)
                for answer in ann["answers"]:
                    self.freqs.update(question)
                    if is_japanese_sentence(ann["question"]):
                        answers.add(" ".join(list(answer)))
                    else:
                        answers.add(" ".join(preprocess_sentence(answer, self.tokenizer)))
                self.max_question_length = max(self.max_question_length, len(question) + 2)
        self.itoa = dict(enumerate(sorted(answers)))
        self.atoi = {a: i for i, a in self.itoa.items()}
        self.total_answers = len(self.atoi)


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
    """The raw question string on the host beside its vocab encoding, and,
    with HF_TOKENIZER in the config, its pretrained tokenizer's ids and
    validity mask (one table per split, built with the dataset: a tokenizer
    that does not resolve fails here)."""

    def __init__(self, json_path: str, vocab, config) -> None:
        super().__init__(json_path, vocab, config)
        from .hf_tokenization import backbone_token_table

        self._backbone_ids_by_question = backbone_token_table(config, self.annotations)

    def _question_payload(self, item):
        payload = {
            "question": item["raw_question"],
            "question_tokens": self.vocab.encode_question(item["question"]),
        }
        if self._backbone_ids_by_question is not None:
            ids, mask = self._backbone_ids_by_question[item["raw_question"]]
            payload["question_backbone_tokens"] = ids
            payload["question_backbone_mask"] = mask
        return payload


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


@META_DATASET.register()
class RawQuestionMultilingualFeatureDataset(_MultilingualAnnotationsMixin,
                                            RawQuestionFeatureDataset):
    """RawQuestionFeatureDataset over multilingual annotations."""


@META_DATASET.register()
class RawQuestionMultilingualDictionaryDataset(_RawQuestionItemMixin,
                                               MultilingualDictionaryDataset):
    """MultilingualDictionaryDataset with the raw question payload."""

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
