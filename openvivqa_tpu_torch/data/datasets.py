"""Feature-file datasets.

The port's copy of the feature, dictionary and feature-classification datasets
of ``openvivqa_tpu/data/datasets.py``: `__getitem__` returns numpy arrays already
padded to static lengths, and visual feature arrays are padded/truncated to a
fixed region count, so every batch of a split has one shape.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np

from ..builders import META_DATASET
from ..utils.instance import Instance
from .text_utils import preprocess_sentence

# default static cap on visual regions/grids when the config does not set one;
# faster-rcnn exports in the reference datasets are fixed-size per image anyway
DEFAULT_MAX_REGIONS = 100


def teacher_forcing_pair(answer: np.ndarray, padding_idx: int, eos_idx: int):
    """(decoder input, shifted target): the target is the answer shifted
    left and the decoder input drops <eos> (feature_dataset.py:48-50
    parity).  The ONE copy — four datasets used to hand-roll it."""
    shifted = np.full_like(answer, padding_idx)
    shifted[:-1] = answer[1:]
    return np.where(answer == eos_idx, padding_idx, answer), shifted


class BaseDataset:
    """Annotation JSON + per-image `.npy` feature store (base_dataset.py:9-40)."""

    def __init__(self, json_path: str, vocab, config) -> None:
        with open(json_path, "r") as handle:
            json_data = json.load(handle)

        self.vocab = vocab
        self.config = config
        self.annotations = self.load_annotations(json_data)
        self.image_features_path = config.FEATURE_PATH.FEATURES
        self.max_regions = int(
            config.get("MAX_REGIONS", DEFAULT_MAX_REGIONS) or DEFAULT_MAX_REGIONS
        )
        # grid streams have their own native length (e.g. 7x7=49); padding
        # them to MAX_REGIONS would silently truncate or shift positions.
        # MAX_GRIDS pins a static length; unset leaves grids native (the
        # extractor emits a fixed grid per image anyway).
        max_grids = config.get("MAX_GRIDS")
        self.max_grids = int(max_grids) if max_grids else None
        self._feature_cache: Dict[int, Dict[str, Any]] = {}
        self.cache_features = bool(config.get("CACHE_FEATURES", False))
        # packed store fast path: FEATURES may point at a .fpack blob built
        # by data/feature_pack.py (mmap gather)
        self._packed_store = None
        if self.image_features_path and str(self.image_features_path).endswith(
            ".fpack"
        ):
            from .feature_pack import PackedFeatureStore

            self._packed_store = PackedFeatureStore(self.image_features_path)

    def load_annotations(self, json_data: Dict) -> List[Dict]:
        raise NotImplementedError

    @staticmethod
    def _index_images(json_data: Dict) -> Dict[int, Dict]:
        return {image["id"]: image for image in json_data["images"]}

    def _pad_key(self, key: str, array: np.ndarray) -> np.ndarray:
        # per-region streams are (n, d); pad them ALL (even n == 1 — a
        # single-region image must not emit its own batch shape).  Scalars and
        # 1-D arrays are metadata (e.g. an [w, h] pair), never region
        # streams in any reference feature schema — padding them to
        # max_regions would corrupt the field.
        if array.ndim < 2:
            return array
        if key.startswith("grid"):
            if self.max_grids is None:
                return array
            return self._pad_static(array, self.max_grids)
        return self._pad_static(array, self.max_regions)

    def _pad_static(self, array: np.ndarray, length: int) -> np.ndarray:
        if array.shape[0] == length:
            return array
        if array.shape[0] > length:
            return array[:length]
        pad = [(0, length - array.shape[0])] + [(0, 0)] * (array.ndim - 1)
        return np.pad(array, pad, mode="constant")

    def load_features(self, image_id: int) -> Dict[str, Any]:
        if self.cache_features and image_id in self._feature_cache:
            return self._feature_cache[image_id]
        if self._packed_store is not None:
            features = {
                key: self._pad_key(key, np.asarray(value))
                for key, value in self._packed_store.get(image_id).items()
            }
            if self.cache_features:
                self._feature_cache[image_id] = features
            return features
        feature_file = os.path.join(self.image_features_path, f"{image_id}.npy")
        raw = np.load(feature_file, allow_pickle=True)[()]
        features: Dict[str, Any] = {}
        for key, value in raw.items():
            if isinstance(value, np.ndarray) and value.dtype != object:
                # floats normalise to f32 (halves H2D vs f64 exports);
                # integer arrays keep their dtype — the reference preserves
                # it (base_dataset.py:27-33) and ids/counts must stay exact
                if np.issubdtype(value.dtype, np.floating):
                    value = np.asarray(value, dtype=np.float32)
                features[key] = self._pad_key(key, value)
            else:
                features[key] = value
        if self.cache_features:
            self._feature_cache[image_id] = features
        return features

    def __getitem__(self, idx: int) -> Instance:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.annotations)


@META_DATASET.register()
class FeatureDataset(BaseDataset):
    """One sample per (question, answer); teacher-forcing targets included
    (feature_dataset.py:10-64 parity)."""

    def __init__(self, json_path: str, vocab, config) -> None:
        super().__init__(json_path, vocab, config)

    @property
    def questions(self):
        return [ann["question"] for ann in self.annotations]

    @property
    def answers(self):
        return [ann["answer"] for ann in self.annotations]

    def load_annotations(self, json_data: Dict) -> List[Dict]:
        images = self._index_images(json_data)
        annotations = []
        for ann in json_data["annotations"]:
            image = images.get(ann["image_id"])
            if image is None:
                continue
            question = preprocess_sentence(ann["question"], self.vocab.tokenizer)
            for answer in ann["answers"]:
                annotations.append(
                    {
                        "question": question,
                        "answer": preprocess_sentence(answer, self.vocab.tokenizer),
                        "image_id": ann["image_id"],
                        "filename": image["filename"],
                    }
                )
        return annotations

    def __getitem__(self, idx: int) -> Instance:
        item = self.annotations[idx]
        question = self.vocab.encode_question(item["question"])
        answer = self.vocab.encode_answer(item["answer"])

        answer, shifted_right_answer = teacher_forcing_pair(
            answer, self.vocab.padding_idx, self.vocab.eos_idx
        )

        features = self.load_features(item["image_id"])
        return Instance(
            image_id=item["image_id"],
            filename=item["filename"],
            question_tokens=question,
            answer_tokens=answer,
            shifted_right_answer_tokens=shifted_right_answer,
            **features,
        )


@META_DATASET.register()
class DictionaryDataset(BaseDataset):
    """One sample per question with *all* ground-truth answers, for metric
    evaluation (dictionary_dataset.py:8-53 parity)."""

    def __init__(self, json_path: str, vocab, config) -> None:
        super().__init__(json_path, vocab, config)

    def load_annotations(self, json_data: Dict) -> List[Dict]:
        images = self._index_images(json_data)
        annotations = []
        for ann in json_data["annotations"]:
            image = images.get(ann["image_id"])
            if image is None:
                continue
            question = preprocess_sentence(ann["question"], self.vocab.tokenizer)
            answers = [
                " ".join(preprocess_sentence(answer, self.vocab.tokenizer))
                for answer in ann["answers"]
            ]
            annotations.append(
                {
                    "question_id": ann["id"],
                    "type": ann.get("QA-type"),
                    "question": question,
                    "answers": answers,
                    "image_id": ann["image_id"],
                    "filename": image["filename"],
                }
            )
        return annotations

    def __getitem__(self, idx: int) -> Instance:
        item = self.annotations[idx]
        features = self.load_features(item["image_id"])
        return Instance(
            question_id=item["question_id"],
            type=item["type"],
            image_id=item["image_id"],
            filename=item["filename"],
            question=item["question"],
            question_tokens=self.vocab.encode_question(item["question"]),
            answers=item["answers"],
            **features,
        )


@META_DATASET.register()
class FeatureClassificationDataset(BaseDataset):
    """One sample per (question, answer) with the answer as a (1,) class id."""

    @property
    def questions(self):
        return [ann["question"] for ann in self.annotations]

    @property
    def answers(self):
        return [ann["answer"] for ann in self.annotations]

    def load_annotations(self, json_data: Dict) -> List[Dict]:
        images = self._index_images(json_data)
        annotations = []
        for ann in json_data["annotations"]:
            image = images.get(ann["image_id"])
            if image is None:
                continue
            question = preprocess_sentence(ann["question"], self.vocab.tokenizer)
            for answer in ann["answers"]:
                annotations.append({
                    "id": ann["id"],
                    "question": question,
                    "answer": preprocess_sentence(answer, self.vocab.tokenizer),
                    "image_id": ann["image_id"],
                    "filename": image["filename"],
                })
        return annotations

    def __getitem__(self, idx: int) -> Instance:
        item = self.annotations[idx]
        features = self.load_features(item["image_id"])
        return Instance(
            question_id=item["id"],
            image_id=item["image_id"],
            filename=item["filename"],
            question_tokens=self.vocab.encode_question(item["question"]),
            answer=self.vocab.encode_answer(item["answer"]),
            **features,
        )
