"""OCR (scene-text) datasets.

The port's copy of the OcrFeatureDataset, OcrDictionaryDataset and
OcrClassificationDataset of
``openvivqa_tpu/data/ocr_datasets.py``: OCR streams are always padded or
truncated to MAX_SCENE_TEXT, scene-text scores gate via threshold + top-k, and
precomputed `fasttext_features` (when present in the store) are emitted as
`ocr_fasttext_features`.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np

from ..builders import META_DATASET
from ..utils.instance import Instance
from .datasets import DictionaryDataset, FeatureClassificationDataset, FeatureDataset


class _SceneTextMixin:
    def _init_scene_text(self, config) -> None:
        self.scene_text_features_path = config.FEATURE_PATH.SCENE_TEXT
        self.scene_text_threshold = config.get("SCENE_TEXT_THRESHOLD", 0.3)
        # iterative_m4c.yaml omits MAX_SCENE_TEXT in the dataset section
        # (a latent reference crash); default to the reference's usual cap
        self.max_scene_text = int(config.get("MAX_SCENE_TEXT", 100) or 100)
        self._scene_text_cache: Dict[int, Dict[str, Any]] = {}

    def load_scene_text_features(self, image_id: int) -> Dict[str, Any]:
        # honor CACHE_FEATURES here too: one sample per (question, answer)
        # re-reads the same image's scene-text file many times per epoch
        if self.cache_features and image_id in self._scene_text_cache:
            return self._scene_text_cache[image_id]
        feature_file = os.path.join(
            self.scene_text_features_path, f"{image_id}.npy"
        )
        raw = np.load(feature_file, allow_pickle=True)[()]

        scores = np.asarray(raw["scores"], dtype=np.float32)
        keep = scores >= self.scene_text_threshold
        order = np.nonzero(keep)[0]
        if order.size > self.max_scene_text:
            kept_scores = scores[order]
            top = np.argsort(-kept_scores, kind="stable")[: self.max_scene_text]
            order = order[top]

        n = order.size
        k = self.max_scene_text

        def take_pad(value, fill=0.0, key=""):
            if isinstance(value, np.ndarray) and value.dtype != object:
                value = np.asarray(value, np.float32)
                if value.ndim == 1 and value.size == 0 and key:
                    # a zero-detection export collapsed to shape (0,): the
                    # feature width is unrecoverable and padding would emit
                    # a (k, 1) block that crashes the joint concat later
                    # with no mention of the culprit
                    raise ValueError(
                        f"{feature_file}: '{key}' has collapsed empty shape "
                        "(0,); re-export zero-detection images with an "
                        "explicit (0, d) array"
                    )
                value = value[order]
                if value.ndim == 1:
                    value = value[:, None]
                out = np.full((k,) + value.shape[1:], fill, np.float32)
                out[:n] = value
                return out
            selected = [value[i] for i in order]
            selected += [self.vocab.padding_token] * (k - n)
            return selected

        texts = take_pad(list(raw["texts"]))
        features: Dict[str, Any] = {
            "ocr_det_features": take_pad(raw["det_features"], key="det_features"),
            "ocr_rec_features": take_pad(raw["rec_features"], key="rec_features"),
            "ocr_texts": texts,
            "ocr_boxes": take_pad(raw["boxes"], key="boxes"),
            "ocr_scores": take_pad(raw["scores"])[:, 0],
        }
        if "fasttext_features" in raw:
            features["ocr_fasttext_features"] = take_pad(
                raw["fasttext_features"], key="fasttext_features"
            )
        if self.cache_features:
            self._scene_text_cache[image_id] = features
        return features

    def merged_features(self, image_id: int) -> Dict[str, Any]:
        return {
            **self.load_features(image_id),
            **self.load_scene_text_features(image_id),
        }

    @staticmethod
    def clean_ocr_tokens(texts: List[str], padding_token: str) -> List[str]:
        return [t if str(t).strip() != "" else padding_token for t in texts]


@META_DATASET.register()
class OcrFeatureDataset(_SceneTextMixin, FeatureDataset):
    def __init__(self, json_path: str, vocab, config) -> None:
        super().__init__(json_path, vocab, config)
        self._init_scene_text(config)

    def __getitem__(self, idx: int) -> Instance:
        item = self.annotations[idx]
        features = self.merged_features(item["image_id"])

        ocr_tokens = self.clean_ocr_tokens(
            features["ocr_texts"], self.vocab.padding_token
        )
        question_tokens = self.vocab.encode_question(item["question"])
        answer_tokens = self.vocab.encode_answer(item["answer"], ocr_tokens)

        shifted_right_answer_tokens = np.full_like(
            answer_tokens, self.vocab.padding_idx
        )
        shifted_right_answer_tokens[:-1] = answer_tokens[1:]
        answer_tokens = np.where(
            answer_tokens == self.vocab.eos_idx, self.vocab.padding_idx, answer_tokens
        )

        return Instance(
            **features,
            image_id=item["image_id"],
            filename=item["filename"],
            ocr_tokens=ocr_tokens,
            question=" ".join(item["question"]),
            question_tokens=question_tokens,
            answer=item["answer"],
            answer_tokens=answer_tokens,
            shifted_right_answer_tokens=shifted_right_answer_tokens,
        )


@META_DATASET.register()
class OcrDictionaryDataset(_SceneTextMixin, DictionaryDataset):
    def __init__(self, json_path: str, vocab, config) -> None:
        super().__init__(json_path, vocab, config)
        self._init_scene_text(config)

    def __getitem__(self, idx: int) -> Instance:
        item = self.annotations[idx]
        features = self.merged_features(item["image_id"])
        ocr_tokens = self.clean_ocr_tokens(
            features["ocr_texts"], self.vocab.padding_token
        )
        return Instance(
            **features,
            question_id=item["question_id"],
            type=item["type"],
            image_id=item["image_id"],
            filename=item["filename"],
            ocr_tokens=ocr_tokens,
            question=" ".join(item["question"]),
            question_tokens=self.vocab.encode_question(item["question"]),
            answers=item["answers"],
        )


@META_DATASET.register()
class OcrClassificationDataset(_SceneTextMixin, FeatureClassificationDataset):
    """LoRRA classification: one sample per (question, answer), the answer a
    (1,) id over the classes and the sample's OCR slots."""

    def __init__(self, json_path: str, vocab, config) -> None:
        super().__init__(json_path, vocab, config)
        self._init_scene_text(config)

    def __getitem__(self, idx: int) -> Instance:
        item = self.annotations[idx]
        features = self.merged_features(item["image_id"])
        ocr_tokens = self.clean_ocr_tokens(features["ocr_texts"], self.vocab.padding_token)
        return Instance(
            **features,
            question_id=item.get("id", idx),
            image_id=item["image_id"],
            filename=item["filename"],
            question_tokens=self.vocab.encode_question(item["question"]),
            answer=self.vocab.encode_answer(item["answer"], ocr_tokens),
            ocr_tokens=ocr_tokens,
        )
