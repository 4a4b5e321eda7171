"""Raw-image datasets (for the ViT-backed models).

The port's copy of ``openvivqa_tpu/data/image_datasets.py``: each sample carries
``pixel_values``,
the image resized bilinearly to IMAGE_SIZE (224 by default) and normalised by
mean 0.5 and std 0.5 as an (H, W, 3) float32 array, in place of feature files,
beside the raw question string and its vocab encoding; the classification
variants carry the question's vocab encoding and the answer's class id.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..builders import META_DATASET
from ..utils.instance import Instance
from .datasets import FeatureClassificationDataset, FeatureDataset, teacher_forcing_pair
from .multilingual import (
    MultilingualDictionaryDataset,
    MultilingualFeatureDataset,
    RawQuestionDictionaryDataset,
    RawQuestionFeatureDataset,
)


class _ImageLoaderMixin:
    def _init_images(self, config) -> None:
        self.image_path = config.FEATURE_PATH.IMAGE
        self.image_size = int(config.get("IMAGE_SIZE", 224))

    def load_pixel_values(self, filename: str) -> np.ndarray:
        from PIL import Image

        path = os.path.join(self.image_path, filename)
        with Image.open(path) as img:
            img = img.convert("RGB").resize((self.image_size, self.image_size), Image.BILINEAR)
            array = np.asarray(img, dtype=np.float32) / 255.0
        return (array - 0.5) / 0.5  # the ViT image processor's mean and std

    def load_features(self, image_id: int) -> Dict:
        """Image datasets read pixels, not feature files."""
        return {}


@META_DATASET.register()
class ImageDataset(_ImageLoaderMixin, FeatureDataset):
    """Pixels, the question's vocab encoding and the teacher-forcing answer
    pair, one sample per (question, answer)."""

    def __init__(self, json_path: str, vocab, config) -> None:
        super().__init__(json_path, vocab, config)
        self._init_images(config)

    def __getitem__(self, idx: int) -> Instance:
        item = self.annotations[idx]
        answer, shifted_right = teacher_forcing_pair(
            self.vocab.encode_answer(item["answer"]), self.vocab.padding_idx, self.vocab.eos_idx
        )
        return Instance(
            image_id=item["image_id"],
            filename=item["filename"],
            pixel_values=self.load_pixel_values(item["filename"]),
            question_tokens=self.vocab.encode_question(item["question"]),
            answer_tokens=answer,
            shifted_right_answer_tokens=shifted_right,
        )


@META_DATASET.register()
class ImageQuestionDataset(_ImageLoaderMixin, RawQuestionFeatureDataset):
    """Raw question string + pixels, one sample per (question, answer)."""

    def __init__(self, json_path: str, vocab, config) -> None:
        super().__init__(json_path, vocab, config)
        self._init_images(config)

    def __getitem__(self, idx: int) -> Instance:
        item = self.annotations[idx]
        answer, shifted_right = teacher_forcing_pair(
            self.vocab.encode_answer(item["answer"]), self.vocab.padding_idx, self.vocab.eos_idx
        )
        return Instance(
            image_id=item["image_id"],
            filename=item["filename"],
            pixel_values=self.load_pixel_values(item["filename"]),
            answer_tokens=answer,
            shifted_right_answer_tokens=shifted_right,
            **self._question_payload(item),
        )


@META_DATASET.register()
class ImageQuestionDictionaryDataset(_ImageLoaderMixin, RawQuestionDictionaryDataset):
    """Raw question string + pixels + every answer, one sample per question."""

    def __init__(self, json_path: str, vocab, config) -> None:
        super().__init__(json_path, vocab, config)
        self._init_images(config)

    def __getitem__(self, idx: int) -> Instance:
        item = self.annotations[idx]
        return Instance(
            question_id=item["question_id"],
            type=item["type"],
            image_id=item["image_id"],
            filename=item["filename"],
            pixel_values=self.load_pixel_values(item["filename"]),
            answers=item["answers"],
            **self._question_payload(item),
        )


@META_DATASET.register()
class MultilingualImageQuestionDataset(ImageQuestionDataset):
    def load_annotations(self, json_data: Dict) -> List[Dict]:
        return MultilingualFeatureDataset.load_annotations(self, json_data)


@META_DATASET.register()
class MultilingualImageQuestionDictionaryDataset(ImageQuestionDictionaryDataset):
    def load_annotations(self, json_data: Dict) -> List[Dict]:
        return MultilingualDictionaryDataset.load_annotations(self, json_data)


@META_DATASET.register()
class ImageQuestionClassificationDataset(_ImageLoaderMixin, FeatureClassificationDataset):
    """Pixels + the question's vocab ids + the answer's class id, one sample
    per (question, answer)."""

    def __init__(self, json_path: str, vocab, config) -> None:
        super().__init__(json_path, vocab, config)
        self._init_images(config)

    def __getitem__(self, idx: int) -> Instance:
        item = self.annotations[idx]
        return Instance(
            question_id=item["id"],
            image_id=item["image_id"],
            filename=item["filename"],
            pixel_values=self.load_pixel_values(item["filename"]),
            question_tokens=self.vocab.encode_question(item["question"]),
            answer=self.vocab.encode_answer(item["answer"]),
        )


@META_DATASET.register()
class MultilingualImageQuestionClassificationDataset(ImageQuestionClassificationDataset):
    """Over multilingual annotations (a Japanese question and its answer by
    character); a sample's id is its index in the split."""

    def load_annotations(self, json_data: Dict) -> List[Dict]:
        annotations = MultilingualFeatureDataset.load_annotations(self, json_data)
        for i, ann in enumerate(annotations):
            ann.setdefault("id", i)
        return annotations
