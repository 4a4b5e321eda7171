"""The benchmark's own synthetic OCR-VQA split, made from a seed (the
generator a traffic mix names with ``"generator": "ocr_vqa"``).

A copy of ``openvivqa_tpu_torch/data/synthetic.py::generate_synthetic_dataset``
(annotation JSONs and one ``.npy`` feature dict per image, in the schemas the
port's OCR datasets read), kept here so that a change to the port cannot move
the benchmark's data, and extended by a traffic mix's parameters: the image
count, questions per image, the question and answer word ranges and the OCR
token range.

Every seed gets the same multiset of sizes in another order: question, answer
and OCR lengths cycle through their whole ranges and are then shuffled, so the
longest question and answer (and with them the vocab's padded lengths) and the
total OCR token count are the same for every seed.  Object features are a
fixed count of regions per image (a Faster R-CNN export keeps a fixed number of
boxes); nothing else is written, so a run writes what the datasets read.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

VI_WORDS = [
    "con", "mèo", "chó", "màu", "gì", "đỏ", "xanh", "vàng", "bao", "nhiêu",
    "người", "đang", "làm", "ngồi", "đứng", "trên", "bàn", "ghế", "xe", "đạp",
    "máy", "ở", "đâu", "trong", "nhà", "ngoài", "đường", "cây", "hoa", "quả",
    "ăn", "uống", "nước", "cơm", "một", "hai", "ba", "bốn", "năm", "trắng",
]
# the OCR stream's three parts, as the port's OCR datasets read them: 256 + 256
# + 300 = 812, MODEL.OCR_EMBEDDING.D_FEATURE of the M4C configs
D_OCR_DET, D_OCR_REC, D_FASTTEXT = 256, 256, 300


def _cycled(rng: np.random.Generator, lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths that run through lo..hi in turn, shuffled: the same multiset
    for every seed."""
    values = lo + np.arange(n) % (hi - lo + 1)
    rng.shuffle(values)
    return values


def _boxes(rng: np.random.Generator, n: int) -> np.ndarray:
    corners = rng.uniform(0, 1, size=(n, 4)).astype(np.float32)
    corners[:, 2:] = np.maximum(corners[:, 2:], corners[:, :2] + 0.01)
    return corners


def generate(root: str, mix: Dict, seed: int) -> Dict[str, str]:
    """Write the split of traffic mix `mix` under `root`; returns the paths
    by name: "train", "dev", "test" (annotation JSONs), "features",
    "scene_text".

    `mix` keys: images, questions_per_image, regions, d_region,
    question_words [lo, hi], answer_words [lo, hi], ocr_tokens [lo, hi],
    splits {name: share}.
    """
    rng = np.random.default_rng(seed)
    n_images = int(mix["images"])
    per_image = int(mix["questions_per_image"])
    n_regions, d_region = int(mix["regions"]), int(mix["d_region"])
    ann_dir, feat_dir, ocr_dir = (os.path.join(root, d)
                                  for d in ("annotations", "features", "scene_text"))
    for d in (ann_dir, feat_dir, ocr_dir):
        os.makedirs(d, exist_ok=True)

    ocr_counts = _cycled(rng, *mix["ocr_tokens"], n_images)
    for image_id in range(n_images):
        np.save(os.path.join(feat_dir, f"{image_id}.npy"), {
            "region_features": rng.standard_normal((n_regions, d_region), np.float32),
            "region_boxes": _boxes(rng, n_regions),
        }, allow_pickle=True)
        n_ocr = int(ocr_counts[image_id])
        np.save(os.path.join(ocr_dir, f"{image_id}.npy"), {
            "det_features": rng.standard_normal((n_ocr, D_OCR_DET), np.float32),
            "rec_features": rng.standard_normal((n_ocr, D_OCR_REC), np.float32),
            "fasttext_features": rng.standard_normal((n_ocr, D_FASTTEXT), np.float32),
            "texts": [str(w) for w in rng.choice(VI_WORDS, size=n_ocr)],
            "boxes": _boxes(rng, n_ocr),
            "scores": rng.uniform(0.3, 1.0, size=(n_ocr,)).astype(np.float32),
        }, allow_pickle=True)

    n_questions = n_images * per_image
    question_lengths = _cycled(rng, *mix["question_words"], n_questions)
    answer_lengths = _cycled(rng, *mix["answer_words"], n_questions)
    annotations: List[dict] = []
    for image_id in range(n_images):
        for _ in range(per_image):
            k = len(annotations)
            question = " ".join(rng.choice(VI_WORDS, size=int(question_lengths[k])).tolist())
            answer = " ".join(rng.choice(VI_WORDS, size=int(answer_lengths[k])).tolist())
            annotations.append({
                "id": k, "image_id": image_id, "question": question + " ?",
                "answers": [answer], "answer": answer, "QA-type": int(rng.integers(0, 3)),
            })
    rng.shuffle(annotations)  # type: ignore[arg-type]

    images = [{"id": i, "filename": f"{i}.jpg"} for i in range(n_images)]
    paths, start = {}, 0
    for split, share in mix["splits"].items():
        chunk = annotations[start:start + int(round(share * n_questions))]
        start += len(chunk)
        used = {a["image_id"] for a in chunk}
        path = os.path.join(ann_dir, f"{split}.json")
        with open(path, "w") as handle:
            json.dump({"images": [img for img in images if img["id"] in used],
                       "annotations": chunk}, handle, ensure_ascii=False)
        paths[split] = path
    paths["features"], paths["scene_text"] = feat_dir, ocr_dir
    return paths


def config_keys(paths: Dict[str, str]) -> Dict[str, object]:
    """The configuration's dotted keys that point the OpenViVQA datasets of
    the OCR schema at the split written to `paths`."""
    keys: Dict[str, object] = {}
    for split in ("TRAIN", "DEV", "TEST"):
        keys[f"DATASET.JSON_PATH.{split}"] = paths[split.lower()]
        keys[f"DATASET.VOCAB.JSON_PATH.{split}"] = paths[split.lower()]
    for part in ("FEATURE_DATASET", "DICT_DATASET"):
        keys[f"DATASET.{part}.FEATURE_PATH.FEATURES"] = paths["features"]
        keys[f"DATASET.{part}.FEATURE_PATH.SCENE_TEXT"] = paths["scene_text"]
        keys[f"DATASET.{part}.FEATURE_PATH.IMAGE"] = None
    return keys
