"""Synthetic dataset generator.

The port's copy of ``openvivqa_tpu/data/synthetic.py``: annotation JSONs +
per-image `.npy` feature dicts in the schemas the datasets read (OCR datasets
additionally read a scene-text `.npy`), made from a seed, for tests and
``chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

_VI_WORDS = [
    "con", "mèo", "chó", "màu", "gì", "đỏ", "xanh", "vàng", "bao", "nhiêu",
    "người", "đang", "làm", "ngồi", "đứng", "trên", "bàn", "ghế", "xe", "đạp",
    "máy", "ở", "đâu", "trong", "nhà", "ngoài", "đường", "cây", "hoa", "quả",
    "ăn", "uống", "nước", "cơm", "một", "hai", "ba", "bốn", "năm", "trắng",
]


def _sentence(rng: np.random.Generator, lo: int, hi: int) -> str:
    n = int(rng.integers(lo, hi + 1))
    return " ".join(rng.choice(_VI_WORDS, size=n).tolist())


def generate_synthetic_dataset(
    root: str,
    n_images: int = 6,
    n_questions_per_image: int = 3,
    n_answers: int = 1,
    n_regions: int = 36,
    n_grids: int = 49,
    d_feature: int = 1024,
    d_grid_feature: int = 2048,
    max_scene_text: int = 10,
    d_ocr_det: int = 256,
    d_ocr_rec: int = 256,
    seed: int = 0,
    splits: Optional[Dict[str, float]] = None,
) -> Dict[str, str]:
    """Create annotations + features under `root`; returns paths dict.

    Layout:
      root/annotations/{train,dev,test}.json
      root/features/{image_id}.npy          (region/grid features + boxes)
      root/scene_text/{image_id}.npy        (OCR features, texts, boxes, scores)
    """
    rng = np.random.default_rng(seed)
    splits = splits or {"train": 0.6, "dev": 0.2, "test": 0.2}

    ann_dir = os.path.join(root, "annotations")
    feat_dir = os.path.join(root, "features")
    ocr_dir = os.path.join(root, "scene_text")
    img_dir = os.path.join(root, "images")
    for d in (ann_dir, feat_dir, ocr_dir, img_dir):
        os.makedirs(d, exist_ok=True)

    # features per image
    for image_id in range(n_images):
        boxes = rng.uniform(0, 1, size=(n_regions, 4)).astype(np.float32)
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 0.01)
        grid_boxes = rng.uniform(0, 1, size=(n_grids, 4)).astype(np.float32)
        grid_boxes[:, 2:] = np.maximum(grid_boxes[:, 2:], grid_boxes[:, :2] + 0.01)
        np.save(
            os.path.join(feat_dir, f"{image_id}.npy"),
            {
                "region_features": rng.normal(
                    size=(n_regions, d_feature)
                ).astype(np.float32),
                "region_boxes": boxes,
                "grid_features": rng.normal(
                    size=(n_grids, d_grid_feature)
                ).astype(np.float32),
                "grid_boxes": grid_boxes,
            },
            allow_pickle=True,
        )
        n_ocr = int(rng.integers(1, max_scene_text + 1))
        ocr_boxes = rng.uniform(0, 1, size=(n_ocr, 4)).astype(np.float32)
        ocr_boxes[:, 2:] = np.maximum(ocr_boxes[:, 2:], ocr_boxes[:, :2] + 0.01)
        np.save(
            os.path.join(ocr_dir, f"{image_id}.npy"),
            {
                "det_features": rng.normal(size=(n_ocr, d_ocr_det)).astype(
                    np.float32
                ),
                "rec_features": rng.normal(size=(n_ocr, d_ocr_rec)).astype(
                    np.float32
                ),
                "fasttext_features": rng.normal(size=(n_ocr, 300)).astype(
                    np.float32
                ),
                "texts": [
                    str(rng.choice(_VI_WORDS)) for _ in range(n_ocr)
                ],
                "boxes": ocr_boxes,
                "scores": rng.uniform(0.3, 1.0, size=(n_ocr,)).astype(np.float32),
            },
            allow_pickle=True,
        )

    # small raw JPEGs for the image-input (ViT) datasets; dedicated rng so
    # adding images never changes the generated text/features
    img_rng = np.random.default_rng(seed + 104729)
    try:
        from PIL import Image

        for image_id in range(n_images):
            pixels = img_rng.integers(0, 256, size=(32, 32, 3)).astype(np.uint8)
            Image.fromarray(pixels).save(os.path.join(img_dir, f"{image_id}.jpg"))
    except ImportError:
        pass

    # annotations split by image so every split shares the feature store
    images = [
        {"id": image_id, "filename": f"{image_id}.jpg"}
        for image_id in range(n_images)
    ]
    all_annotations: List[dict] = []
    ann_id = 0
    for image_id in range(n_images):
        for _ in range(n_questions_per_image):
            answers = [_sentence(rng, 1, 3) for _ in range(n_answers)]
            all_annotations.append(
                {
                    "id": ann_id,
                    "image_id": image_id,
                    "question": _sentence(rng, 3, 7) + " ?",
                    "answers": answers,
                    # the EVJVQA schema uses a singular "answer" key (the
                    # reference's multimodal vocabs read it while its
                    # datasets read "answers"); emit both so every
                    # consumer works
                    "answer": answers[0],
                    "QA-type": int(rng.integers(0, 3)),
                }
            )
            ann_id += 1

    rng.shuffle(all_annotations)  # type: ignore[arg-type]
    paths = {}
    start = 0
    for split, frac in splits.items():
        count = max(1, int(round(frac * len(all_annotations))))
        chunk = all_annotations[start : start + count]
        if not chunk:  # never emit an empty split
            chunk = all_annotations[-1:]
        start += count
        split_images = [
            img for img in images if any(a["image_id"] == img["id"] for a in chunk)
        ]
        path = os.path.join(ann_dir, f"{split}.json")
        with open(path, "w") as handle:
            json.dump({"images": split_images, "annotations": chunk}, handle)
        paths[split] = path

    paths["features"] = feat_dir
    paths["scene_text"] = ocr_dir
    paths["images"] = img_dir
    return paths
