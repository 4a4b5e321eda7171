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


def write_images(img_dir: str, n_images: int, seed: int) -> None:
    """Small raw JPEGs {image_id}.jpg for the image-input (ViT) datasets, the
    JAX package's generator's files: 32 x 32 uniform noise from a generator of
    their own (seed + 104729), so adding images never changes the generated
    text and features."""
    from PIL import Image

    img_rng = np.random.default_rng(seed + 104729)
    for image_id in range(n_images):
        pixels = img_rng.integers(0, 256, size=(32, 32, 3)).astype(np.uint8)
        Image.fromarray(pixels).save(os.path.join(img_dir, f"{image_id}.jpg"))


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
      root/images/{image_id}.jpg             (see write_images)
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

    write_images(img_dir, n_images, seed)

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


# hiragana, katakana and kanji for the Japanese questions of the EVJVQA layout
_JA_CHARS = list("これはなんですかいろのねこいぬくるまあかあおしろくろどこにありますひとつふたつ"
                 "ネコイヌ車赤青白黒何色人家木花")
_EVJVQA_SPLITS = {"train": 0.55, "dev": 0.15, "public_test": 0.15, "private_test": 0.15}


def _ja_sentence(rng: np.random.Generator, lo: int, hi: int) -> str:
    n = int(rng.integers(lo, hi + 1))
    return "".join(rng.choice(_JA_CHARS, size=n).tolist())


# the VinVL feature store of configs/joint_transformer_vlsp.yaml: up to 100
# regions of 2048 (REGION_EMBEDDING.D_FEATURE), a 7 x 7 grid of 1024
# (GRID_EMBEDDING.D_FEATURE)
_VINVL_REGIONS, _VINVL_D_REGION, _VINVL_GRIDS, _VINVL_D_GRID = 100, 2048, 49, 1024


def write_vinvl_features(feat_dir: str, n_images: int, seed: int) -> None:
    """A VinVL-shaped feature store, {image_id}.npy per image: region_features
    (r, 2048) with r drawn from [75, 100] (a detector keeps a varying number of
    boxes; the datasets pad to MAX_REGIONS), region_boxes (r, 4),
    grid_features (49, 1024) and grid_boxes (49, 4), boxes as (x1, y1, x2, y2)
    in [0, 1].  Drawn from a generator of its own (seed + 7919), so the
    features never change the generated text or images."""
    rng = np.random.default_rng(seed + 7919)

    def boxes(n):
        corners = rng.uniform(0, 1, size=(n, 4)).astype(np.float32)
        corners[:, 2:] = np.maximum(corners[:, 2:], corners[:, :2] + 0.01)
        return corners

    for image_id in range(n_images):
        regions = int(rng.integers(_VINVL_REGIONS - _VINVL_REGIONS // 4, _VINVL_REGIONS + 1))
        np.save(os.path.join(feat_dir, f"{image_id}.npy"), {
            "region_features": rng.normal(size=(regions, _VINVL_D_REGION)).astype(np.float32),
            "region_boxes": boxes(regions),
            "grid_features": rng.normal(size=(_VINVL_GRIDS, _VINVL_D_GRID)).astype(np.float32),
            "grid_boxes": boxes(_VINVL_GRIDS),
        }, allow_pickle=True)


# the ViT feature store of configs/vit_mbert_generation.yaml (FEATURE_PATH.FEATURES
# features/EVJVQA/vit, FeatureEmbedding D_FEATURE 768): ViT-base's last hidden states
# at 224 px, patch 16, 196 patches + CLS
_VIT_TOKENS, _VIT_D = 197, 768


def write_vit_features(feat_dir: str, n_images: int, seed: int) -> None:
    """A ViT-shaped feature store, {image_id}.npy per image: grid_features
    (197, 768), LayerNorm-scaled draws (no row is all zero, so none reads as
    padding).  Drawn from a generator of its own (seed + 7927)."""
    os.makedirs(feat_dir, exist_ok=True)
    rng = np.random.default_rng(seed + 7927)
    for image_id in range(n_images):
        np.save(os.path.join(feat_dir, f"{image_id}.npy"), {
            "grid_features": rng.normal(size=(_VIT_TOKENS, _VIT_D)).astype(np.float32),
        }, allow_pickle=True)


def generate_evjvqa_dataset(
    root: str,
    n_images: int = 12,
    n_questions_per_image: int = 3,
    ja_share: float = 0.3,
    seed: int = 0,
) -> Dict[str, str]:
    """An EVJVQA-shaped set (the VLSP 2022 contest's layout): raw images, a
    VinVL-shaped feature store per image (``write_vinvl_features``) and four
    annotation splits, train, dev, public test and private test (55, 15, 15
    and 15 %), in which about `ja_share` of the questions are Japanese (8-24
    characters, one answer of 2-6) and the rest Vietnamese (3-7 words, one
    answer of 1-3).  Returns the paths by split name, "images" and
    "features".

    Layout:
      root/annotations/evjvqa_{train,dev,public_test,private_test}.json
      root/images/{image_id}.jpg             (see write_images)
      root/features/{image_id}.npy           (see write_vinvl_features)
    """
    rng = np.random.default_rng(seed)
    ann_dir = os.path.join(root, "annotations")
    img_dir = os.path.join(root, "images")
    feat_dir = os.path.join(root, "features")
    for d in (ann_dir, img_dir, feat_dir):
        os.makedirs(d, exist_ok=True)
    write_images(img_dir, n_images, seed)
    write_vinvl_features(feat_dir, n_images, seed)

    annotations: List[dict] = []
    for image_id in range(n_images):
        for _ in range(n_questions_per_image):
            if rng.random() < ja_share:
                question, answers = _ja_sentence(rng, 8, 24), [_ja_sentence(rng, 2, 6)]
            else:
                question, answers = _sentence(rng, 3, 7) + " ?", [_sentence(rng, 1, 3)]
            annotations.append({
                "id": len(annotations), "image_id": image_id, "question": question,
                "answers": answers, "QA-type": int(rng.integers(0, 3)),
            })
    rng.shuffle(annotations)  # type: ignore[arg-type]

    images = [{"id": i, "filename": f"{i}.jpg"} for i in range(n_images)]
    paths = {}
    start = 0
    for split, frac in _EVJVQA_SPLITS.items():
        count = max(1, int(round(frac * len(annotations))))
        chunk = annotations[start:start + count] or annotations[-1:]
        start += count
        used = {a["image_id"] for a in chunk}
        path = os.path.join(ann_dir, f"evjvqa_{split}.json")
        with open(path, "w") as handle:
            json.dump({"images": [img for img in images if img["id"] in used],
                       "annotations": chunk}, handle, ensure_ascii=False)
        paths[split] = path
    paths["images"] = img_dir
    paths["features"] = feat_dir
    return paths
