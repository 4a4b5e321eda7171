"""Accuracy / Precision / Recall / F1 (token-set overlap): per-sample score is
averaged over all ground-truth answers, empty-side cases score by exact
equality.

The port's copy of ``openvivqa_tpu/evaluation/exact_metrics.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _per_key_mean(gts: Dict, res: Dict, score_fn) -> Tuple[float, np.ndarray]:
    assert gts.keys() == res.keys()
    scores = []
    for key in res:
        hypo = res[key][0]
        per_ref = [score_fn(hypo, gt) for gt in gts[key]]
        scores.append(float(np.mean(per_ref)))
    arr = np.asarray(scores)
    return float(arr.mean()), arr


def _overlap_stats(hypo: str, ref: str):
    h_tokens, r_tokens = hypo.split(), ref.split()
    if len(h_tokens) == 0 or len(r_tokens) == 0:
        return None, h_tokens, r_tokens
    return set(h_tokens) & set(r_tokens), h_tokens, r_tokens


class Accuracy:
    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        return _per_key_mean(gts, res, lambda hypo, gt: float(hypo == gt))

    def __str__(self) -> str:
        return "Accuracy"


class Precision:
    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        def score(hypo: str, gt: str) -> float:
            common, h_tokens, r_tokens = _overlap_stats(hypo, gt)
            if common is None:
                return float(h_tokens == r_tokens)
            return len(common) / len(h_tokens) if common else 0.0

        return _per_key_mean(gts, res, score)

    def __str__(self) -> str:
        return "Precision"


class Recall:
    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        def score(hypo: str, gt: str) -> float:
            common, h_tokens, r_tokens = _overlap_stats(hypo, gt)
            if common is None:
                return float(h_tokens == r_tokens)
            return len(common) / len(r_tokens) if common else 0.0

        return _per_key_mean(gts, res, score)

    def __str__(self) -> str:
        return "Recall"


class F1:
    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        def score(hypo: str, gt: str) -> float:
            common, h_tokens, r_tokens = _overlap_stats(hypo, gt)
            if common is None:
                return float(h_tokens == r_tokens)
            if not common:
                return 0.0
            prec = len(common) / len(h_tokens)
            rec = len(common) / len(r_tokens)
            return 2 * prec * rec / (prec + rec)

        return _per_key_mean(gts, res, score)

    def __str__(self) -> str:
        return "F1"
