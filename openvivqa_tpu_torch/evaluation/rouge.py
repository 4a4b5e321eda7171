"""ROUGE-L (LCS-based F-measure, beta=1.2), COCO-caption semantics: precision
and recall are maxed over references *independently* before combining, with
an O(len_a * len_b) single-row LCS.

The port's copy of ``openvivqa_tpu/evaluation/rouge.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _lcs_length(a: Sequence[str], b: Sequence[str]) -> int:
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        current = [0]
        for j, y in enumerate(b, start=1):
            if x == y:
                current.append(prev[j - 1] + 1)
            else:
                current.append(max(prev[j], current[-1]))
        prev = current
    return prev[-1]


class Rouge:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        assert len(candidate) == 1 and len(refs) > 0
        hypo = candidate[0].split(" ")
        precisions, recalls = [], []
        for ref in refs:
            ref_tokens = ref.split(" ")
            lcs = _lcs_length(ref_tokens, hypo)
            precisions.append(lcs / float(len(hypo)))
            recalls.append(lcs / float(len(ref_tokens)))
        p, r = max(precisions), max(recalls)
        if p != 0 and r != 0:
            beta_sq = self.beta**2
            return ((1 + beta_sq) * p * r) / float(r + beta_sq * p)
        return 0.0

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert gts.keys() == res.keys()
        scores = [self.calc_score(res[key], gts[key]) for key in gts]
        arr = np.asarray(scores)
        return float(arr.mean()), arr

    def __str__(self) -> str:
        return "ROUGE"
