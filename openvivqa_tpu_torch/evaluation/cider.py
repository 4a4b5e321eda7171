"""CIDEr (TF-IDF weighted n-gram cosine similarity with clipping + gaussian
length penalty), COCO-caption semantics: per-n tf-idf vectors with idf =
log(N_ref_images) - log(max(1, df)), clipped hypothesis counts, gaussian
penalty exp(-delta^2 / (2 sigma^2)) on the *bigram-count* length delta, mean
over n, averaged over references, x10.  The document-frequency table can be
pre-computed once (SCST reward path).

The port's copy of ``openvivqa_tpu/evaluation/cider.py``.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np


def _ngrams(sentence: str, max_n: int) -> Counter:
    words = sentence.split()
    counts: Counter = Counter()
    for n in range(1, max_n + 1):
        for i in range(len(words) - n + 1):
            counts[tuple(words[i : i + n])] += 1
    return counts


class Cider:
    def __init__(self, gts: Optional[Dict] = None, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma
        self.doc_frequency: Optional[Dict[tuple, float]] = None
        self.ref_len: Optional[float] = None
        if gts is not None:
            self.doc_frequency, self.ref_len = self._build_df(
                [[_ngrams(ref, n) for ref in refs] for refs in gts.values()]
            )

    @staticmethod
    def _build_df(cooked_refs: List[List[Counter]]):
        df: Dict[tuple, float] = defaultdict(float)
        for refs in cooked_refs:
            for ngram in {ng for ref in refs for ng in ref}:
                df[ngram] += 1
        return df, float(np.log(float(len(cooked_refs))))

    def _tfidf_vec(self, counts: Counter, doc_frequency, ref_len):
        vec = [defaultdict(float) for _ in range(self.n)]
        norm = [0.0] * self.n
        length = 0
        for ngram, term_freq in counts.items():
            # .get, not [] — indexing a shared defaultdict (the precomputed
            # SCST-reward DF) would permanently insert a key per novel
            # hypothesis n-gram, leaking host memory across training steps
            df = np.log(max(1.0, doc_frequency.get(ngram, 0.0)))
            order = len(ngram) - 1
            weight = float(term_freq) * (ref_len - df)
            vec[order][ngram] = weight
            norm[order] += weight * weight
            if order == 1:
                length += term_freq
        return vec, [math.sqrt(x) for x in norm], length

    def _similarity(self, hyp, ref) -> np.ndarray:
        vec_h, norm_h, len_h = hyp
        vec_r, norm_r, len_r = ref
        delta = float(len_h - len_r)
        penalty = math.e ** (-(delta**2) / (2 * self.sigma**2))
        val = np.zeros(self.n)
        for order in range(self.n):
            acc = 0.0
            for ngram, weight in vec_h[order].items():
                ref_weight = vec_r[order].get(ngram, 0.0)
                acc += min(weight, ref_weight) * ref_weight
            if norm_h[order] != 0 and norm_r[order] != 0:
                acc /= norm_h[order] * norm_r[order]
            val[order] = acc * penalty
        return val

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert gts.keys() == res.keys()
        cooked_refs = {k: [_ngrams(r, self.n) for r in gts[k]] for k in gts}
        cooked_hyps = {k: _ngrams(res[k][0], self.n) for k in res}

        if self.doc_frequency is not None:
            doc_frequency, ref_len = self.doc_frequency, self.ref_len
        else:
            doc_frequency, ref_len = self._build_df(list(cooked_refs.values()))

        scores = []
        for key in gts:
            hyp_vec = self._tfidf_vec(cooked_hyps[key], doc_frequency, ref_len)
            per_n = np.zeros(self.n)
            for ref_counts in cooked_refs[key]:
                ref_vec = self._tfidf_vec(ref_counts, doc_frequency, ref_len)
                per_n += self._similarity(hyp_vec, ref_vec)
            score = float(per_n.mean()) / len(cooked_refs[key]) * 10.0
            scores.append(score)

        arr = np.asarray(scores)
        return float(arr.mean()), arr

    def __str__(self) -> str:
        return "CIDEr"
