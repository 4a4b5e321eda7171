"""Corpus BLEU-1..4 with COCO-caption semantics (clipped n-gram precision
against per-ngram max reference counts, 'closest' effective reference length,
tiny/small smoothing constants, brevity penalty exp(1 - 1/ratio) applied when
ratio < 1).

The port's copy of ``openvivqa_tpu/evaluation/bleu.py``.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple

_SMALL = 1e-9
_TINY = 1e-15


def _ngram_counts(tokens: Sequence[str], max_n: int) -> Counter:
    counts: Counter = Counter()
    for n in range(1, max_n + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i : i + n])] += 1
    return counts


def _closest_ref_len(ref_lens: Sequence[int], test_len: int) -> int:
    return min(ref_lens, key=lambda rl: (abs(rl - test_len), rl))


class Bleu:
    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[List[float], List[List[float]]]:
        assert gts.keys() == res.keys()
        n = self.n
        total_guess = [0] * n
        total_correct = [0] * n
        total_testlen = 0
        total_reflen = 0.0
        per_sentence: List[List[float]] = [[] for _ in range(n)]

        for key in gts:
            hypo_list = res[key]
            assert isinstance(hypo_list, list) and len(hypo_list) == 1
            refs = gts[key]
            assert isinstance(refs, list) and len(refs) >= 1

            hypo = hypo_list[0].split()
            test_len = len(hypo)
            ref_tokens = [ref.split() for ref in refs]
            ref_max: Counter = Counter()
            for ref in ref_tokens:
                for ngram, count in _ngram_counts(ref, n).items():
                    ref_max[ngram] = max(ref_max[ngram], count)

            guess = [max(0, test_len - k) for k in range(n)]
            correct = [0] * n
            for ngram, count in _ngram_counts(hypo, n).items():
                correct[len(ngram) - 1] += min(count, ref_max.get(ngram, 0))

            ref_len = _closest_ref_len([len(r) for r in ref_tokens], test_len)
            total_testlen += test_len
            total_reflen += ref_len
            for k in range(n):
                total_guess[k] += guess[k]
                total_correct[k] += correct[k]

            # per-sentence scores (smoothed like the COCO scorer)
            running = 1.0
            sent_scores = []
            for k in range(n):
                running *= (correct[k] + _TINY) / (guess[k] + _SMALL)
                sent_scores.append(running ** (1.0 / (k + 1)))
            ratio = (test_len + _TINY) / (ref_len + _SMALL)
            if ratio < 1:
                bp = math.exp(1 - 1 / ratio)
                sent_scores = [s * bp for s in sent_scores]
            for k in range(n):
                per_sentence[k].append(sent_scores[k])

        corpus = []
        running = 1.0
        for k in range(n):
            running *= (total_correct[k] + _TINY) / (total_guess[k] + _SMALL)
            corpus.append(running ** (1.0 / (k + 1)))
        ratio = (total_testlen + _TINY) / (total_reflen + _SMALL)
        if ratio < 1:
            bp = math.exp(1 - 1 / ratio)
            corpus = [s * bp for s in corpus]

        return corpus, per_sentence

    def __str__(self) -> str:
        return "BLEU"
