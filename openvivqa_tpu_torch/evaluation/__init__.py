"""Metric dispatcher: the port's copy of ``openvivqa_tpu/evaluation``."""

from __future__ import annotations

from .bleu import Bleu
from .cider import Cider
from .exact_metrics import F1, Accuracy, Precision, Recall
from .meteor import Meteor
from .rouge import Rouge

__all__ = [
    "Bleu",
    "Cider",
    "Meteor",
    "Rouge",
    "Accuracy",
    "Precision",
    "Recall",
    "F1",
    "compute_scores",
]


def compute_scores(gts: dict, gen: dict):
    metrics = (
        Bleu(),
        Meteor(),
        Rouge(),
        Cider(),
        Accuracy(),
        Precision(),
        Recall(),
        F1(),
    )
    all_score = {}
    all_scores = {}
    for metric in metrics:
        score, scores = metric.compute_score(gts, gen)
        all_score[str(metric)] = score
        all_scores[str(metric)] = scores
    return all_score, all_scores
