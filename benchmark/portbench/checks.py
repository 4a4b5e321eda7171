"""The numbers that decide `correct`, each against its limit from
``benchmark/limits/<cell>.json``.

Training: each checked step's loss, each leaf's first gradient as Adam holds
it after one step, each leaf's change after the checked steps, the program's
against the reference's; the worst step and leaf, and the median leaf's
change.  A gap of norms is |program - reference| over the
reference's norm of that leaf or the median leaf's, whichever is larger; the
worst leaf is compared.  Leaves whose reference gradient is under a thousandth
of the median leaf's (a key's bias under softmax: nought to rounding) are left
out of both norms' comparisons.

Greedy evaluation: at every decode step of each checked batch, the widest gap
by which the reference's score of the token the program chose lies below the
reference's best score.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

GRADIENT_FLOOR = 1e-3  # leaves below this share of the median gradient norm are left out


def _leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
               leaves: List[str]) -> Dict[str, float]:
    median = statistics.median(reference[name] for name in leaves)
    return {name: abs(program.get(name, 0.0) - reference[name])
            / max(reference[name], median, 1e-30) for name in leaves}


def counted_leaves(reference: Dict) -> List[str]:
    grads = reference["grad_norms"]
    median = statistics.median(grads.values())
    return sorted(name for name, value in grads.items() if value >= GRADIENT_FLOOR * median)


def train_numbers(program: Dict, reference: Dict) -> Dict[str, float]:
    """loss_gap (the worst step), grad_gap and change_gap (the worst leaf),
    change_gap_median (the median leaf's change gap: the steady number that
    the bf16 control moves and rounding in the attentions does not), and, for
    the notes, the median leaf's gradient gap and the worst leaves."""
    leaves = counted_leaves(reference)
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(program["loss"], reference["loss"]))
    if len(program["loss"]) != len(reference["loss"]):
        loss_gap = float("inf")
    grads = _leaf_gaps(program["grad_norms"], reference["grad_norms"], leaves)
    changes = _leaf_gaps(program["change_norms"], reference["change_norms"], leaves)
    return {"loss_gap": loss_gap, "grad_gap": max(grads.values()),
            "change_gap": max(changes.values()),
            "change_gap_median": statistics.median(changes.values()),
            "_grad_gap_median_leaf": statistics.median(grads.values()),
            "_grad_leaf": max(grads, key=grads.get), "_change_leaf": max(changes, key=changes.get),
            "_left_out": sorted(set(reference["grad_norms"]) - set(leaves))}


def judged(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(correct, {name: {"value", "limit"}}): every number with a limit is at
    or under it; a number without one, or a limit without a number, fails."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and value == value and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    return correct, checks
