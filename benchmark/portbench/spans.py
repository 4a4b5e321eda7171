"""The port's own spans and counters over a run's traced slice
(``openvivqa_tpu_torch.utils.tracing``: its newest session is the slice's,
recorded while the profiler ran), for the per-layer readers of
``benchmark/metrics/``.  A run without a traced slice, or a checkout whose
port has no such store, gives None."""

from __future__ import annotations

from typing import Callable, Dict, Optional

# the span of one unit of each end-to-end rate's work: a train step, an eval batch
UNITS = {"train_samples_per_s": "train.step", "eval_samples_per_s": "eval.batch"}


def session(record: Dict) -> Optional[Dict]:
    if not record.get("trace"):
        return None
    try:
        from openvivqa_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def total_ms(snapshot: Dict, name: str) -> Optional[float]:
    entry = snapshot["names"].get(name)
    return entry["total_ms"] if entry else None


def per_unit(record: Dict, metric: Dict, total: Callable[[Dict], Optional[float]]):
    """total(snapshot) over the slice's units of the work whose rate `metric`
    moves (its ``train.step`` or ``eval.batch`` spans)."""
    snapshot = session(record)
    if snapshot is None:
        return None
    unit = snapshot["names"].get(UNITS[metric["moves"]])
    value = total(snapshot)
    if not unit or value is None:
        return None
    return value / unit["count"]


def span_per_unit(record: Dict, metric: Dict, name: str):
    """The time inside the port's `name` spans a unit of work, in ms."""
    return per_unit(record, metric, lambda snapshot: total_ms(snapshot, name))
