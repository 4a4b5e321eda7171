"""Profiling hooks, the port's counterpart of ``openvivqa_tpu/training/profiling.py``.

``maybe_trace`` wraps a training epoch in a ``torch.profiler`` trace (host and
CUDA activities) when TRAINING.PROFILE_DIR is set, and the primary process
writes it there as a Chrome trace (``chrome://tracing``, Perfetto).  Where the
installed torch accepts them, the profiler records every thread (so the
loader's ``data.*`` spans of ``utils.tracing`` are in the trace) and the
host's waits on the device.  ``EpochRecord`` gives a train epoch's
``metrics.jsonl`` record its time, its rate over the valid rows it trained
on, and, where the epoch recorded spans, their per-name aggregates.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from ..logging_utils import setup_logger
from ..parallel.multihost import is_primary, process_index
from ..utils import tracing

logger = setup_logger()


def _experimental_config():
    """Every thread and the CUDA sync events, where this torch takes them."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True, enable_cuda_sync_events=True)
    except TypeError:
        return None


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str], enabled: bool = True) -> Iterator[None]:
    if not profile_dir or not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logger.info("Profiling to %s", profile_dir)
    with profile(activities=activities, experimental_config=_experimental_config()) as prof:
        yield
    if is_primary():
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"trace_p{process_index()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        logger.info("Wrote profiler trace %s", path)


class EpochRecord:
    """Made before a train epoch; ``fields()`` after it: ``seconds``,
    ``samples_per_sec`` over the valid rows put on the device in between
    (``data.rows_valid``: the last batch's padding rows do not count), and
    ``spans``, the per-name aggregates of a session of spans that began in
    between (under TRAINING.PROFILE_DIR or ``tracing.recording()``)."""

    def __init__(self) -> None:
        self.start = time.time()
        self.rows = tracing.counters("data.rows_valid").get("data.rows_valid", 0)
        self.session = tracing.session_number()

    def fields(self) -> dict:
        seconds = time.time() - self.start
        rows = tracing.counters("data.rows_valid").get("data.rows_valid", 0) - self.rows
        out = {"seconds": seconds, "samples_per_sec": round(rows / max(seconds, 1e-9), 2)}
        snapshot = tracing.snapshot()
        if snapshot is not None and snapshot["session"] > self.session:
            out["spans"] = snapshot["names"]
        return out
