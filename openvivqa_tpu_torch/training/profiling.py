"""Profiling hooks, the port's counterpart of ``openvivqa_tpu/training/profiling.py``.

``maybe_trace`` wraps a training epoch in a ``torch.profiler`` trace (host and
CUDA activities) when TRAINING.PROFILE_DIR is set, and the primary process
writes it there as a Chrome trace (``chrome://tracing``, Perfetto).
``StepTimer`` collects host-side step latencies with percentile summaries.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..logging_utils import setup_logger
from ..parallel.multihost import is_primary, process_index

logger = setup_logger()


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
    with profile(activities=activities) as prof:
        yield
    if is_primary():
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"trace_p{process_index()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        logger.info("Wrote profiler trace %s", path)


class StepTimer:
    """Host-side per-step latency tracker.

    The task loops keep losses on the device (no per-step sync), so these
    percentiles measure the host's dispatch of a step, not the device's step
    time: the epoch's wall-clock 'seconds' field is the end-to-end figure, and
    TRAINING.PROFILE_DIR traces give device time."""

    def __init__(self) -> None:
        self.durations = []
        self._last = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def stop(self) -> None:
        if self._last is not None:
            self.durations.append(time.perf_counter() - self._last)
            self._last = None

    def summary(self) -> dict:
        if not self.durations:
            return {}
        arr = np.asarray(self.durations)
        return {
            "steps": int(arr.size),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "max_s": float(arr.max()),
        }
