"""What a run sees of the program: the host clock around the loader, the
benchmark's own host ranges, the port's kernel entry points with the work of
each call, and the profiler's device trace over a traced slice.

The ranges are placed from the benchmark's files, around the calls into each
layer; spans inside the port are for a later change.  Entry points are wrapped
only while a slice is traced, so the measured window runs the port as it is.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

# the benchmark's host ranges that label the device's idle gaps
LABELS = ("loader.next", "train_step", "optimizer.step", "scheduler.step",
          "generate_answers", "answers_to_host")


def host_range(name: str, enabled: bool):
    if not enabled:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


class Feed:
    """(host batch, device batch) pairs of `loader` through the task's
    ``device_batches``, one epoch after another, with the host's wait for
    each on the clock."""

    def __init__(self, task, loader):
        self.task, self.loader = task, loader
        self.epochs = 0
        self.waits: List[float] = []
        self.ranges = False
        self._iterator = iter(task.device_batches(loader))

    def next(self):
        start = time.perf_counter()
        with host_range("loader.next", self.ranges):
            while True:
                try:
                    item = next(self._iterator)
                    break
                except StopIteration:
                    self._iterator = iter(self.task.device_batches(self.loader))
                    self.epochs += 1
        self.waits.append(time.perf_counter() - start)
        return item

    def close(self) -> None:
        """End the feed's loader threads (the loader joins its producer)."""
        self._iterator.close()


def tensor_bytes(*items) -> int:
    """Bytes of every tensor in `items` (nested in tuples, lists and dicts)."""
    total = 0
    for item in items:
        if isinstance(item, torch.Tensor):
            total += item.numel() * item.element_size()
        elif isinstance(item, dict):
            total += tensor_bytes(*item.values())
        elif isinstance(item, (tuple, list)):
            total += tensor_bytes(*item)
    return total


class Entries:
    """The port's kernel entry points, each wrapped in a host range
    ``entry:<name>`` that records the work of every call from its shapes
    (``benchmark/work/entries/<name>.py``)."""

    def __init__(self, works: Dict):
        self.works = works
        self.calls: Dict[str, List[Tuple[float, float]]] = {name: [] for name in works}
        self.backward_calls: Dict[str, List[Tuple[float, float]]] = {name: [] for name in works}

    @contextlib.contextmanager
    def wrapped(self) -> Iterator[None]:
        import importlib

        saved = []
        for name, work in self.works.items():
            module = importlib.import_module(work.MODULE)
            saved.append((module, work.ATTRIBUTE, module.__dict__[work.ATTRIBUTE]))
            setattr(module, work.ATTRIBUTE, self._wrap(name, work, getattr(module, work.ATTRIBUTE)))
            owner_name = getattr(work, "BACKWARD_OWNER", None)
            if owner_name:
                owner = getattr(module, owner_name)
                saved.append((owner, "backward", owner.__dict__["backward"]))
                setattr(owner, "backward", staticmethod(_ranged(f"entry:{name}.backward",
                                                                owner.backward)))
        try:
            yield
        finally:
            for owner, attribute, original in saved:
                setattr(owner, attribute, original)

    def _wrap(self, name: str, work, original: Callable):
        calls, backward_calls = self.calls[name], self.backward_calls[name]

        def entry(*args, **kwargs):
            with torch.profiler.record_function(f"entry:{name}"):
                out = original(*args, **kwargs)
            calls.append(work.forward(args, kwargs, out))
            if getattr(work, "BACKWARD_OWNER", None) and isinstance(out, torch.Tensor) \
                    and out.requires_grad:
                backward_calls.append(work.backward(args, kwargs, out))
            return out

        return entry


def _ranged(label: str, fn: Callable) -> Callable:
    def ranged(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return ranged


def _interval(event) -> Tuple[float, float]:
    return event.time_range.start, event.time_range.end


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(s, e) for s, e in out]


def kernel_name(name: str) -> str:
    match = re.search(r"(\w+)\s*[<(]", name.replace("(anonymous namespace)", ""))
    return (match.group(1) if match else name)[:64]


class Slice:
    """One traced slice of a run: torch.profiler over the work `body` does,
    reduced to the device's busy time, its idle gaps by the host range that
    was open, device time by kernel and by host range, and the kernel entry
    points' work and device time."""

    WINDOW = "portbench.window"

    def __init__(self, entries: Optional[Entries] = None):
        self.entries = entries
        self.result: Dict = {}

    @contextlib.contextmanager
    def run(self) -> Iterator[None]:
        from torch.profiler import ProfilerActivity, profile

        wrap = self.entries.wrapped() if self.entries else contextlib.nullcontext()
        card = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
        with wrap, profile(activities=activities) as prof:
            with torch.profiler.record_function(self.WINDOW):
                yield
                if card:
                    torch.cuda.synchronize()
        self.result = self.reduce(prof.events())

    def reduce(self, events) -> Dict:
        """Busy time and idle gaps over the window's host interval, from the
        device's kernels and copies (not the profiler's device-side mirrors of
        host ranges); each host range's device time is the time of the
        kernels that start inside its device-side mirror."""
        cuda = torch.autograd.DeviceType.CUDA
        window = [e for e in events if e.name == self.WINDOW and e.device_type != cuda]
        if not window:
            raise RuntimeError("the profiler kept no window range")
        w_start, w_end = _interval(window[0])
        mirrors = [e for e in events if e.device_type == cuda and _is_range(e)]
        kernels = sorted((e for e in events if e.device_type == cuda and not _is_range(e)),
                         key=lambda e: e.time_range.start)
        spans = merged([(max(s, w_start), min(e, w_end)) for s, e in map(_interval, kernels)
                        if e > w_start and s < w_end])
        busy_us = sum(e - s for s, e in spans)

        by_kernel: Dict[str, float] = {}
        for event in kernels:
            key = kernel_name(event.name)
            by_kernel[key] = by_kernel.get(key, 0.0) + event.time_range.elapsed_us()

        ranges = [(e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type != cuda and e.name in LABELS]
        gaps: Dict[str, float] = {}
        edges = [w_start] + [x for span in spans for x in span] + [w_end]
        for start, end in zip(edges[::2], edges[1::2]):
            if end <= start:
                continue
            open_ = [r for r in ranges if r[0] <= start < r[1]]
            label = max(open_, key=lambda r: r[0])[2] if open_ else "other"
            gaps[label] = gaps.get(label, 0.0) + (end - start)

        unmirrored: Dict[str, float] = {}
        starts = [e.time_range.start for e in kernels]
        totals = [0.0]
        for event in kernels:
            totals.append(totals[-1] + event.time_range.elapsed_us())
        range_device: Dict[str, float] = {}
        for mirror in mirrors:
            lo = bisect.bisect_left(starts, mirror.time_range.start)
            hi = bisect.bisect_left(starts, mirror.time_range.end)
            range_device[mirror.name] = (range_device.get(mirror.name, 0.0)
                                         + totals[hi] - totals[lo])
        # a range the profiler gave no device-side mirror (one holding another
        # annotation, as torch's own "Optimizer.step#Adam.step"): the kernels
        # that its operators launched
        mirrored = {m.name for m in mirrors}
        for event in events:
            if (event.device_type != cuda and event.name in LABELS
                    and event.name not in mirrored):
                unmirrored[event.name] = unmirrored.get(event.name, 0.0) + event.device_time_total
        range_device.update(unmirrored)
        result = {
            "window_s": (w_end - w_start) / 1e6,
            "busy_s": busy_us / 1e6,
            "device_ops": sorted(([k, v / 1e6] for k, v in by_kernel.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(([k, v / 1e6] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:10],
            "range_device_s": {k: v / 1e6 for k, v in range_device.items()},
        }
        if self.entries is not None:
            result["entries"] = self._entries(range_device)
        return result

    def _entries(self, range_device: Dict[str, float]) -> Dict:
        """Per entry (and its backward): the calls' (FLOPs, bytes) and the
        device time of the kernels inside them."""
        out = {}
        for name in self.entries.works:
            for label, calls in ((name, self.entries.calls[name]),
                                 (name + ".backward", self.entries.backward_calls[name])):
                if calls:
                    out[label] = {"work": list(calls),
                                  "device_s": range_device.get(f"entry:{label}", 0.0) / 1e6}
        return out


def _is_range(event) -> bool:
    """A device-side mirror of a host range (a user annotation), not work."""
    if getattr(event, "is_user_annotation", False):
        return True
    name = event.name
    return (name in LABELS or name == Slice.WINDOW or name.startswith("entry:")
            or name.startswith("Optimizer."))
