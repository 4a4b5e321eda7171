"""The port's spans and counters: one store for the whole process.

``span(name)`` times one stretch of work at a layer boundary (the loader, the
train step, the optimizer, the decode loop and its decoder stack); ``count(name,
n)`` adds to a counter (batches, rows, bytes sent to the device, kernel
launches, encoder rows projected to cross-attention keys and values).

Spans record only while :func:`recording` is entered or a ``torch.profiler``
runs; otherwise ``span`` reads three flags and returns a shared no-op context,
with no allocation, no clock read and no ``record_function``.  Counters always
count.  A recorded span keeps its name, the thread, ``time.perf_counter_ns()``
at its start and end, the index of the span that was open around it on the
same thread, and the batch it worked on (the loader's sequence number,
``Batch.batch_id``: given to the span, else its parent's, else the one
``set_batch`` named last on the thread); it also opens
``torch.profiler.record_function(name)``, so a running profiler shows it on the
device trace's clock.

A session is one stretch of recording: it opens at ``recording()``'s entry, or
at the first span recorded after a span found recording off, and keeps up to
:data:`MAX_SPANS` spans (``tracing.dropped`` counts the rest).
:func:`snapshot` returns the newest one: its spans, each name's count, total,
self time (its duration less what its children on the same thread cover) and
longest, and the counters' change over the session.

The span names (:data:`NAMES`) avoid the names that the benchmark's trace
reduction reads itself (``benchmark/portbench/trace.py``: its host ranges,
``entry:`` and ``Optimizer.``), so that spans never relabel its device time.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 1_000_000

# every span the port opens: name -> (thread, where)
NAMES = {
    "data.batch": ("loader", "one batch, loaded and collated: in a worker process "
                   "(num_workers >= 1, recorded as the batch arrives, the worker's pid as "
                   "thread), else DataLoader._make_batch on the producer thread"),
    "data.load": ("loader", "dataset.__getitem__ over one batch's indices"),
    "data.collate": ("loader", "utils.instance.collate of one batch"),
    "data.wait": ("caller", "BaseTask.device_batches blocked on the loader's queue"),
    "data.put_batch": ("caller", "BaseTask.put_batch: the batch's arrays to the device"),
    "train.step": ("caller", "BaseTask._train_step: one optimizer step"),
    "train.forward": ("caller", "zero_grad and the loss's forward"),
    "train.backward": ("caller", "loss.backward()"),
    "train.optimizer": ("caller", "optimizer.step() and scheduler.step()"),
    "eval.batch": ("caller", "one eval batch, device batch to answers on the host"),
    "eval.decode": ("caller", "the decode's dispatch (greedy_ids, generate)"),
    "eval.to_host": ("caller", "the ids to the host: .cpu() waits for the device"),
    "eval.strings": ("caller", "ids to answer strings"),
    "decode.encode": ("caller", "a decode's kernel bundles and invariant streams"),
    "decode.step": ("caller", "one position of a decode loop"),
    "decode.decoder": ("caller", "the Iterative M4C family's decoder stack over the answer "
                       "prefix: each quadratic greedy step, each teacher-forced forward"),
}


class Span(NamedTuple):
    name: str
    thread: int  # threading.get_native_id() of the thread that opened it
    start_ns: Optional[int]  # None while it opens
    end_ns: Optional[int]  # None while open
    parent: Optional[int]  # index of the enclosing span of the same thread
    batch: Optional[int]


class _Session:
    def __init__(self, number: int, counters: Dict[str, int]):
        self.number = number
        self.spans: List["_Recorded"] = []
        self.base = counters
        self.closed: Optional[Dict[str, int]] = None  # the counters at its end


_lock = threading.Lock()
_local = threading.local()
_counters: Dict[str, int] = {}
_sessions = itertools.count(1)
_batch_ids = itertools.count(1)
_session: Optional[_Session] = None
_forced = 0  # depth of recording()
_live = False  # the newest session takes spans


class _Off:
    """The span of a stretch that is not recorded."""

    __slots__ = ()
    batch = property(lambda self: None, lambda self, value: None)

    def __enter__(self):
        return self

    def __exit__(self, kind, value, traceback):
        return None


_OFF = _Off()


class _Recorded:
    __slots__ = ("name", "thread", "start_ns", "end_ns", "parent", "batch", "_session",
                 "_index", "_annotation")

    def __init__(self, name: str, batch: Optional[int]):
        self.name, self.batch = name, batch
        self.start_ns = self.end_ns = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        outer = stack[-1] if stack else None
        self.thread = threading.get_native_id()
        with _lock:
            session = _open_locked()
            if outer is not None and outer._session is not session:
                outer = None
            self.parent = None if outer is None else outer._index
            if self.batch is None:
                self.batch = outer.batch if outer is not None else getattr(_local, "batch", None)
            if len(session.spans) < MAX_SPANS:
                self._session, self._index = session, len(session.spans)
                session.spans.append(self)
            else:
                self._session = None
                _counters["tracing.dropped"] = _counters.get("tracing.dropped", 0) + 1
        stack.append(self)
        # each clock read comes before the profiler's op, which takes its own
        # timestamp once it has released the interpreter lock: a read after
        # it would also count the wait to take the lock back
        self._annotation = torch.profiler.record_function(self.name)
        self.start_ns = time.perf_counter_ns()
        self._annotation.__enter__()
        return self

    def __exit__(self, kind, value, traceback):
        self.end_ns = time.perf_counter_ns()
        self._annotation.__exit__(kind, value, traceback)
        _local.stack.pop()
        return None


def span(name: str, batch: Optional[int] = None):
    """A context around one stretch of `name` (a key of :data:`NAMES`) on
    the calling thread; its ``batch`` attribute may be set inside it."""
    if _forced or _profiler._is_profiler_enabled:
        return _Recorded(name, batch)
    if _live:
        _end_session()
    return _OFF


def record_finished(thread: int, batch: Optional[int], spans) -> None:
    """Spans that already ran, where no span could be opened (a loader worker
    process, on the same ``perf_counter_ns`` clock): each (name, start_ns,
    end_ns, parent), `parent` the position in `spans` of the span around it or
    None.  Recorded, with `thread` and `batch`, only where :func:`span` would
    record; no ``record_function``, since their time has passed."""
    if not (_forced or _profiler._is_profiler_enabled):
        if _live:
            _end_session()
        return
    with _lock:
        session = _open_locked()
        indices: List[Optional[int]] = []
        for name, start_ns, end_ns, parent in spans:
            if len(session.spans) >= MAX_SPANS:
                _counters["tracing.dropped"] = _counters.get("tracing.dropped", 0) + 1
                indices.append(None)
                continue
            record = _Recorded(name, batch)
            record.thread, record.start_ns, record.end_ns = thread, start_ns, end_ns
            record.parent = None if parent is None else indices[parent]
            record._session, record._index = session, len(session.spans)
            indices.append(record._index)
            session.spans.append(record)


def set_batch(batch_id: Optional[int]) -> None:
    """The batch the calling thread works on from now (spans without a
    batch of their own or of a parent record it)."""
    _local.batch = batch_id


def next_batch_id() -> int:
    """A new process-wide batch sequence number."""
    return next(_batch_ids)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`; counters count whether or not spans
    record, and never go down."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters(prefix: str = "") -> Dict[str, int]:
    """The counters whose names start with `prefix`, as they stand."""
    with _lock:
        return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def _open_locked() -> _Session:
    """The live session, a new one when none is (the caller holds _lock)."""
    global _session, _live
    if not _live or _session is None:
        _session = _Session(next(_sessions), dict(_counters))
        _live = True
    return _session


def _end_session() -> None:
    global _live
    with _lock:
        if _live and _session is not None:
            _session.closed = dict(_counters)
        _live = False


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside this context (a new session at the outermost
    entry), whether or not a profiler runs."""
    global _forced
    with _lock:
        _forced += 1
        outermost = _forced == 1
    if outermost:
        _end_session()
        with _lock:
            _open_locked()
    try:
        yield
    finally:
        with _lock:
            _forced -= 1
            last = _forced == 0
        if last and not _profiler._is_profiler_enabled:
            _end_session()


def session_number() -> int:
    """The newest session's number (0 before the first)."""
    session = _session
    return 0 if session is None else session.number


def snapshot() -> Optional[Dict]:
    """The newest session, or None before the first: ``session`` (its
    number), ``spans`` (:class:`Span` in the order they opened), ``names``
    (name -> count, total_ms, self_ms, max_ms over its closed spans) and
    ``counters`` (each counter's change over the session, where it moved)."""
    with _lock:
        session = _session
        if session is None:
            return None
        records = list(session.spans)
        now = session.closed if session.closed is not None else dict(_counters)
        base = session.base
    spans = [Span(r.name, r.thread, r.start_ns, r.end_ns, r.parent, r.batch) for r in records]
    covered = [0] * len(spans)
    for s in spans:
        if s.parent is not None and s.end_ns is not None:
            covered[s.parent] += s.end_ns - s.start_ns
    names: Dict[str, Dict[str, float]] = {}
    for s, children in zip(spans, covered):
        if s.end_ns is None:
            continue
        duration = s.end_ns - s.start_ns
        entry = names.setdefault(s.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0,
                                          "max_ms": 0.0})
        entry["count"] += 1
        entry["total_ms"] += duration / 1e6
        entry["self_ms"] += (duration - children) / 1e6
        entry["max_ms"] = max(entry["max_ms"], duration / 1e6)
    moved = {k: v - base.get(k, 0) for k, v in now.items() if v != base.get(k, 0)}
    return {"session": session.number, "spans": spans, "names": names, "counters": moved}
