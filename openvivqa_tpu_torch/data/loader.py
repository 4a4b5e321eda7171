"""Host-side batching pipeline with background prefetch.

The port's copy of ``openvivqa_tpu/data/loader.py``, for one process: a
thread pool hides the per-image `.npy` load latency, batches are collated to
static shapes (see utils/instance.py), and the final partial batch is padded
up to `batch_size` with a `sample_valid` mask.  Sharding batches over
processes waits for multi-process training (ROADMAP queue 1).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Mapping, Optional

import numpy as np

from ..utils.instance import Batch, collate


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        pad_to: Optional[Mapping[str, int]] = None,
        pad_values: Optional[Mapping[str, float]] = None,
        pad_last_batch: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        drop_last: bool = False,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.pad_to = pad_to
        self.pad_values = pad_values
        self.pad_last_batch = pad_last_batch
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(indices)
        return indices

    def _make_batch(self, indices, pool) -> Batch:
        samples = list(pool.map(self.dataset.__getitem__, indices))
        batch_pad_to = (
            self.batch_size
            if (self.pad_last_batch and len(samples) < self.batch_size)
            else None
        )
        return collate(
            samples,
            pad_to=self.pad_to,
            pad_values=self.pad_values,
            batch_pad_to=batch_pad_to,
        )

    def __iter__(self) -> Iterator[Batch]:
        order = self._order()
        self._epoch += 1
        n = len(order)
        spans = []
        for start in range(0, n, self.batch_size):
            chunk = order[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            spans.append(chunk)

        out_queue: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()  # consumer-abandoned-early signal

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    out_queue.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                try:
                    for span in spans:
                        if stop.is_set() or not _put(
                            self._make_batch(span, pool)
                        ):
                            return
                except BaseException as exc:  # surfaced on the consumer side
                    _put(exc)
                finally:
                    # BLOCKING (stop-aware) put: a slow consumer may leave
                    # the queue momentarily full — dropping the sentinel
                    # here would strand it in get() forever.  _put aborts
                    # only when the consumer has signalled stop.
                    _put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_queue.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # breaking out mid-epoch (or closing the generator) must not
            # leak the producer blocked in put() with its worker pool and
            # prefetched batches: signal, drain, reap.
            stop.set()
            while True:
                try:
                    out_queue.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=10)
