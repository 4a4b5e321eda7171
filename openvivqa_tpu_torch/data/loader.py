"""Host-side batching pipeline with background prefetch.

The port's copy of ``openvivqa_tpu/data/loader.py``: a thread pool hides the
per-image `.npy` load latency, batches are collated to static shapes (see
utils/instance.py), and the final partial batch is padded up to `batch_size`
with a `sample_valid` mask.  Under ``torch.distributed`` each data group
(``parallel.mesh.data_shard``: every process without a model axis) reads a
disjoint round-robin share of the batches, wrap-padded to a common count.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Mapping, Optional

import numpy as np

from ..parallel.mesh import data_shard
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
        process_shard: bool = True,
        num_shards: Optional[int] = None,
        shard_id: Optional[int] = None,
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
        # each process reads every num_shards-th batch from shard_id on; every
        # process shuffles from the same seed, so all see one global order.
        # The defaults are the data axis's count and index; explicit
        # values override them (and make the sharding testable in one process)
        self.process_shard = process_shard
        self.num_shards = num_shards
        self.shard_id = shard_id
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def _shard_info(self) -> tuple:
        if self.num_shards is not None:
            return max(1, self.num_shards), self.shard_id or 0
        if not self.process_shard:
            return 1, 0
        return data_shard()

    def _n_batches(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __len__(self) -> int:
        num_shards, _ = self._shard_info()
        n = self._n_batches()
        if num_shards <= 1 or n == 0:
            return n
        return -(-n // num_shards)  # every shard padded up to the ceiling

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
        num_shards, shard_id = self._shard_info()
        if num_shards > 1 and spans:
            # wrap-pad to a common per-shard count (DistributedSampler's rule):
            # every train step is a collective, so a process with fewer batches
            # would stall the others at the uneven tail.  Repeated eval batches
            # merge by key in gather_eval_dicts.  The wrap cycles, so that even
            # fewer batches than processes leave none of them empty
            per_shard = -(-len(spans) // num_shards)
            spans = spans + [spans[i % len(spans)]
                             for i in range(per_shard * num_shards - len(spans))]
            spans = spans[shard_id::num_shards]

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
