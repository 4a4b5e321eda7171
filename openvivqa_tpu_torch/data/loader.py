"""Host-side batching pipeline with background prefetch.

The port's copy of ``openvivqa_tpu/data/loader.py``: batches are collated to
static shapes (see utils/instance.py), and the final partial batch is padded
up to `batch_size` with a `sample_valid` mask.

``num_workers`` means what it means upstream
(``torch.utils.data.DataLoader(num_workers=...)``): with 1 or more, forked
worker processes each make whole batches (``dataset.__getitem__`` over the
batch's indices, then ``collate``), so the consuming thread never waits on
batch making for the interpreter lock; with 0, a producer thread of the
consuming process makes them.  A worker lays a batch's large arrays out in a
slot of a shared-memory ring (:class:`_Ring`) that the consumer wraps without
a copy; everything else crosses the worker's pipe.

Each batch carries a process-wide sequence number (``Batch.batch_id``), handed
out in the consuming process in batch order, which the spans of
``utils.tracing`` that work on it record: ``data.batch`` (its ``data.load``
and ``data.collate``), opened on the producer thread or timed in the worker
and recorded when its batch arrives, and the consumer's spans downstream.
Under ``torch.distributed`` each data group (``parallel.mesh.data_shard``:
every process without a model axis) reads a disjoint round-robin share of the
batches, wrap-padded to a common count.
"""

from __future__ import annotations

import contextlib
import mmap
import multiprocessing
import os
import queue
import signal
import threading
import time
import traceback
import weakref
from multiprocessing import reduction
from typing import Iterator, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np

from ..parallel.mesh import data_shard
from ..utils import tracing
from ..utils.instance import Batch, collate

# a worker puts a numeric field of at least this many bytes in the ring;
# smaller ones cost little to pickle, and a consumer that keeps one of them
# (a mask, ids) should not hold a whole slot
RING_MIN_BYTES = 1 << 20
# ring slots beyond the batches in flight: the batches a consumer holds
# (device_batches' queue, a benchmark's traced slice); past them a batch
# crosses the pipe
HELD_SLOTS = 32
_ALIGN = 64  # byte alignment of each field in a slot
_POPULATE = getattr(mmap, "MAP_POPULATE", 0)


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
        self.num_workers = max(0, num_workers)
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
        self._workers: Optional[_Workers] = None
        self._reap = None

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

    def _settings(self) -> tuple:
        return self.batch_size, self.pad_last_batch, self.pad_to, self.pad_values

    def _make_batch(self, indices) -> Batch:
        batch_id = tracing.next_batch_id()
        with tracing.span("data.batch", batch_id):
            with tracing.span("data.load"):
                # looked up on the instance, so that a __getitem__ set on it counts
                samples = [self.dataset.__getitem__(i) for i in indices]
            with tracing.span("data.collate"):
                batch = _collate(samples, self._settings())
        batch.batch_id = batch_id
        return batch

    def _spans(self) -> List[np.ndarray]:
        """This epoch's batches of indices, for this process's shard."""
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
        return spans

    def __iter__(self) -> Iterator[Batch]:
        spans = self._spans()
        if not spans:
            return
        if self.num_workers == 0:
            yield from self._in_thread(spans)
        else:
            yield from self._in_workers(spans)

    def _in_thread(self, spans) -> Iterator[Batch]:
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
            try:
                for span in spans:
                    if stop.is_set() or not _put(self._make_batch(span)):
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
            # leak the producer blocked in put() with its prefetched
            # batches: signal, drain, reap.
            stop.set()
            while True:
                try:
                    out_queue.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=10)

    def _in_workers(self, spans) -> Iterator[Batch]:
        # the workers live for the loader's lifetime: forked at its first
        # iteration (they see the dataset as it was then, and keep their
        # CACHE_FEATURES caches and numpy's global generator from epoch to
        # epoch), reaped with the loader or when an iteration ends early
        if self._workers is None:
            self._workers = _Workers(self.num_workers, self.num_workers * self.prefetch,
                                     self.dataset, self._settings())
            self._reap = weakref.finalize(self, self._workers.close)
        workers, count = self._workers, self.num_workers
        depth = count * self.prefetch
        tasks: List[Optional[tuple]] = []
        finished = False
        try:
            for i in range(len(spans)):
                while len(tasks) < min(len(spans), i + depth):
                    tasks.append(workers.send(len(tasks) % count, spans[len(tasks)]))
                task, tasks[i] = tasks[i], None
                yield workers.receive(i % count, *task)
            finished = True
        finally:
            if not finished:  # closed early or raised: batches are still in flight
                self.close()

    def close(self) -> None:
        """End and reap the worker processes (a later iteration forks new ones)."""
        if self._reap is not None:
            self._reap()
        self._workers = self._reap = None


def _collate(samples, settings, empty=None) -> Batch:
    batch_size, pad_last_batch, pad_to, pad_values = settings
    batch_pad_to = batch_size if (pad_last_batch and len(samples) < batch_size) else None
    return collate(samples, pad_to=pad_to, pad_values=pad_values,
                   batch_pad_to=batch_pad_to, empty=empty)


class _Placed(NamedTuple):
    """A field that a worker laid out in shared memory: a ring slot or the
    batch's own memfd."""

    offset: int
    dtype: str
    shape: tuple


def _shared(fd: int, size: int, offset: int = 0) -> mmap.mmap:
    """`size` bytes of the memfd `fd` at `offset`, mapped with every page
    table entry filled at once (on a host where each first touch of a shared
    page is a costly fault, one populated map costs a fraction of them), and
    left out of later forks."""
    memory = mmap.mmap(fd, size, flags=mmap.MAP_SHARED | _POPULATE, offset=offset)
    memory.madvise(mmap.MADV_DONTFORK)
    return memory


def _wrap(memory, fields: list) -> tuple:
    """`fields` with each :class:`_Placed` replaced by a view of `memory`,
    and the array that every such view keeps alive."""
    root = np.frombuffer(memory, np.uint8)
    out = []
    for key, value in fields:
        if isinstance(value, _Placed):
            dtype = np.dtype(value.dtype)
            size = int(np.prod(value.shape)) * dtype.itemsize
            value = root[value.offset : value.offset + size].view(dtype).reshape(value.shape)
        out.append((key, value))
    return root, out


class _Ring:
    """Slots of shared memory, one batch's large fields in each.

    A memfd (no /dev/shm, whose size containers often cap) whose descriptor
    each worker receives over its socket; each side maps a slot, populated,
    the first time it uses it, and keeps the map.  A slot goes back to the
    free list only when the last array viewing it is freed.  ``put_batch``'s
    ``.to(device, non_blocking=True)`` from this pageable memory returns only
    once the bytes are staged, so freeing the arrays right after it is safe;
    pinning the ring would need an event recorded after the copy before a slot
    is released."""

    def __init__(self, slots: int, slot_bytes: int, fd: Optional[int] = None):
        """A new ring, or (in a worker) the one whose descriptor is `fd`."""
        self.slots, self.slot_bytes = slots, slot_bytes
        if fd is None:
            fd = os.memfd_create("openvivqa-loader-ring", os.MFD_CLOEXEC)
            try:
                os.ftruncate(fd, slots * slot_bytes)
            except OSError:
                os.close(fd)
                raise
        self.fd = fd
        weakref.finalize(self, os.close, fd)
        self._maps: List[Optional[mmap.mmap]] = [None] * slots
        self._free = list(range(slots - 1, -1, -1))
        self._lock = threading.Lock()

    def take(self) -> Optional[int]:
        with self._lock:
            return self._free.pop() if self._free else None

    def release(self, slot: int) -> None:
        with self._lock:
            self._free.append(slot)

    def memory(self, slot: int) -> mmap.mmap:
        if self._maps[slot] is None:
            self._maps[slot] = _shared(self.fd, self.slot_bytes, slot * self.slot_bytes)
        return self._maps[slot]

    def wrap(self, slot: int, fields: list) -> list:
        """`fields` in place in `slot`, which returns to the free list once
        no view of it is left."""
        root, out = _wrap(self.memory(slot), fields)
        weakref.finalize(root, self.release, slot).atexit = False
        return out


class _Layout:
    """``collate``'s `empty` inside a worker: a numeric field of at least
    RING_MIN_BYTES goes to `memory` (a ring slot) while it fits, else to this
    process's memory (`overflow`); `wanted` counts the bytes all such fields
    (`large`) take."""

    def __init__(self, memory: Optional[mmap.mmap]):
        self.memory = memory
        self.placed, self.large = {}, []
        self.used = self.wanted = 0
        self.overflow = False

    def __call__(self, key, shape, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        size = int(np.prod(shape)) * dtype.itemsize
        if size < RING_MIN_BYTES:
            return np.empty(shape, dtype)
        padded = -(-size // _ALIGN) * _ALIGN
        self.wanted += padded
        self.large.append(key)
        if self.memory is None or self.used + padded > len(self.memory):
            self.overflow = True
            return np.empty(shape, dtype)
        self.placed[key] = _Placed(self.used, dtype.str, tuple(shape))
        out = np.ndarray(shape, dtype, buffer=self.memory, offset=self.used)
        self.used += padded
        return out


def _spill(batch: Batch, layout: _Layout) -> Tuple[int, dict]:
    """The batch's large fields copied into a memfd of their own (no ring
    slot held them all): its descriptor and their places."""
    fd = os.memfd_create("openvivqa-loader-batch", os.MFD_CLOEXEC)
    try:
        os.ftruncate(fd, layout.wanted)
        memory = _shared(fd, layout.wanted)
        placed, offset = {}, 0
        for key in layout.large:
            value = batch[key]
            np.ndarray(value.shape, value.dtype, buffer=memory, offset=offset)[...] = value
            placed[key] = _Placed(offset, value.dtype.str, value.shape)
            offset += -(-value.nbytes // _ALIGN) * _ALIGN
        memory.close()
    except OSError:
        os.close(fd)
        raise
    return fd, placed


def _work(conn, other_end, dataset, settings) -> None:
    """A worker process's loop: make each batch asked for, lay its large
    fields out in the ring slot the task names (else in a memfd of the
    batch's own, whose descriptor follows the reply), and send back the rest
    with the times of its ``data.batch``, ``data.load`` and ``data.collate``
    spans.

    It touches no CUDA, no torch thread pool and not ``utils.tracing`` (whose
    lock another thread of the parent may have held at the fork): it reads
    ``time.perf_counter_ns()`` (CLOCK_MONOTONIC, shared with the parent)
    itself.  It ends at the end of its pipe, when its parent is gone, or at
    the parent's SIGTERM."""
    other_end.close()
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # the parent reaps it
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    parent, ring = os.getppid(), None
    while True:
        while not conn.poll(1.0):
            if os.getppid() != parent:
                return
        try:
            message = conn.recv()
        except EOFError:
            return
        if message[0] == "ring":
            ring = _Ring(message[1], message[2], reduction.recv_handle(conn))
            continue
        _, indices, slot = message
        try:
            started = time.perf_counter_ns()
            samples = [dataset.__getitem__(i) for i in indices]
            loaded = time.perf_counter_ns()
            layout = _Layout(ring.memory(slot) if slot is not None else None)
            batch = _collate(samples, settings, layout)
            collated = time.perf_counter_ns()
            where, fd = ("ring" if layout.placed else None), None
            if layout.overflow:
                fd, layout.placed = _spill(batch, layout)
                where = "spill"
            fields = [(key, layout.placed.get(key, value)) for key, value in batch.items()]
            del batch  # the slot's views
            conn.send(("batch", os.getpid(), fields, where, layout.wanted,
                       (started, loaded, collated)))
            if fd is not None:
                reduction.send_handle(conn, fd, None)
                os.close(fd)
        except Exception as exc:
            text = traceback.format_exc()
            try:
                conn.send(("error", exc, text))
            except Exception:  # the exception does not pickle
                conn.send(("error", RuntimeError(repr(exc)), text))


class _Worker:
    """One worker process, forked with ``os.fork`` (spawn would re-import
    torch; a multiprocessing child may not start children of its own when it
    is daemonic, as spawned ranks often are), and its end of a duplex pipe."""

    def __init__(self, dataset, settings):
        self.conn, theirs = multiprocessing.Pipe()
        self.pid = os.fork()
        if self.pid == 0:  # the child never returns into its parent's code
            code = 1
            try:
                _work(theirs, self.conn, dataset, settings)
                code = 0
            except BaseException:
                traceback.print_exc()
            finally:
                os._exit(code)
        theirs.close()
        self.exitcode: Optional[int] = None

    def exited(self) -> bool:
        if self.exitcode is None:
            try:
                pid, status = os.waitpid(self.pid, os.WNOHANG)
            except ChildProcessError:  # reaped by someone else: the code is lost
                self.exitcode = -1
            else:
                if pid:
                    self.exitcode = os.waitstatus_to_exitcode(status)
        return self.exitcode is not None

    def send(self, message, fd: Optional[int] = None) -> None:
        """`message` down the pipe, then `fd` (SCM_RIGHTS) if given."""
        try:
            self.conn.send(message)
            if fd is not None:
                reduction.send_handle(self.conn, fd, None)
        except OSError:  # the pipe broke: the worker is gone
            self._died()

    def receive(self):
        """The worker's next message; its death raises."""
        while not self.conn.poll(1.0):
            if self.exited():
                self._died()
        try:
            return self.conn.recv()
        except (EOFError, OSError):
            self._died()

    def receive_fd(self) -> int:
        """A descriptor the worker sent after its message (SCM_RIGHTS)."""
        try:
            return reduction.recv_handle(self.conn)
        except (EOFError, OSError, RuntimeError):
            self._died()

    def _died(self):
        self.terminate()
        self.reap()
        raise RuntimeError(f"loader worker {self.pid} exited unexpectedly "
                           f"(exit code {self.exitcode})")

    def terminate(self) -> None:
        if not self.exited():
            with contextlib.suppress(ProcessLookupError):
                os.kill(self.pid, signal.SIGTERM)

    def reap(self) -> None:
        deadline = time.monotonic() + 5
        while not self.exited():
            if time.monotonic() > deadline:
                with contextlib.suppress(ProcessLookupError):
                    os.kill(self.pid, signal.SIGKILL)
                deadline = float("inf")
            time.sleep(0.001)
        self.conn.close()


class _Workers:
    """A loader's worker processes and the ring their batches' large fields
    cross once the first batch has sized it (a batch that finds the ring
    unsized, full or too small comes in a memfd of its own)."""

    def __init__(self, count: int, depth: int, dataset, settings):
        self.workers: List[_Worker] = []
        self.ring: Optional[_Ring] = None
        self.slots = depth + HELD_SLOTS
        try:
            for _ in range(count):
                self.workers.append(_Worker(dataset, settings))
        except BaseException:
            self.close()
            raise

    def send(self, index: int, indices) -> tuple:
        """Ask worker `index` for a batch of `indices`; returns the task
        (batch id, ring, slot) that :meth:`receive` takes."""
        ring = self.ring
        slot = ring.take() if ring is not None else None
        self.workers[index].send(("batch", indices, slot))
        return tracing.next_batch_id(), ring, slot

    def receive(self, index: int, batch_id: int, ring: Optional[_Ring],
                slot: Optional[int]) -> Batch:
        """Worker `index`'s next batch (its oldest task), its spans recorded
        and its large fields wrapped in place; a worker's exception is raised
        here, and so is its death."""
        message = self.workers[index].receive()
        if message[0] == "error":
            if slot is not None:
                ring.release(slot)
            _, exc, text = message
            exc.add_note(f"raised in loader worker {self.workers[index].pid}:\n{text}")
            raise exc
        _, pid, fields, where, wanted, (started, loaded, collated) = message
        if where == "spill":
            fd = self.workers[index].receive_fd()
            try:
                _, fields = _wrap(_shared(fd, wanted), fields)
            finally:
                os.close(fd)
        if where == "ring":
            fields = ring.wrap(slot, fields)
        elif slot is not None:
            ring.release(slot)
        tracing.record_finished(pid, batch_id, [("data.batch", started, collated, None),
                                                ("data.load", started, loaded, 0),
                                                ("data.collate", loaded, collated, 0)])
        tracing.count("data.worker_batches")
        tracing.count(f"data.{where or 'pipe'}_batches")
        if wanted > (self.ring.slot_bytes if self.ring is not None else 0):
            self._grow(wanted)
        batch = Batch(fields)
        batch.batch_id = batch_id
        return batch

    def _grow(self, wanted: int) -> None:
        """A new ring whose slots hold `wanted` bytes and an eighth more;
        the old one lives on while arrays view it.  Tasks already sent keep
        their slots: each worker maps the new ring after them."""
        slot_bytes = -(-(wanted + wanted // 8) // mmap.PAGESIZE) * mmap.PAGESIZE
        ring = _Ring(self.slots, slot_bytes)
        for worker in self.workers:
            worker.send(("ring", self.slots, slot_bytes), ring.fd)
        self.ring = ring

    def close(self) -> None:
        for worker in self.workers:
            worker.terminate()
        for worker in self.workers:
            worker.reap()
        self.workers = []
