"""The loader's worker processes (``openvivqa_tpu_torch/data/loader.py``):
batches equal at every worker count, the shared-memory ring and its pipe
fallback, a worker's exception and death surfacing in the consumer, an early
close reaping the workers, and the spans the workers carry back.  Each test
runs under its own deadline, so that a hang fails fast.
"""

import contextlib
import os
import queue
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

from openvivqa_tpu_torch.config import ConfigNode
from openvivqa_tpu_torch.data import loader as loader_module
from openvivqa_tpu_torch.data.loader import DataLoader
from openvivqa_tpu_torch.training.tasks.base_task import BaseTask
from openvivqa_tpu_torch.utils import tracing
from openvivqa_tpu_torch.utils.instance import Instance

ROWS = 64 * 1024  # floats a sample: 4 samples fill a 1 MiB field, over RING_MIN_BYTES


@contextlib.contextmanager
def deadline(seconds: float):
    def expire(signum, frame):
        raise TimeoutError(f"no result within {seconds} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


class Samples:
    """Sample i: a large float field of i, a token field of i % 5 + 1 ids
    (padded to the batch's longest), a string and a scalar."""

    def __init__(self, n=22, fail_at=None, pause=0.0):
        self.n, self.fail_at, self.pause = n, fail_at, pause

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f"sample {i} is unreadable")
        time.sleep(self.pause)
        return Instance(features=np.full((ROWS,), i, np.float32),
                        tokens=np.arange(1, i % 5 + 2, dtype=np.int64),
                        question=f"question {i}", question_id=int(i))


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _pids(loader):
    return [worker.pid for worker in loader._workers.workers]


def _assert_same(got, want):
    assert len(got) == len(want)
    for batch, expected in zip(got, want):
        assert list(batch) == list(expected)
        for key, value in expected.items():
            if isinstance(value, np.ndarray):
                assert batch[key].dtype == value.dtype, key
                np.testing.assert_array_equal(batch[key], value, err_msg=key)
            else:
                assert batch[key] == value, key


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("shards", [None, (2, 0), (2, 1)])
def test_batches_are_equal_at_0_1_and_2_workers(shuffle, shards):
    """The same batches in the same order, the padded last one and its
    sample_valid included, with the shard split worked out in the parent and
    batch ids in batch order."""
    num_shards, shard_id = shards or (None, None)
    with deadline(60):
        runs = {workers: list(DataLoader(Samples(), batch_size=4, shuffle=shuffle, seed=5,
                                         num_workers=workers, num_shards=num_shards,
                                         shard_id=shard_id))
                for workers in (0, 1, 2)}
    for workers in (1, 2):
        _assert_same(runs[workers], runs[0])
    last = runs[0][-1] if shards is None else None
    if last is not None:  # 22 samples: the sixth batch holds 2 and 2 padding rows
        assert last["sample_valid"].tolist() == [True, True, False, False]
        np.testing.assert_array_equal(last["features"][3], last["features"][1])
    for batches in runs.values():
        ids = [batch.batch_id for batch in batches]
        assert ids == sorted(ids) and len(set(ids)) == len(ids)


def test_more_batches_than_ring_slots_stay_intact(monkeypatch):
    """list(loader) holds every batch: the ring's slots run out and later
    batches come in memfds of their own (as do the first ones, made before
    the ring was sized), all of them intact; a consumer that lets its batches
    go gets each slot back, so every batch after the first ones comes through
    the ring.  Fields under RING_MIN_BYTES cross the pipe."""
    monkeypatch.setattr(loader_module, "HELD_SLOTS", 2)  # + 2 in flight: 4 slots
    dataset = Samples(n=48)
    before = tracing.counters("data.")
    with deadline(60):
        held = list(DataLoader(dataset, batch_size=4, num_workers=1, prefetch=2))
    moved = {k: v - before.get(k, 0) for k, v in tracing.counters("data.").items()}
    assert moved["data.worker_batches"] == 12
    assert moved["data.ring_batches"] == 4 and moved["data.spill_batches"] == 8
    assert moved.get("data.pipe_batches", 0) == 0
    for n, batch in enumerate(held):
        np.testing.assert_array_equal(batch["features"][:, 0], np.arange(4 * n, 4 * n + 4))
        assert (batch["features"] == batch["features"][:, :1]).all()
        assert batch["features"].flags.writeable

    before = tracing.counters("data.")
    with deadline(60):
        for n, batch in enumerate(DataLoader(dataset, batch_size=4, num_workers=1)):
            np.testing.assert_array_equal(batch["features"][:, -1], np.arange(4 * n, 4 * n + 4))
    moved = {k: v - before.get(k, 0) for k, v in tracing.counters("data.").items()}
    assert moved["data.ring_batches"] == 10 and moved["data.spill_batches"] == 2
    with deadline(60):
        small = list(DataLoader([Instance(x=np.full((3,), i, np.float32)) for i in range(8)],
                                batch_size=4, num_workers=1))
    assert [batch["x"][:, 0].tolist() for batch in small] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert tracing.counters("data.")["data.pipe_batches"] - before.get("data.pipe_batches",
                                                                      0) == 2


def test_more_workers_than_cores_and_a_releasing_thread_keep_every_batch_intact(monkeypatch):
    """More workers than cores over few slots, a shortened switch interval,
    and each batch checked and freed on another thread (its slot goes back to
    the free list there) while the consumer takes the next: no batch ever sees
    its slot rewritten, over two epochs."""
    monkeypatch.setattr(loader_module, "HELD_SLOTS", 3)
    workers = (os.cpu_count() or 2) + 2
    handoff, errors = queue.Queue(), []

    def check_and_free():
        while (batch := handoff.get()) is not None:
            time.sleep(0.001)
            ids = np.asarray(batch["question_id"], np.float32)
            if not (batch["features"] == ids[:, None]).all():
                errors.append(batch.batch_id)
            del batch

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    thread = threading.Thread(target=check_and_free)
    thread.start()
    before = tracing.counters("data.")
    try:
        with deadline(120):
            loader = DataLoader(Samples(n=120), batch_size=4, shuffle=True, num_workers=workers)
            for _ in range(2):
                for batch in loader:
                    handoff.put(batch)
                del batch
    finally:
        handoff.put(None)
        thread.join(timeout=60)
        sys.setswitchinterval(interval)
    assert not thread.is_alive() and errors == []
    moved = {k: v - before.get(k, 0) for k, v in tracing.counters("data.").items()}
    assert moved["data.worker_batches"] == 60 and moved.get("data.ring_batches", 0) >= 10


def test_a_workers_exception_is_raised_in_the_consumer():
    loader = DataLoader(Samples(fail_at=9), batch_size=4, num_workers=2)
    with deadline(60), pytest.raises(ValueError, match="sample 9 is unreadable") as raised:
        list(loader)
    assert any("raised in loader worker" in note for note in raised.value.__notes__)
    assert loader._workers is None  # the failed iteration reaped its workers


def test_a_killed_worker_makes_the_consumer_raise():
    loader = DataLoader(Samples(n=40, pause=0.01), batch_size=4, num_workers=1)
    with deadline(60):
        iterator = iter(loader)
        next(iterator)
        (pid,) = _pids(loader)
        os.kill(pid, signal.SIGKILL)
        with pytest.raises(RuntimeError, match="exited unexpectedly"):
            for _ in iterator:
                pass
    assert not _alive(pid)


def test_an_early_close_leaves_no_child_process():
    """Closing the iterator mid-epoch (the benchmark's Feed.close) ends and
    reaps the workers; the next iteration forks new ones; the loader's
    collection reaps those."""
    loader = DataLoader(Samples(n=40, pause=0.01), batch_size=4, num_workers=2)
    with deadline(60):
        iterator = iter(loader)
        next(iterator)
        pids = _pids(loader)
        iterator.close()
        assert not any(_alive(pid) for pid in pids)
        assert len(list(loader)) == 10
        again = _pids(loader)
        assert not set(again) & set(pids) and all(_alive(pid) for pid in again)
        del loader, iterator
        assert not any(_alive(pid) for pid in again)


def test_worker_spans_reach_the_store_under_the_consuming_steps_batch_id():
    """A worker's data.batch, with its data.load and data.collate inside,
    lands in the store as its batch arrives: the worker's pid as thread, the
    batch's id, on the consumer's clock."""
    class Stub:
        config = ConfigNode({"TRAINING": {}})
        device = torch.device("cpu")
        put_batch = BaseTask.put_batch
        device_batches = BaseTask.device_batches

    loader = DataLoader(Samples(n=10), batch_size=4, num_workers=2)
    consumed = []
    with deadline(60), tracing.recording():
        started = time.perf_counter_ns()
        for host, _ in Stub().device_batches(loader):
            with tracing.span("train.step"):
                consumed.append(host.batch_id)
        pids = set(_pids(loader))
    snap = tracing.snapshot()
    made = [s for s in snap["spans"] if s.name == "data.batch"]
    assert [s.batch for s in made] == consumed and len(consumed) == 3
    assert {s.thread for s in made} <= pids and threading.get_native_id() not in pids
    for s in made:
        assert started < s.start_ns <= s.end_ns < time.perf_counter_ns()
    for name in ("data.load", "data.collate"):
        inside = [s for s in snap["spans"] if s.name == name]
        assert len(inside) == 3
        for s in inside:
            parent = snap["spans"][s.parent]
            assert parent.name == "data.batch" and (parent.batch, parent.thread) == (s.batch,
                                                                                  s.thread)
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert snap["names"]["data.batch"]["count"] == 3
    assert snap["counters"]["data.worker_batches"] == 3


class _ParentOnlyLock:
    """utils.tracing's lock, which raises in any process but this one."""

    def __init__(self, lock):
        self.lock, self.pid = lock, os.getpid()

    def __enter__(self):
        if os.getpid() != self.pid:
            raise AssertionError("a loader worker took utils.tracing's lock")
        return self.lock.__enter__()

    def __exit__(self, *exc):
        return self.lock.__exit__(*exc)


def test_workers_touch_no_cuda_no_thread_pool_and_not_the_tracing_lock(monkeypatch):
    """With torch.cuda and torch's thread-pool calls made to raise and the
    store's lock raising outside this process, two workers still make every
    batch, equal to the in-process ones."""
    def refuse(*args, **kwargs):
        raise AssertionError("a loader worker called into CUDA or torch's thread pools")

    for name in ("is_available", "init", "_lazy_init", "current_device", "device_count",
                 "synchronize", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for name in ("set_num_threads", "get_num_threads", "set_num_interop_threads"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(tracing, "_lock", _ParentOnlyLock(tracing._lock))
    with deadline(60), tracing.recording():
        got = list(DataLoader(Samples(), batch_size=4, shuffle=True, num_workers=2))
    monkeypatch.undo()
    with deadline(60):
        want = list(DataLoader(Samples(), batch_size=4, shuffle=True, num_workers=0))
    _assert_same(got, want)
