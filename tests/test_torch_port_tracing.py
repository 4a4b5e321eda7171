"""The port's spans and counters (``openvivqa_tpu_torch/utils/tracing.py``):
the store on its own (nesting, self time, sessions, the off path, the cap,
threads and batch ids), the launch counters of ``ops/_cuda.py`` read through
it, and the spans a small MMF_M4C task records at each layer boundary of a
train step and a greedy eval batch on the CPU.
"""

import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openvivqa_tpu_torch.config import ConfigNode
from openvivqa_tpu_torch.data.loader import DataLoader
from openvivqa_tpu_torch.ops import _cuda
from openvivqa_tpu_torch.training.profiling import maybe_trace
from openvivqa_tpu_torch.training.tasks.base_task import BaseTask
from openvivqa_tpu_torch.utils import tracing
from openvivqa_tpu_torch.utils.instance import Instance
from test_torch_port_multihost import build, mmf_m4c_config

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _by_name(snapshot):
    out = {}
    for s in snapshot["spans"]:
        out.setdefault(s.name, []).append(s)
    return out


# -- the store ------------------------------------------------------------------------------------
def test_nested_spans_keep_their_parent_and_self_time():
    """A parent's self time is its duration less its children's; each span
    points at the span open around it on its thread, and takes its batch."""
    with tracing.recording():
        with tracing.span("train.step", batch=7):
            with tracing.span("train.forward"):
                time.sleep(0.02)
            with tracing.span("train.backward"):
                time.sleep(0.01)
        with tracing.span("eval.batch"):
            pass
    snap = tracing.snapshot()
    step, forward, backward, other = snap["spans"]
    assert [s.name for s in snap["spans"]] == ["train.step", "train.forward",
                                               "train.backward", "eval.batch"]
    assert (step.parent, forward.parent, backward.parent, other.parent) == (None, 0, 0, None)
    assert (forward.batch, backward.batch) == (7, 7)
    assert step.start_ns <= forward.start_ns < forward.end_ns <= backward.start_ns
    assert backward.end_ns <= step.end_ns
    names = snap["names"]
    children = (forward.end_ns - forward.start_ns) + (backward.end_ns - backward.start_ns)
    assert names["train.step"]["self_ms"] == pytest.approx(
        (step.end_ns - step.start_ns - children) / 1e6)
    assert names["train.forward"]["self_ms"] == names["train.forward"]["total_ms"] >= 20.0
    assert names["train.step"]["count"] == 1
    assert names["train.step"]["max_ms"] == names["train.step"]["total_ms"]
    assert {s.thread for s in snap["spans"]} == {threading.get_native_id()}


def test_the_off_path_records_nothing_and_reads_no_clock(monkeypatch):
    """With no profiler and outside recording(), a span neither reads the
    clock nor enters record_function, and every call returns one shared
    object; counters count all the same."""
    entered, clock = [], []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    real_clock = time.perf_counter_ns
    monkeypatch.setattr(tracing.time, "perf_counter_ns",
                        lambda: clock.append(1) or real_clock())
    with tracing.span("train.step"):
        pass  # closes any session left live by an earlier test
    before = tracing.session_number()
    spans = [tracing.span(name) for name in ("train.step", "decode.step", "data.batch")]
    for item in spans:
        with item as handle:
            handle.batch = 3  # ignored
    assert spans[0] is spans[1] is spans[2]
    assert (entered, clock) == ([], [])
    assert tracing.session_number() == before
    counted = tracing.counters("data.rows").get("data.rows", 0)
    tracing.count("data.rows", 5)
    assert tracing.counters("data.rows")["data.rows"] == counted + 5


def test_recording_and_a_running_profiler_each_open_a_session():
    """recording() opens a session at its entry; under a profiler the first
    span opens one, and a span that finds recording off ends it, so the next
    profiler's spans go to a new session.  Counters report their change over
    the session."""
    with tracing.recording():
        first = tracing.session_number()
        tracing.count("data.batches", 2)
    assert tracing.snapshot()["session"] == first
    assert tracing.snapshot()["counters"]["data.batches"] == 2
    tracing.count("data.batches", 5)  # after the session's end
    assert tracing.snapshot()["counters"]["data.batches"] == 2

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("eval.batch"):
            tracing.count("data.batches")
        second = tracing.session_number()
    with tracing.span("eval.batch"):  # off: ends the session
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("eval.decode"):
            pass
    third = tracing.snapshot()
    assert first < second < third["session"]
    assert [s.name for s in third["spans"]] == ["eval.decode"]
    assert "eval.batch" in {e.name for e in prof.events()}  # on the profiler's trace


def test_loader_thread_spans_carry_the_batch_id_of_the_step_that_consumes_it():
    """data.batch (with data.load and data.collate inside it) runs on the
    loader's thread; data.wait and data.put_batch and the consumer's spans on
    the caller's; all of one batch's spans share its id."""
    class Stub:
        config = ConfigNode({"TRAINING": {}})
        device = torch.device("cpu")
        put_batch = BaseTask.put_batch
        device_batches = BaseTask.device_batches

    dataset = [Instance(x=np.full((3,), i, np.float32)) for i in range(10)]
    loader = DataLoader(dataset, batch_size=4, num_workers=2)
    consumed = []
    with tracing.recording():
        for host, device_batch in Stub().device_batches(loader):
            with tracing.span("train.step"):
                consumed.append((host.batch_id, int(device_batch["x"][0, 0])))
    spans = _by_name(tracing.snapshot())
    ids = [batch_id for batch_id, _ in consumed]
    assert len(set(ids)) == 3 and [first for _, first in consumed] == [0, 4, 8]
    assert [s.batch for s in spans["train.step"]] == ids
    assert [s.batch for s in spans["data.put_batch"]] == ids
    assert [s.batch for s in spans["data.wait"]] == ids + [None, None]
    assert sorted(s.batch for s in spans["data.batch"]) == ids
    main = threading.get_native_id()
    loader_threads = {s.thread for name in ("data.batch", "data.load", "data.collate")
                      for s in spans[name]}
    assert main not in loader_threads
    assert {s.thread for s in spans["train.step"] + spans["data.wait"]} == {main}
    snap = tracing.snapshot()
    for name in ("data.load", "data.collate"):
        for s in spans[name]:
            parent = snap["spans"][s.parent]
            assert parent.name == "data.batch" and parent.batch == s.batch
    assert snap["counters"]["data.batches"] == 3
    assert snap["counters"]["data.rows"] == 12 and snap["counters"]["data.rows_valid"] == 10
    assert snap["counters"]["data.h2d_bytes"] == 3 * (4 * 3 * 4 + 4)  # x, sample_valid


def test_threads_share_the_store_without_losing_a_count_or_a_span():
    """More threads than cores count and open nested spans at a shortened
    switch interval: no count is lost, every span is kept, and each child's
    parent is a span of its own thread."""
    workers, rounds = (os.cpu_count() or 2) + 2, 300
    errors = []

    def work():
        try:
            for _ in range(rounds):
                tracing.count("data.rows")
                with tracing.span("data.batch"):
                    with tracing.span("data.collate"):
                        tracing.count("data.rows")
        except BaseException as error:  # reported below
            errors.append(error)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording():
            threads = [threading.Thread(target=work) for _ in range(workers)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=120)
            assert not any(thread.is_alive() for thread in threads)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    snap = tracing.snapshot()
    assert snap["counters"]["data.rows"] == 2 * workers * rounds
    spans = snap["spans"]
    assert len(spans) == 2 * workers * rounds
    for s in spans:
        if s.name == "data.collate":
            parent = spans[s.parent]
            assert parent.name == "data.batch" and parent.thread == s.thread
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert snap["names"]["data.batch"]["count"] == workers * rounds


def test_spans_past_the_cap_are_counted_as_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    with tracing.recording():
        for _ in range(5):
            with tracing.span("decode.step"):
                with tracing.span("train.step"):
                    pass
    snap = tracing.snapshot()
    assert len(snap["spans"]) == 3
    assert snap["counters"]["tracing.dropped"] == 7
    assert snap["names"]["decode.step"]["count"] == 2


def test_launch_counters_live_in_the_store():
    """ops/_cuda.py's count, launch_counts, launch_counts_by_rows and
    reset_launch_counts read the store's kernel.* counters; a reset starts
    the views again from 0 and leaves the store's counters as they are."""
    _cuda.reset_launch_counts()
    assert set(_cuda.launch_counts()) == set(_cuda.WRAPPERS)
    assert not any(_cuda.launch_counts().values())
    assert _cuda.launch_counts_by_rows() == {name: {} for name in _cuda.BY_ROWS}
    stored = tracing.counters("kernel.fused_ffn_step").get("kernel.fused_ffn_step", 0)
    _cuda.count("fused_ffn_step", 640)
    _cuda.count("fused_ffn_step", 64)
    _cuda.count("fused_ffn_step", 640)
    _cuda.count("fused_attention_packed")
    counts = _cuda.launch_counts()
    assert counts["fused_ffn_step"] == 3 and counts["fused_attention_packed"] == 1
    assert sum(counts.values()) == 4
    by_rows = _cuda.launch_counts_by_rows()
    assert by_rows["fused_ffn_step"] == {64: 1, 640: 2}
    assert list(by_rows["fused_ffn_step"]) == [64, 640]
    assert by_rows["fused_encoder_self_attention"] == {}
    assert tracing.counters("kernel.fused_ffn_step")["kernel.fused_ffn_step"] == stored + 3
    _cuda.reset_launch_counts()
    assert not any(_cuda.launch_counts().values())
    assert tracing.counters("kernel.fused_ffn_step")["kernel.fused_ffn_step"] == stored + 3


def test_no_session_before_the_first_span():
    code = ("from openvivqa_tpu_torch.utils import tracing\n"
            "assert tracing.snapshot() is None and tracing.session_number() == 0\n"
            "with tracing.span('train.step'):\n    pass\n"
            "assert tracing.snapshot() is None\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr


# -- the names ------------------------------------------------------------------------------------
def _port_span_names():
    names = set()
    for path in (ROOT / "openvivqa_tpu_torch").rglob("*.py"):
        names |= set(re.findall(r"tracing\.span\(\"([^\"]+)\"", path.read_text()))
    return names


def test_every_span_of_the_port_is_named_and_none_takes_a_benchmark_name():
    """Every span the port opens is in tracing.NAMES, and NAMES is exactly
    them; none takes a name the benchmark's trace reduction reads itself (its
    host ranges, its window, entry: and Optimizer.)."""
    path = ROOT / "benchmark" / "portbench" / "trace.py"
    spec = importlib.util.spec_from_file_location("portbench_trace_names", path)
    trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace)
    used = _port_span_names()
    assert used == set(tracing.NAMES)
    for name in used:
        assert name not in trace.LABELS and name != trace.Slice.WINDOW
        assert not name.startswith(("entry:", "Optimizer."))


def test_the_profilers_chrome_trace_holds_the_loader_threads_spans(tmp_path):
    """maybe_trace records every thread: the loader's data.batch spans reach
    the Chrome trace, on another thread than the consumer's data.wait."""
    dataset = [Instance(x=np.zeros((2,), np.float32)) for _ in range(6)]
    with maybe_trace(str(tmp_path)):
        for batch in DataLoader(dataset, batch_size=2, num_workers=1):
            with tracing.span("data.wait"):
                torch.from_numpy(batch["x"]).sum()
    (path,) = tmp_path.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    threads = {name: {e["tid"] for e in events if e.get("name") == name}
               for name in ("data.batch", "data.collate", "data.wait")}
    assert threads["data.batch"] and threads["data.collate"] and threads["data.wait"]
    assert not threads["data.batch"] & threads["data.wait"]


# -- a task's spans -------------------------------------------------------------------------------
@pytest.fixture
def mmf_task(synthetic_data, tmp_path):
    return build(mmf_m4c_config(synthetic_data, tmp_path / "ckpt"))


def test_an_mmf_m4c_train_step_and_greedy_eval_record_every_span(mmf_task):
    """Under recording(): one train step gives one train.step with its
    forward, backward and optimizer inside; one greedy eval batch one
    eval.batch with its decode, to_host and strings, the decode one
    decode.encode and max_iter decode.steps; the loader's and the device
    copy's spans, all carrying the batch ids they worked on."""
    task = mmf_task
    train = task.device_batches(task.train_dataloader)
    dev = task.device_batches(task.dev_dict_dataloader)
    with tracing.recording():
        train_host, train_batch = next(train)
        task._train_step(train_batch)
        dev_host, dev_batch = next(dev)
        with task.eval_weights():
            answers = task.generate_answers(dev_host, dev_batch)
    train.close()
    dev.close()
    assert len(answers) == dev_host.batch_size
    snap = tracing.snapshot()
    spans = _by_name(snap)
    assert set(spans) == set(tracing.NAMES)
    counts = {name: len(items) for name, items in spans.items()}
    for name in ("train.step", "train.forward", "train.backward", "train.optimizer",
                 "eval.batch", "eval.decode", "eval.to_host", "eval.strings", "decode.encode"):
        assert counts[name] == 1, name
    assert counts["decode.step"] == task.model.max_iter
    # the loaders fill two ahead: both train batches and the one dev batch
    # are put; each loader's third wait finds its split at its end
    assert counts["data.put_batch"] == 3 and counts["data.wait"] == 6
    assert counts["data.batch"] == counts["data.load"] == counts["data.collate"] >= 2

    def parent(s):
        return snap["spans"][s.parent].name

    assert {parent(s) for name in ("train.forward", "train.backward", "train.optimizer")
            for s in spans[name]} == {"train.step"}
    assert {parent(s) for name in ("eval.decode", "eval.to_host", "eval.strings")
            for s in spans[name]} == {"eval.batch"}
    assert {parent(s) for s in spans["decode.step"] + spans["decode.encode"]} == {"eval.decode"}
    assert spans["train.step"][0].batch == spans["train.forward"][0].batch == train_host.batch_id
    assert {s.batch for s in spans["eval.batch"] + spans["decode.step"]} == {dev_host.batch_id}
    made = {s.batch for s in spans["data.batch"]}
    assert {train_host.batch_id, dev_host.batch_id} <= made
    assert snap["counters"]["data.batches"] == 3


def test_the_train_record_counts_the_valid_rows_only(mmf_task):
    """samples_per_sec of the epoch's record is over the split's valid rows:
    11 train samples in batches of 8, so the last batch holds 5 padding rows
    that do not count."""
    task = mmf_task
    n = len(task.train_dataset)
    assert n % task.train_dataloader.batch_size
    task.train()
    with open(os.path.join(task.checkpoint_path, "metrics.jsonl")) as handle:
        (record,) = [json.loads(line) for line in handle]
    assert record["iterations"] * task.train_dataloader.batch_size > n
    assert record["samples_per_sec"] == round(n / record["seconds"], 2)
    assert "spans" not in record


# -- the benchmark's readers of the spans -----------------------------------------------------
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_READERS = ("forward_host_ms", "backward_host_ms", "optimizer_host_ms", "put_batch_ms",
                "loader_queue_ms", "collate_ms", "h2d_mb", "decode_host_ms", "to_host_wait_ms")
SPAN_METRICS = {m["name"]: m for m in BENCHMARK["per_layer"]
                if m["name"].split(".")[0] in SPAN_READERS}


def _aggregate(count, total):
    return {"count": count, "total_ms": total, "self_ms": total, "max_ms": total / count}


# a hand-made session: 4 train steps and 5 eval batches, 6 batches made by the
# loader's thread, 8 put on the device with 376 MB in all
HAND_MADE = {
    "session": 1, "spans": [],
    "names": {"train.step": _aggregate(4, 800.0), "train.forward": _aggregate(4, 200.0),
              "train.backward": _aggregate(4, 320.0), "train.optimizer": _aggregate(4, 160.0),
              "eval.batch": _aggregate(5, 1500.0), "eval.decode": _aggregate(5, 600.0),
              "eval.to_host": _aggregate(5, 450.0), "data.put_batch": _aggregate(8, 40.0),
              "data.wait": _aggregate(10, 120.0), "data.batch": _aggregate(6, 300.0)},
    "counters": {"data.batches": 8, "data.h2d_bytes": 376_000_000},
}
EXPECTED = {
    "forward_host_ms.train": 50.0, "backward_host_ms.train": 80.0,
    "optimizer_host_ms.train": 40.0, "put_batch_ms.train": 10.0, "put_batch_ms.eval": 8.0,
    "loader_queue_ms.train": 30.0, "loader_queue_ms.eval": 24.0, "collate_ms.train": 50.0,
    "collate_ms.eval": 50.0, "h2d_mb.train": 47.0, "h2d_mb.eval": 47.0,
    "decode_host_ms.eval": 120.0, "to_host_wait_ms.eval": 90.0,
}


def _reader(name, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "benchmark"))
    stem = name.split(".")[0]
    spec = importlib.util.spec_from_file_location(f"span_reader_{stem}",
                                                  ROOT / "benchmark" / "metrics" / f"{stem}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_span_metric_is_declared_with_its_one_cell():
    assert set(SPAN_METRICS) == set(EXPECTED)
    for name, metric in SPAN_METRICS.items():
        cell = "mmf_m4c.train_xe" if name.endswith(".train") else "mmf_m4c.eval_greedy"
        assert metric["workloads"] == [cell] and metric["source"] == "host_clock"
        assert metric["unit"] == ("MB" if name.startswith("h2d_mb") else "ms")


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_span_readers_on_a_hand_made_session(name, monkeypatch):
    """Each reader divides its span's total (or the bytes counter) by the
    slice's train steps or eval batches (or its batches), and reads nothing
    without a traced slice or a session."""
    reader = _reader(name, monkeypatch)
    metric = SPAN_METRICS[name]
    monkeypatch.setattr(tracing, "snapshot", lambda: HAND_MADE)
    assert reader.read({"trace": {"busy_s": 1.0}}, metric) == pytest.approx(EXPECTED[name])
    assert reader.read({"trace": None}, metric) is None
    monkeypatch.setattr(tracing, "snapshot", lambda: None)
    assert reader.read({"trace": {"busy_s": 1.0}}, metric) is None
