"""The Iterative M4C family's decoder span and cross-attention counter
(``openvivqa_tpu_torch/utils/tracing.py``: ``decode.decoder``,
``decode.cross_kv_rows``) on small models on the CPU, and the benchmark's
readers of them.

A quadratic greedy batch runs the decoder stack once a step, and each
decoder layer projects the encoder's b x S states to cross-attention keys
and values again at each step; the incremental decode projects them once a
sequence; MMF_M4C has no cross-attention.
"""

import importlib.util
import pathlib

import pytest
import torch

from openvivqa_tpu_torch.builders import META_ARCHITECTURE, populate
from openvivqa_tpu_torch.config import ConfigNode
from openvivqa_tpu_torch.utils import tracing
from test_torch_port_iterative_m4c_reference import (
    B,
    N_OBJ,
    N_OCR,
    Q,
    batch,
    model_node,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
STEPS, LAYERS, S = 12, 2, Q + N_OBJ + N_OCR  # the decoder's layers in model_node()

populate()


class Vocab:
    padding_idx, bos_idx, eos_idx, unk_idx = 0, 1, 2, 3
    max_answer_length = STEPS

    def __len__(self):
        return 25


def iterative(**extra):
    return META_ARCHITECTURE.get("MMF_IterativeM4C")(model_node(**extra), Vocab()).eval()


def mmf_m4c(**extra):
    node = {"D_MODEL": 32,
            "MMT": {"HIDDEN_SIZE": 32, "NUM_HIDDEN_LAYERS": 1, "NUM_ATTENTION_HEADS": 2},
            "TEXT_BERT": {"HIDDEN_SIZE": 32, "NUM_HIDDEN_LAYERS": 1},
            "OBJECT_EMBEDDING": {"D_FEATURE": 12, "DROPOUT": 0.1},
            "OCR_EMBEDDING": {"D_FEATURE": 20, "DROPOUT": 0.1}}
    return META_ARCHITECTURE.get("MMF_M4C")(ConfigNode({**node, **extra}), Vocab()).eval()


def recorded(run):
    with tracing.recording():
        run()
    snap = tracing.snapshot()
    return snap, snap["counters"].get("decode.cross_kv_rows", 0)


def test_a_quadratic_greedy_batch_runs_the_decoder_and_projects_the_encoder_at_each_step():
    model, inputs = iterative(), batch()
    snap, rows = recorded(lambda: model.greedy_decode(inputs))
    decoders = [s for s in snap["spans"] if s.name == "decode.decoder"]
    assert len(decoders) == STEPS
    assert {snap["spans"][s.parent].name for s in decoders} == {"decode.step"}
    assert rows == STEPS * LAYERS * B * S


def test_the_incremental_decode_projects_the_encoder_once():
    model, inputs = iterative(DECODING_MODE="incremental"), batch()
    snap, rows = recorded(lambda: model.greedy_decode(inputs))
    assert "decode.decoder" not in snap["names"]
    assert snap["names"]["decode.step"]["count"] == STEPS
    assert rows == LAYERS * B * S


def test_a_teacher_forced_forward_runs_the_decoder_once():
    model, inputs = iterative(), batch()
    snap, rows = recorded(lambda: model(inputs))
    assert snap["names"]["decode.decoder"]["count"] == 1
    assert rows == LAYERS * B * S


@pytest.mark.parametrize("mode", [None, "incremental"])
def test_an_mmf_m4c_batch_has_no_decoder_span_and_counts_no_rows(mode):
    model, inputs = mmf_m4c(DECODING_MODE=mode), batch()
    snap, rows = recorded(lambda: model.greedy_decode(inputs))
    assert "decode.decoder" not in snap["names"] and rows == 0
    assert snap["names"]["decode.step"]["count"] == STEPS


def test_off_the_span_reads_no_clock_and_the_counter_counts(monkeypatch):
    """Outside recording() and a profiler the decoder's span is the shared
    no-op: no clock read, no record_function; the counter counts all the
    same."""
    model, inputs = iterative(), batch()
    with tracing.span("decode.step"):
        pass  # closes any session left live by an earlier test
    clock, entered = [], []
    real_clock = tracing.time.perf_counter_ns
    monkeypatch.setattr(tracing.time, "perf_counter_ns", lambda: clock.append(1) or real_clock())
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name))
    before = tracing.counters("decode.cross_kv_rows").get("decode.cross_kv_rows", 0)
    model.greedy_decode(inputs)
    assert (clock, entered) == ([], [])
    assert tracing.counters("decode.cross_kv_rows")["decode.cross_kv_rows"] \
        == before + STEPS * LAYERS * B * S


# -- the benchmark's readers ----------------------------------------------------------------------
def _reader(stem, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "benchmark"))
    spec = importlib.util.spec_from_file_location(f"iterative_reader_{stem}",
                                                  ROOT / "benchmark" / "metrics" / f"{stem}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _aggregate(count, total):
    return {"count": count, "total_ms": total, "self_ms": total, "max_ms": total / count}


# 4 eval batches of 12 steps, each step's decoder stack 5 ms of 7
HAND_MADE = {
    "session": 1, "spans": [],
    "names": {"eval.batch": _aggregate(4, 600.0), "decode.step": _aggregate(48, 336.0),
              "decode.decoder": _aggregate(48, 240.0)},
    "counters": {"decode.cross_kv_rows": 4 * 681_984},
}
METRIC = {"moves": "eval_samples_per_s"}


@pytest.mark.parametrize("stem, value", [("cross_kv_rows", 681_984.0),
                                         ("decoder_host_ms", 60.0),
                                         ("decode_step_ms", 84.0)])
def test_the_readers_on_a_hand_made_session(stem, value, monkeypatch):
    """Each reader divides the counter or its span's total by the slice's
    eval batches, and reads nothing without a traced slice, without a
    session, or where the port has no such counter or span (an older
    port)."""
    reader = _reader(stem, monkeypatch)
    monkeypatch.setattr(tracing, "snapshot", lambda: HAND_MADE)
    assert reader.read({"trace": {"busy_s": 1.0}}, METRIC) == pytest.approx(value)
    assert reader.read({"trace": None}, METRIC) is None
    older = {"session": 1, "spans": [], "names": {"eval.batch": _aggregate(4, 600.0)},
             "counters": {}}
    monkeypatch.setattr(tracing, "snapshot", lambda: older)
    assert reader.read({"trace": {"busy_s": 1.0}}, METRIC) is None
    monkeypatch.setattr(tracing, "snapshot", lambda: None)
    assert reader.read({"trace": {"busy_s": 1.0}}, METRIC) is None
