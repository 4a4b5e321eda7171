"""BENCHMARK.json against the benchmark's contract, and every cell resolved to
its files by name (a cell added by files alone: test_portbench_new_cell.py)."""

import json
import re

import portbench_small as small
import pytest

from portbench import files, program

SPEC = json.loads((small.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 2 + 14 * 24 <= 43200 and (2 + 14 * 24) * (SPEC["run_seconds"] + 60) \
        + 24 * 180 + 1200 <= 43200
    assert len((small.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for entry in SPEC["configs"] + SPEC["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for metric in metrics:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    for metric in SPEC["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    end_to_end = {m["name"] for m in SPEC["end_to_end"]}
    for metric in SPEC["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["moves"] in end_to_end
    for workload in SPEC["workloads"]:
        assert set(workload) == {"name", "config", "traffic", "chips", "why"}
        assert workload["chips"] == 1 and len(workload["why"]) <= 200
    for config in SPEC["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert config["file"].startswith("benchmark/")
        assert all(not k.endswith(("_dim", "_rank", "SIZE")) for k in config["reduced"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    resolved = files.resolve(cell)
    kind = resolved.kind
    assert callable(kind.run) and callable(kind.control_readings) and kind.FLOPS
    assert callable(program.generator(resolved.traffic).generate)
    config = resolved.workload["config"]
    reference = files.reference(config)
    for function in ("read_split", "shapes", "train_readings", "step_scores"):
        assert callable(getattr(reference, function)), function
    assert callable(files.model_work(config).flops)
    for key in resolved.config_entry["reduced"]:
        assert key in resolved.config
    reported = {m["name"] for m in resolved.per_layer}
    assert reported, cell
    for name in reported:
        assert callable(files.metric_reader(name).read)
    assert {m["name"] for m in resolved.end_to_end} >= {"setup_s"}
    assert any(not k.startswith("_") for k in resolved.limits)


def test_every_kernel_entry_names_its_port_function():
    works = files.entry_works()
    assert {"fused_ffn_step", "fused_encoder_self_attention", "fused_attention_packed",
            "fused_attention_packed_dropout"} <= set(works)
    for work in works.values():
        assert work.MODULE.startswith("openvivqa_tpu_torch.") and callable(work.forward)
