"""The per-layer metrics that read the port's own spans and counters
(``openvivqa_tpu_torch.utils.tracing``): a small traced run of each cell
reports every one of them as a number.

The small split has 4 batches an epoch and the device copies run two batches
ahead, so a slice of 2 steps can fall where no batch is made or put: these
runs trace 6, which always cross an epoch's start."""

import argparse
import json
import time

import portbench_small as small
import pytest

SPEC = json.loads((small.ROOT / "BENCHMARK.json").read_text())
READERS = ("forward_host_ms", "backward_host_ms", "optimizer_host_ms", "put_batch_ms",
           "loader_queue_ms", "collate_ms", "h2d_mb", "decode_host_ms", "to_host_wait_ms")


def span_metrics(cell):
    return {m["name"] for m in SPEC["per_layer"]
            if m["name"].split(".")[0] in READERS and cell in m.get("workloads", ())}


@pytest.mark.parametrize("cell", ["mmf_m4c.train_xe", "mmf_m4c.eval_greedy"])
def test_a_traced_run_reports_every_span_metric(cell):
    names = span_metrics(cell)
    assert len(names) == (7 if cell.endswith("train_xe") else 6)
    from portbench import env, main

    env.prepare()
    args = argparse.Namespace(workload=cell, seed=small.SEED, seconds=1.0, trace=1)
    result = main.execute(args, time.time(), device="cpu", config=small.config(cell),
                          traffic={**small.TRAFFIC, "traced_steps": 6, "traced_batches": 6})
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert names <= set(metrics)
    for name in names:
        value = metrics[name]["value"]
        assert isinstance(value, float) and value > 0.0, name
    assert metrics[next(n for n in names if n.startswith("h2d_mb"))]["unit"] == "MB"
    idle = dict(result["breakdown"]["idle_gaps"])
    assert not {name for name in idle if name.split(".")[0] in ("data", "train", "eval",
                                                                 "decode")}
