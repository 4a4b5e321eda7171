#!/usr/bin/env python3
"""Kernel D and the dropout pair at the standalone M4C's own inputs, over several seeds, on one card.

    python3 m4c_step_probe.py [--seeds 0 1 2]

For each seed, a process of its own builds the kernels and configs/m4c.yaml at
its widths (random weights from the seed, TEXT_BERT.LOAD_PRETRAINED false) on
chip_smoke.py phase 11's synthetic set made from that seed, and runs phase
11's ``check_m4c_kernels`` (kernels C, D and the packed attention on the
inputs one eval forward and one incremental greedy decode give them: D's
error by step and layer, each version against float64, the rows'
pre-LayerNorm spread, D's time three times over, then as the card is and
right after two seconds of large products, with its clocks) and
``check_dropout_at_path_shapes`` on one train step of the train config
(batches of 16).  The card's name and power limit come first; a seed's
failures end its run with code 1, after its output.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def d_time_under_load(task) -> None:
    """D's device time at the last step of one incremental greedy decode of
    the first dev batch: as the card is, then right after about two seconds
    of large bf16 products, with the card's clocks and power draw as
    nvidia-smi reads them just after each reading."""
    import torch

    import chip_smoke
    from openvivqa_tpu_torch.ops import decode_step

    steps = {}
    _, batch = next(task.device_batches(task.dev_dict_dataloader))
    with torch.no_grad(), chip_smoke.capture_calls(decode_step, "fused_bert_self_step",
                                                   lambda a: a[5], steps):
        task.model.greedy_decode(batch)
    args = steps[max(steps)][0]
    kernel = lambda: decode_step.fused_bert_self_step(*args)  # noqa: E731
    readings = [(chip_smoke.device_ms(kernel)[0], sm_clock())]
    a = torch.randn(8192, 8192, device="cuda").to(torch.bfloat16)
    start = time.perf_counter()
    while time.perf_counter() - start < 2.0:
        for _ in range(50):
            a @ a
        torch.cuda.synchronize()
    readings.append((chip_smoke.device_ms(kernel)[0], sm_clock()))
    chip_smoke.log("    D's device time as the card is, then after ~2 s of bf16 products: "
                   + "; ".join(f"{ms:.4f} ms (sm, mem clock, power: {clock})"
                               for ms, clock in readings))


def probe(seed: int) -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from openvivqa_tpu_torch.builders import build_task, populate
    from openvivqa_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        raise SystemExit("m4c_step_probe.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build()
    _cuda.lib()
    populate()
    failures, results = [], {}
    record = chip_smoke.make_recorder(results, failures)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="m4c_step_probe_", dir=ROOT / "build") as tmp:
        paths = chip_smoke.m4c_family_data(tmp, seed)
        over = chip_smoke.NO_PRETRAINED
        config, quadratic = chip_smoke.m4c_family_task(paths, tmp, seed, "m4c.yaml", "m4c", over)
        _, incremental = chip_smoke.m4c_family_task(
            paths, tmp, seed, "m4c.yaml", "m4c", {**over, "DECODING_MODE": "incremental"})
        chip_smoke.log(f"seed {seed}: kernels C, D and the packed attention at m4c's inputs")
        chip_smoke.check_m4c_kernels(quadratic, incremental, record, failures)
        d_time_under_load(incremental)
        del quadratic, incremental
        train = build_task(config.merged({"TRAINING": {
            "CHECKPOINT_PATH": str(Path(tmp) / "m4c_train")}}), "cuda")
        chip_smoke.log(f"seed {seed}: the dropout pair at one m4c train step's inputs")
        chip_smoke.check_dropout_at_path_shapes(train, "m4c train", record, failures)
    for failure in failures:
        chip_smoke.log(f"FAILED: {failure}")
    return 1 if failures else 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--one", type=int, help=argparse.SUPPRESS)  # a seed's own process
    args = parser.parse_args()
    if args.one is not None:
        return probe(args.one)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    rc = 0
    for seed in args.seeds:
        rc |= subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one",
                              str(seed)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
