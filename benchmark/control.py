#!/usr/bin/env python3
"""The controls and faults behind each cell's limits, at the cell's own size:

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it writes the cell's split, draws the benchmark's weights and
reads, against the configuration's float32 reference, the numbers that decide
`correct`, for the control and the faults of the cell's kind of traffic
(``control_readings`` of ``benchmark/kinds/<kind>.py``): the reference one
precision step below the configuration's in the program's place, and the
faults the cell can have.  Each reading is judged against the cell's limits,
as a run's numbers are, and must come out not correct; a witness that reads
what the configuration's own precision moves comes out correct.

The benchmark's runs never run this; the limits in benchmark/limits/ were set
from its readings and the runs' own (PERF.md).  It prints each number beside
its limit on standard error and one JSON line per seed.  Without a card it
runs on the CPU (the tests, at small widths).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from portbench import checks, env, files, program  # noqa: E402


def parameter_shapes(cell, seed: int):
    """The port's parameter names and shapes for this cell, from a task built
    on the CPU (the benchmark draws its weights over them)."""
    paths = program.write_split(cell.name, cell.traffic, seed)
    try:
        config = program.run_config(cell.config, cell.traffic, paths, seed,
                                    program.checkpoint_dir(cell.name, seed))
        return program.model_shapes(program.build_task(config, "cpu").model)
    finally:
        program.remove_split(cell.name, seed)


def readings(cell, seed: int, shapes, device: str):
    paths = program.write_split(cell.name, cell.traffic, seed)
    try:
        reference = files.reference(cell.workload["config"])
        split = reference.read_split(cell.config, paths)
        weights = program.draw_weights(shapes, seed, device)
        return cell.kind.control_readings(cell, split, weights, reference, seed, device)
    finally:
        program.remove_split(cell.name, seed)


def control(workload: str, seeds, device: str, config=None, traffic=None):
    """Each seed's readings, each judged against the cell's limits (its
    `correct`); `config` (dotted keys) and `traffic` replace entries of the
    cell's files (the tests' small widths)."""
    cell = files.resolve(workload)
    cell = cell._replace(config={**cell.config, **(config or {})},
                         traffic={**cell.traffic, **(traffic or {})})
    limits = {k: v for k, v in cell.limits.items() if not k.startswith("_")}
    shapes = parameter_shapes(cell, seeds[0])
    out = []
    for seed in seeds:
        line = {"workload": cell.name, "seed": seed}
        for label, numbers in readings(cell, seed, shapes, device).items():
            correct, judged = checks.judged(numbers, limits)
            line[label] = {**numbers, "correct": correct, "checks": judged}
        out.append(line)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    env.prepare()
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    for line in control(args.workload, args.seeds, device):
        for label, reading in line.items():
            if isinstance(reading, dict):
                for name, check in reading.pop("checks").items():
                    print(f"{line['seed']} {label} {name} {check['value']!r} "
                          f"limit {check['limit']!r}", file=sys.stderr)
        print(json.dumps(line, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
