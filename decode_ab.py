#!/usr/bin/env python3
"""Interleaved A/B runs of chip_smoke.py's phases 4-7 across source trees, on one card.

    python3 decode_ab.py TREE [TREE ...] [--reps N] [--seed N] [--out DIR]

Each TREE is a directory holding a copy of the repository at some commit (for
example unpacked from ``git archive``).  The trees run in turns, forward then
backward (A B B A A B ...), ``--reps`` times each, every run a process of its
own that imports that tree's ``chip_smoke.py`` and calls its ``main()`` with
phase 3 (the kernel table) and the phases after 7 replaced by stubs, so each
run builds the tree's kernels and drives its phases 4-7 as the tree's own
script does.  A run's log goes to ``DIR/<tree name>_<i>.log``.  The numbers
read from the logs, per tree: the greedy decode of one batch of 64 (CUDA-event
median of 5, which on these host-bound decodes times the host's enqueue work
as well) of each phase-4 and phase-7 decode mode and of the one-batch
variants, the beam ``generate()`` times of phase 6, the train-step times of
phases 5-7, and the profiler's device busy time and wall time of each
profiled call.  The last line is one JSON object: per tree and metric, every
run's value, the median and the spread (max - min).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

# (metric name pattern, regex over a log line); the name's {label} is the
# bracketed label the line starts with
PATTERNS = (
    ("greedy {label}", re.compile(
        r"\[(?P<label>[^\]]+)\] greedy decode of one batch of \d+ \(CUDA-event median of 5\): "
        r"kernel path (?P<ms>[\d.]+) ms")),
    ("greedy {label}", re.compile(
        r"\[(?P<label>[^\]]+)\] [\d.]+M parameters; greedy decode of one batch of \d+: "
        r"(?P<ms>[\d.]+) ms")),
    ("generate {label}", re.compile(
        r"\[(?P<label>beam)\] generate\(\) of one batch .*?: layer route (?P<ms>[\d.]+) ms")),
    ("train step {label}", re.compile(
        r"\[(?P<label>[^\]]+)\] one train step of \d+ \(CUDA-event median of 5, in turns\): "
        r"kernel path (?P<ms>[\d.]+),")),
    ("device busy {label}", re.compile(
        r"\[(?P<label>[^\]]+)\] profiler: device busy (?P<ms>[\d.]+) ms")),
    ("profiled wall {label}", re.compile(
        r"\[(?P<label>[^\]]+)\] profiler: device busy [\d.]+ ms of (?P<ms>[\d.]+) ms wall")),
)

CHILD = r"""
import os, sys
tree = sys.argv[1]
os.chdir(tree)
sys.path.insert(0, tree)
sys.argv = ["chip_smoke.py", "--seed", sys.argv[2]]
import chip_smoke
chip_smoke.check_kernels = lambda *args, **kwargs: {}
chip_smoke.run_vit_mt5 = lambda *args, **kwargs: ({}, {})
chip_smoke.run_joint_transformer = lambda *args, **kwargs: {}
try:
    chip_smoke.main()
except KeyError:  # the kernel table at the end: phase 3 did not run
    pass
print("DECODE_AB_DONE", flush=True)
"""


def metrics(log: str) -> dict:
    found = {}
    for line in log.splitlines():
        for name, pattern in PATTERNS:
            match = pattern.search(line)
            if match:
                found[name.format(label=match.group("label"))] = float(match.group("ms"))
    return found


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="chiprun_out/decode_ab")
    args = parser.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trees = [Path(t).resolve() for t in args.trees]
    order = []
    for rep in range(args.reps):
        order += trees if rep % 2 == 0 else trees[::-1]
    runs = {tree.name: [] for tree in trees}
    for i, tree in enumerate(order):
        proc = subprocess.run([sys.executable, "-c", CHILD, str(tree), str(args.seed)],
                              capture_output=True, text=True, env=dict(os.environ))
        log = proc.stdout + proc.stderr
        (out / f"{tree.name}_{i}.log").write_text(log)
        done = "DECODE_AB_DONE" in proc.stdout
        found = metrics(proc.stdout)
        print(f"run {i}: {tree.name}, exit {proc.returncode}, {'complete' if done else 'CUT'}, "
              f"{len(found)} numbers", flush=True)
        if not done:
            print(log[-3000:], flush=True)
            return 1
        runs[tree.name].append(found)
    summary = {}
    for name, found in runs.items():
        keys = sorted(set().union(*found))
        summary[name] = {
            key: {"runs": [f.get(key) for f in found],
                  "median": statistics.median(f[key] for f in found if key in f),
                  "spread": max(f[key] for f in found if key in f)
                  - min(f[key] for f in found if key in f)}
            for key in keys
        }
    keys = sorted(set().union(*(s.keys() for s in summary.values())))
    for key in keys:
        print(f"{key}: " + "; ".join(
            f"{name} median {s[key]['median']:.3f} (spread {s[key]['spread']:.3f})"
            for name, s in summary.items() if key in s))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
