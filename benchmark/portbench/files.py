"""Resolve a cell of ``BENCHMARK.json`` to its files, by name."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple

BENCH = Path(__file__).resolve().parents[1]  # benchmark/
ROOT = BENCH.parent  # the checkout


def load_json(path: Path):
    with open(path, encoding="utf-8") as handle:
        return json.load(handle)


def load_module(path: Path, name: str) -> ModuleType:
    """A benchmark file as a module (by path: metric names hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)}")
    key = f"portbench_loaded.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


class Cell(NamedTuple):
    name: str
    workload: Dict
    config_entry: Dict
    config: Dict  # the configuration file's contents
    traffic: Dict
    kind: ModuleType
    end_to_end: List[Dict]  # the metrics this cell reports with --trace 0
    per_layer: List[Dict]  # and with --trace 1
    limits: Dict


def reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, bench_root: Path = BENCH) -> Cell:
    """The cell `name` with every file it names loaded; FileNotFoundError or
    KeyError where one is missing."""
    spec = load_json(bench_root.parent / "BENCHMARK.json")
    workloads = {w["name"]: w for w in spec["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = workloads[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config_entry = configs[workload["config"]]
    traffic = load_json(bench_root / "traffic" / f"{workload['traffic']}.json")
    kind = load_module(bench_root / "kinds" / f"{traffic['kind']}.py", f"kinds.{traffic['kind']}")
    per_layer = [m for m in spec["per_layer"] if reports(m, name)]
    end_to_end = [m for m in spec["end_to_end"] if reports(m, name)]
    return Cell(
        name=name, workload=workload, config_entry=config_entry,
        config=load_json(bench_root.parent / config_entry["file"]), traffic=traffic,
        kind=kind, end_to_end=end_to_end, per_layer=per_layer,
        limits=load_json(bench_root / "limits" / f"{name}.json"),
    )


def metric_reader(name: str, bench_root: Path = BENCH) -> ModuleType:
    """A per-layer metric's reader: ``metrics/<name>.py``, or else the one of
    its quantity, ``metrics/<the name before its first dot>.py``, which
    serves every split of it (``mfu.train``, ``mfu.eval``).  Its
    ``read(record, metric)`` returns None where it finds nothing to read."""
    for stem in (name, name.split(".")[0]):
        path = bench_root / "metrics" / f"{stem}.py"
        if path.is_file():
            return load_module(path, f"metrics.{stem}")
    raise FileNotFoundError(f"no reader benchmark/metrics/{name}.py")


def model_work(config: str, bench_root: Path = BENCH) -> ModuleType:
    return load_module(bench_root / "work" / "models" / f"{config}.py", f"work.models.{config}")


def reference(config: str, bench_root: Path = BENCH) -> ModuleType:
    return load_module(bench_root / "reference" / f"{config}.py", f"reference.{config}")


def entry_works(bench_root: Path = BENCH) -> Dict[str, ModuleType]:
    """Every kernel entry's work count, by entry name."""
    return {path.stem: load_module(path, f"work.entries.{path.stem}")
            for path in sorted((bench_root / "work" / "entries").glob("*.py"))}
