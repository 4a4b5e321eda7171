"""One run of one cell: set-up, the measured window, the traced slice (with
``--trace 1``), the reference's check, and the result line."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Callable, Dict, List, Optional

from . import env, files

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16, NVIDIA's data sheet (700 W)
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s


class Context:
    """What a kind of traffic (``benchmark/kinds/<kind>.py``) is given: the
    cell and its files, the run's arguments, the set-up clock and the steps
    it shares with every kind."""

    def __init__(self, cell: files.Cell, seed: int, seconds: float, trace: bool,
                 started: float, device: str = "cuda"):
        self.cell, self.name = cell, cell.name
        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device, self.on_card = device, device.startswith("cuda")
        self.started = started
        self._mark = time.time()
        self.phases: Dict[str, float] = {"interpreter and imports": self._mark - started}
        self.setup_s: Optional[float] = None
        self.memory_peak_bytes = 0
        self.paths: Dict[str, str] = {}
        self.shapes: List = []

    # -- set-up ------------------------------------------------------------------
    def phase(self, name: str) -> None:
        now = time.time()
        self.phases[name] = self.phases.get(name, 0.0) + now - self._mark
        self._mark = now

    def synchronize(self) -> None:
        if self.on_card:
            import torch
            torch.cuda.synchronize()

    def build_task(self):
        from . import program

        self.paths = program.write_split(self.name, self.traffic, self.seed)
        self.phase("data")
        config = program.run_config(self.config, self.traffic, self.paths, self.seed,
                                    program.checkpoint_dir(self.name, self.seed))
        task = program.build_task(config, self.device)
        self.phase("task build")
        program.load_weights(task.model, self.seed)
        self.shapes = program.model_shapes(task.model)
        self.synchronize()
        self.phase("weights")
        return task

    def window_start(self) -> float:
        self.phase("set-up end")
        self.setup_s = time.time() - self.started
        return time.perf_counter()

    # -- the traced slice ------------------------------------------------------------
    def traced_slice(self, task, feed, body: Callable[[], object]) -> Dict:
        """`body` under the profiler, with the benchmark's host ranges around
        the loader, the optimizer's and the scheduler's steps (on the task's
        instances) and every kernel entry point."""
        from .trace import Entries, Slice, host_range

        feed.ranges = True
        patched = []
        for owner_name, method in (("optimizer", "step"), ("scheduler", "step")):
            owner = getattr(task, owner_name, None)
            if owner is None:
                continue
            original = getattr(owner, method)

            def ranged(*args, _original=original, _label=f"{owner_name}.{method}", **kwargs):
                with host_range(_label, True):
                    return _original(*args, **kwargs)

            setattr(owner, method, ranged)
            patched.append((owner, method))
        entries = Entries(files.entry_works())
        traced = Slice(entries)
        started = time.perf_counter()
        try:
            with traced.run():
                body()
        finally:
            feed.ranges = False
            for owner, method in patched:
                delattr(owner, method)
        result = traced.result
        result["host_s"] = time.perf_counter() - started
        return result

    # -- after the window ----------------------------------------------------------------
    def finish_program(self, task) -> None:
        """Read the peak, then free the program's state before the reference
        runs (a process's peak never falls again)."""
        import torch

        if self.on_card:
            self.memory_peak_bytes = max(torch.cuda.max_memory_allocated(i)
                                         for i in range(torch.cuda.device_count()))
        task.model.to("meta")
        task.optimizer.state.clear()
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    def reference_inputs(self):
        """(split, weights, reference): the split as the configuration's
        reference reads it, the benchmark's weights drawn again from the seed,
        and the reference module (``benchmark/reference/<config>.py``)."""
        from . import program

        reference = files.reference(self.cell.workload["config"])
        split = reference.read_split(self.config, self.paths)
        weights = program.draw_weights(self.shapes, self.seed, self.device)
        return split, weights, reference


def per_layer(cell: files.Cell, record: Dict) -> Dict[str, Dict]:
    out = {}
    for metric in cell.per_layer:
        value = files.metric_reader(metric["name"]).read(record, metric)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def model_flops(ctx: Context) -> Dict[str, float]:
    """The configuration's model FLOPs per sample at the split's shapes, as
    its reference reads them."""
    name = ctx.cell.workload["config"]
    reference = files.reference(name)
    shapes = reference.shapes(ctx.config, ctx.traffic,
                              reference.read_split(ctx.config, ctx.paths))
    return files.model_work(name).flops(ctx.config, shapes)


def parse(argv: List[str]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="One run of one benchmark cell.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def execute(args, started: float, device: str = "cuda", config: Optional[Dict] = None,
            traffic: Optional[Dict] = None) -> Dict:
    """The run, as the result line's dict.  `config` (dotted keys) and
    `traffic` replace entries of the cell's files: the CPU tests run a cell at
    small widths on a small split."""
    from . import program

    cell = files.resolve(args.workload)
    cell = cell._replace(config={**cell.config, **(config or {})},
                         traffic={**cell.traffic, **(traffic or {})})
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), started, device)
    try:
        if device == "cuda":
            import torch  # noqa: F401
            from openvivqa_tpu_torch.ops import _cuda

            _cuda.lib()
            ctx.phase("kernel library")
        out = cell.kind.run(ctx)
        flops = model_flops(ctx)
    finally:
        program.remove_split(cell.name, args.seed)
    # what the per-layer readers (benchmark/metrics/) read
    record = {"traffic": cell.traffic, "window": out["window"],
              "end_to_end": out["end_to_end"], "trace": out.get("trace"),
              "flops_per_sample": flops[cell.kind.FLOPS],
              "peak_flops": PEAK_BF16_FLOPS, "peak_bytes": PEAK_HBM_BYTES}
    limits = {k: v for k, v in cell.limits.items() if not k.startswith("_")}
    from .checks import judged

    correct, checks = judged(out["numbers"], limits)
    if args.trace:
        metrics = per_layer(cell, record)
    else:
        metrics = {m["name"]: {"value": (ctx.setup_s if m["name"] == "setup_s"
                                         else out["end_to_end"][m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": bool(correct and out["failed"] == 0), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics}
    result["device"] = device_info(ctx, out)
    trace = out.get("trace")
    if args.trace and trace:
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["_notes"] = {"phases": ctx.phases, "setup_s": ctx.setup_s, "window": {
        k: v for k, v in out["window"].items() if not isinstance(v, list)},
        "counts": out["sample_counts"],
        "numbers": {k: v for k, v in out["numbers"].items()}, "flops": flops,
        "entries": {k: [len(v["work"]), v["device_s"]]
                    for k, v in ((trace or {}).get("entries") or {}).items()},
        "range_device_s": (trace or {}).get("range_device_s")}
    result["checks"] = checks
    return result


def device_info(ctx: Context, out: Dict) -> Dict:
    info = {"platform": "gpu" if ctx.on_card else "cpu", "count": int(ctx.cell.workload["chips"]),
            "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    if ctx.on_card:
        import torch
        info["kind"] = torch.cuda.get_device_name(0)
    else:
        info["kind"] = "cpu"
    trace = out.get("trace")
    if ctx.trace and trace:
        info["busy_s"], info["window_s"] = trace["busy_s"], trace["window_s"]
    return info


def power_limit() -> str:
    import subprocess

    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20)
        return done.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv: List[str], started: float) -> int:
    args = parse(argv)
    env.prepare()
    cell = files.resolve(args.workload)
    try:
        card = env.require_cards(int(cell.workload["chips"]))
    except RuntimeError as error:
        print(f"portbench: {error}", file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {card} "
          f"({power_limit()})", file=sys.stderr, flush=True)
    result = execute(args, started)
    found = env.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    notes = result.pop("_notes")
    print("portbench: notes " + json.dumps(notes, default=float), file=sys.stderr)
    print(f"portbench: samples in the window {notes['window'].get('samples')}, "
          f"{notes['counts']}", flush=True)
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, default=float), flush=True)
    return 0
