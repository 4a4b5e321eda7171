"""Greedy evaluation: ``TrainingMMF.generate_answers`` over
``task.device_batches(task.dev_dict_dataloader)`` inside
``task.eval_weights()``, pass after pass over the dev split; each batch ends as
answer strings on the host.  No scoring step.

A batch's time runs from asking the loader for it to its answer strings on
the host.  Checked batches, drawn from the seed among the window's first
`checked_from`, keep each decode step's answer prefix and scores and the
served ids: the
task's ``greedy_ids`` and the model's ``_update_prev_inds`` are wrapped on
their instances for those batches only, keeping the tensors they return.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import program
from portbench.trace import Feed, host_range

FLOPS = "eval"  # the model FLOPs a sample of this work counts (benchmark/work/models)
# one step below what the configurations state for evaluation (bf16 in the
# kernels, float32 nn.Linear outside them): every product in bf16
CONTROL = "bf16"


class Capture:
    """The answer prefix and the scores of every decode step of one batch,
    and its served ids: the prefix of step 0 is <bos> then zeros, that of
    step t + 1 what ``_update_prev_inds`` returned at step t, which is also
    handed step t's scores."""

    def __init__(self, task):
        self.task, self.model = task, task.model
        self.prefixes: List[torch.Tensor] = []
        self.scores: List[torch.Tensor] = []
        self.served = None

    def __enter__(self):
        update, greedy = self.model._update_prev_inds, self.task.greedy_ids

        def capture_update(prev_inds, scores, step):
            if not self.prefixes:
                self.prefixes.append(prev_inds.clone())
            out = update(prev_inds, scores, step)
            self.prefixes.append(out)
            self.scores.append(scores)
            return out

        def capture_greedy(device_batch):
            self.served = greedy(device_batch)
            return self.served

        self.model._update_prev_inds = capture_update
        self.task.greedy_ids = capture_greedy
        return self

    def __exit__(self, *exc):
        del self.model._update_prev_inds
        del self.task.greedy_ids
        return False

    def result(self) -> Dict:
        # the last prefix follows the last step and feeds none
        return {"prefixes": [p.cpu() for p in self.prefixes[:-1]],
                "scores": [s.cpu() for s in self.scores], "served": self.served.cpu()}


def answer(task, feed, ranges: bool = False):
    host, device_batch = feed.next()
    with host_range("generate_answers", ranges):
        answers = task.generate_answers(host, device_batch)
    return host, answers


def run(ctx) -> Dict:
    task = ctx.build_task()
    feed = Feed(task, task.dev_dict_dataloader)
    rng = np.random.default_rng(ctx.seed)
    checked_at = set(rng.choice(int(ctx.traffic["checked_from"]),
                                size=int(ctx.traffic["checked_batches"]),
                                replace=False).tolist())
    checked = []
    with task.eval_weights():
        for _ in range(int(ctx.traffic["warmup_batches"])):
            answer(task, feed)
        ctx.synchronize()
        ctx.phase("warm-up")

        feed.waits.clear()
        times, rows, answered = [], [], 0
        start = ctx.window_start()
        while time.perf_counter() - start < ctx.seconds:
            began = time.perf_counter()
            if len(times) in checked_at:
                with Capture(task) as capture:
                    host, answers = answer(task, feed)
                checked.append((program.host_fields(host), capture.result()))
            else:
                host, answers = answer(task, feed)
            times.append(time.perf_counter() - began)
            n_real = int(host["sample_valid"].sum())
            rows.append(n_real)
            answered += sum(isinstance(a, str) for a in answers[:n_real])
        seconds = time.perf_counter() - start
        waits, epochs = list(feed.waits), feed.epochs

        trace = None
        if ctx.trace:
            batches = int(ctx.traffic["traced_batches"])
            trace = ctx.traced_slice(task, feed, lambda: [answer(task, feed, ranges=True)
                                                          for _ in range(batches)])
    feed.close()
    ctx.finish_program(task)
    del task, feed

    split, weights, reference = ctx.reference_inputs()
    numbers = gaps(split, weights, reference, ctx.config, checked, ctx.device)
    samples = sum(rows)
    ms = sorted(1e3 * t for t in times)
    return {
        "attempted": samples,
        "failed": samples - answered,
        "window": {"seconds": seconds, "samples": samples, "batches": len(times),
                   "epochs": epochs, "waits": waits, "batch_ms": ms},
        "end_to_end": {"eval_samples_per_s": samples / seconds},
        "trace": trace,
        "numbers": numbers,
        "sample_counts": {"batches": len(times), "batch_ms": quantiles(ms),
                          "loader_wait_ms": quantiles(sorted(1e3 * w for w in waits))},
    }


def gaps(split, weights, reference, config, checked, device,
         precision: Optional[str] = None) -> Dict[str, float]:
    """The greedy check's numbers over every decode step of each checked
    batch, on the batch's real rows:

      score_gap: the largest |program score - reference score| over the
        candidates the reference's `live_scores` leaves open, over the
        largest |reference score| there;
      served_gap: the widest gap by which the reference's score of the token
        the program chose lies under the reference's best, over the same
        largest |reference score|;
      input_mismatches: question ids in the program's batch that differ.

    With `precision`, the control's instead: the reference at that precision
    in the program's place, choosing its own first tokens."""
    worst = {"score_gap": 0.0, "served_gap": 0.0, "input_mismatches": 0}
    if not checked:
        return {name: float("inf") for name in worst}
    for host, capture in checked:
        batch, bad = split.eval_batch(host, device)
        worst["input_mismatches"] += bad
        valid = batch["sample_valid"] > 0
        prefixes = capture["prefixes"]
        for t, prefix in enumerate(prefixes):
            scores = reference.step_scores(config, weights, batch, prefix.to(device))
            if precision is not None:
                other = reference.step_scores(config, weights, batch, prefix.to(device),
                                              precision)
                chosen = other.argmax(-1)
            else:
                other = capture["scores"][t].to(device).float()
                chosen = (prefixes[t + 1][:, 1:] if t + 1 < len(prefixes)
                          else capture["served"]).to(device).long()
            if other.shape != scores.shape:
                return {name: float("inf") for name in worst}
            live = reference.live_scores(scores) & valid[:, None, None]
            scale = float(scores.abs()[live].max())
            worst["score_gap"] = max(worst["score_gap"],
                                     float((other - scores).abs()[live].max()) / scale)
            steps = chosen.shape[1]
            if chosen.max() >= scores.shape[-1] or chosen.min() < 0:
                return {**worst, "served_gap": float("inf")}
            picked = scores[:, :steps].gather(-1, chosen[..., None])[..., 0]
            gap = scores[:, :steps].max(-1).values - picked
            worst["served_gap"] = max(worst["served_gap"], float(gap[valid].max()) / scale)
    return worst


def control_readings(cell, split, weights, reference, seed: int, device) -> Dict[str, Dict]:
    """The numbers of the control and a fault against the float32 reference
    on the dev split's first `checked_batches` batches, along the float32
    reference's own greedy prefixes: the scores of the reference at bf16
    products (the control), and the gap of a served token altered to the
    second best at the last step (a fault)."""
    rows = int(cell.config["DATASET.DICT_DATASET.BATCH_SIZE"])
    checked, fault = [], 0.0
    for host in split.host_dev_batches(rows, int(cell.traffic["checked_batches"])):
        batch, _ = split.eval_batch(host, device)
        prefix = torch.zeros((batch["sample_valid"].shape[0], split.max_answer),
                             dtype=torch.long, device=device)
        prefix[:, 0] = 1  # <bos>
        prefixes = []
        for _ in range(split.max_answer):
            prefixes.append(prefix.cpu())
            scores = reference.step_scores(cell.config, weights, batch, prefix)
            prefix = prefix.clone()
            prefix[:, 1:] = scores.argmax(-1)[:, :-1]
        # the fault: the last step's token of the first row altered to the
        # second best, where it is produced
        live = reference.live_scores(scores) & (batch["sample_valid"] > 0)[:, None, None]
        best, second = scores[0, -1].topk(2).values.tolist()
        fault = max(fault, (best - second) / float(scores.abs()[live].max()))
        checked.append((host, {"prefixes": prefixes, "served": scores.argmax(-1).cpu()}))
    control = gaps(split, weights, reference, cell.config, checked, device, precision=CONTROL)
    return {"control": control,
            "altered_token": {"score_gap": 0.0, "served_gap": fault, "input_mismatches": 0}}


def quantiles(sorted_values: List[float]) -> Dict[str, float]:
    """p10, p50, p90 and the largest of a sorted sample (for the notes)."""
    if not sorted_values:
        return {}
    return {f"p{q}": percentile(sorted_values, q) for q in (10, 50, 90)} | {
        "max": sorted_values[-1]}


def percentile(sorted_values: List[float], q: float) -> float:
    """The q-th percentile by linear interpolation between closest ranks
    (numpy's default)."""
    return float(np.percentile(np.asarray(sorted_values), q)) if sorted_values else float("nan")
