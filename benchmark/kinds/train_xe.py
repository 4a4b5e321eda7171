"""XE training: ``TrainingMMF._train_step`` over
``task.device_batches(task.train_dataloader)``, epoch after epoch: the
loader's worker threads as the config sets them, ``put_batch``, the forward
and backward passes with dropout, Adam and the LambdaLR warm-up.

Set-up builds the task, loads the benchmark's weights and drives the task's
own step through its first `checked_steps` batches of the same feed that the
window goes on with; those steps are the warm-up (every batch has one shape)
and the ones the reference follows.  The window's rate counts the valid rows
of every step it runs, over its whole wall time, which ends once the card has
finished them.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from portbench import checks, program
from portbench.trace import Feed, host_range

BETA1 = 0.9  # the port's Adam (training/optim.py)
FLOPS = "train"  # the model FLOPs a sample of this work counts (benchmark/work/models)
CONTROL = "bf16"  # the training configurations' float32 products, one step down


def first_gradient_norms(task) -> Dict[str, float]:
    """Each leaf's gradient of the first step, as Adam holds it after one
    step: exp_avg = (1 - beta1) * gradient."""
    out = {}
    for name, param in task.model.named_parameters():
        state = task.optimizer.state.get(param, {})
        out[name] = float(state["exp_avg"].norm()) / (1.0 - BETA1) if "exp_avg" in state else 0.0
    return out


@torch.no_grad()
def change_norms(task, seed: int) -> Dict[str, float]:
    """Each leaf's distance from the weights the run started from (drawn
    again from the seed)."""
    device = next(task.model.parameters()).device
    initial = program.draw_weights(program.model_shapes(task.model), seed, device)
    return {name: float((param - initial[name]).norm())
            for name, param in task.model.named_parameters()}


def train_step(task, feed, ranges: bool = False):
    host, device_batch = feed.next()
    with host_range("train_step", ranges):
        loss = task._train_step(device_batch)
    return host, loss


def run(ctx) -> Dict:
    task = ctx.build_task()
    feed = Feed(task, task.train_dataloader)
    checked, losses, grads = [], [], {}
    for step in range(int(ctx.traffic["checked_steps"])):
        host, loss = train_step(task, feed)
        checked.append(program.host_fields(host))
        losses.append(loss)
        if step == 0:
            grads = first_gradient_norms(task)
    side = {"loss": [float(x) for x in losses], "grad_norms": grads,
            "change_norms": change_norms(task, ctx.seed)}
    ctx.synchronize()
    ctx.phase("warm-up")

    feed.waits.clear()
    window_losses, rows = [], []
    start = ctx.window_start()
    while time.perf_counter() - start < ctx.seconds:
        host, loss = train_step(task, feed)
        window_losses.append(loss)
        rows.append(int(host["sample_valid"].sum()))
    ctx.synchronize()
    seconds = time.perf_counter() - start
    finite = torch.isfinite(torch.stack(window_losses)).tolist() if window_losses else []
    waits, epochs = list(feed.waits), feed.epochs

    trace = None
    if ctx.trace:
        steps = int(ctx.traffic["traced_steps"])
        trace = ctx.traced_slice(task, feed, lambda: [train_step(task, feed, ranges=True)
                                                      for _ in range(steps)])
    feed.close()
    ctx.finish_program(task)
    del task, feed, window_losses

    split, weights, reference = ctx.reference_inputs()
    batches, mismatches = [], 0
    for host in checked:
        batch, bad = split.train_batch(host, ctx.device)
        batches.append(batch)
        mismatches += bad
    readings = reference.train_readings(ctx.config, weights, batches, ctx.seed)
    numbers = checks.train_numbers(side, readings)
    numbers["input_mismatches"] = mismatches
    samples = sum(rows)
    return {
        "attempted": samples,
        "failed": sum(n for n, ok in zip(rows, finite) if not ok),
        "window": {"seconds": seconds, "samples": samples, "steps": len(rows),
                   "epochs": epochs, "waits": waits},
        "end_to_end": {"train_samples_per_s": samples / seconds},
        "trace": trace,
        "numbers": numbers,
        "sample_counts": {"steps": len(rows), "loader_wait_ms": {
            f"p{q}": float(np.percentile(np.asarray(waits) * 1e3, q)) for q in (10, 50, 90)}
            if waits else {}},
    }


def control_readings(cell, split, weights, reference, seed: int, device) -> Dict[str, Dict]:
    """The numbers of the control and the faults against the float32
    reference, on the split's first `checked_steps` batches: the reference at
    bf16 products in the program's place (the control); the reference with
    half of each batch left out of the loss (a fault); and, as a witness, the
    reference at the precision the configuration states (bf16 attention
    operands), which reads what rounding alone moves.  A step that leaves the
    state unchanged reads 1 by the change's measure and needs no run."""
    rows = int(cell.config["DATASET.FEATURE_DATASET.BATCH_SIZE"])
    batches = [split.train_batch(host, device)[0]
               for host in split.host_train_batches(rows, int(cell.traffic["checked_steps"]))]
    base = reference.train_readings(cell.config, weights, batches, seed)
    out = {}
    for label, kwargs in (("control", {"precision": CONTROL}),
                          ("half_batch", {"fault": "half_batch"}),
                          ("stated_precision", {"precision": "bf16_attention"})):
        side = reference.train_readings(cell.config, weights, batches, seed, **kwargs)
        numbers = checks.train_numbers(side, base)
        out[label] = {k: v for k, v in numbers.items() if k != "_left_out"}
        out[label]["input_mismatches"] = 0  # the reference's own batches
    return out
