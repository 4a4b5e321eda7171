"""Device time of Adam's and the LambdaLR's steps a training step: the
kernels inside the benchmark's host ranges around the task's
``optimizer.step`` and ``scheduler.step`` in the traced slice, over the
steps traced, in milliseconds."""


def read(record, metric):
    trace = record.get("trace")
    if not trace or trace["busy_s"] <= 0 or "optimizer.step" not in trace["range_device_s"]:
        return None
    ranges = trace["range_device_s"]
    total = ranges["optimizer.step"] + ranges.get("scheduler.step", 0.0)
    return 1e3 * total / int(record["traffic"]["traced_steps"])
