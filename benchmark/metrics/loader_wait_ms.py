"""The host's mean wait for the next batch (the benchmark's clock around
each `next()` of the task's `device_batches` feed) over the measured window,
in milliseconds."""


def read(record, metric):
    waits = record["window"].get("waits") or []
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
