"""Bytes ``BaseTask.put_batch`` sends to the card a batch over the traced
slice: the port's ``data.h2d_bytes`` counter over its ``data.batches``, in
MB (10^6 bytes)."""

from portbench.spans import session


def read(record, metric):
    snapshot = session(record)
    counters = snapshot["counters"] if snapshot else {}
    if not counters.get("data.batches"):
        return None
    return counters.get("data.h2d_bytes", 0) / counters["data.batches"] / 1e6
