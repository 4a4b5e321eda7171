"""Time the loader's thread takes to make one batch (its samples loaded by
the pool, then collated): the port's ``data.batch`` spans of the traced
slice, their mean, in milliseconds."""

from portbench.spans import session


def read(record, metric):
    snapshot = session(record)
    entry = snapshot["names"].get("data.batch") if snapshot else None
    if not entry:
        return None
    return entry["total_ms"] / entry["count"]
