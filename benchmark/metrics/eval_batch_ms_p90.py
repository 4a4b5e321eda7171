"""The 90th percentile, over every batch of the measured window, of the time
from asking the loader for a batch to its answer strings on the host, in
milliseconds (the highest percentile with ten batches or more beyond it in a
window).  The batch count is printed on an earlier line of the run's
output."""


def read(record, metric):
    times = record["window"].get("batch_ms") or []
    if len(times) < 100:
        return None
    ranked = sorted(times)
    rank = 0.9 * (len(ranked) - 1)
    low = int(rank)
    high = min(low + 1, len(ranked) - 1)
    return ranked[low] + (ranked[high] - ranked[low]) * (rank - low)
