"""The share of the traced slice in which no operation ran on the card:
1 - (kernel intervals merged) / the slice's length, in %."""


def read(record, metric):
    trace = record.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
