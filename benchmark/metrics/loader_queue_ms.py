"""The host's wait on the loader thread's queue: the port's ``data.wait``
spans over the traced slice's train steps or eval batches, in
milliseconds."""

from portbench.spans import span_per_unit


def read(record, metric):
    return span_per_unit(record, metric, "data.wait")
