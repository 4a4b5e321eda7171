"""Host time of a training step's ``optimizer.step()`` and
``scheduler.step()``: the port's ``train.optimizer`` spans over the traced
slice's ``train.step`` spans, in milliseconds."""

from portbench.spans import span_per_unit


def read(record, metric):
    return span_per_unit(record, metric, "train.optimizer")
