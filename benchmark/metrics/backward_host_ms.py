"""Host time of a training step's ``loss.backward()``: the port's
``train.backward`` spans over the traced slice's ``train.step`` spans, in
milliseconds."""

from portbench.spans import span_per_unit


def read(record, metric):
    return span_per_unit(record, metric, "train.backward")
