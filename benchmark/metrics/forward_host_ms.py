"""Host time of a training step's forward: the port's ``train.forward`` spans
(``zero_grad`` and the loss's forward dispatch) over the traced slice's
``train.step`` spans, in milliseconds."""

from portbench.spans import span_per_unit


def read(record, metric):
    return span_per_unit(record, metric, "train.forward")
