"""Host time of an eval batch's decode positions, the encode apart: the
port's ``decode.step`` spans over the traced slice's ``eval.batch`` spans, in
milliseconds."""

from portbench.spans import span_per_unit


def read(record, metric):
    return span_per_unit(record, metric, "decode.step")
