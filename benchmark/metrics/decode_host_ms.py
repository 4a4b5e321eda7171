"""Host time of an eval batch's decode (``greedy_ids`` or ``generate``: its
dispatch and every wait inside it): the port's ``eval.decode`` spans over the
traced slice's ``eval.batch`` spans, in milliseconds."""

from portbench.spans import span_per_unit


def read(record, metric):
    return span_per_unit(record, metric, "eval.decode")
