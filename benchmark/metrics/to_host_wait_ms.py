"""The host's wait for an eval batch's ids (``.cpu()`` waits for the card
to finish the decode): the port's ``eval.to_host`` spans over the traced
slice's ``eval.batch`` spans, in milliseconds."""

from portbench.spans import span_per_unit


def read(record, metric):
    return span_per_unit(record, metric, "eval.to_host")
