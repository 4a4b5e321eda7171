"""Host time of the Iterative M4C family's decoder stacks an eval batch (each
quadratic greedy step's run of every decoder layer over the answer prefix:
its dispatch and every wait inside it): the port's ``decode.decoder`` spans
over the traced slice's ``eval.batch`` spans, in milliseconds."""

from portbench.spans import span_per_unit


def read(record, metric):
    return span_per_unit(record, metric, "decode.decoder")
