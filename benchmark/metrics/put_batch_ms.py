"""Host time of ``BaseTask.put_batch`` (a batch's arrays to the card): the
port's ``data.put_batch`` spans over the traced slice's train steps or eval
batches, in milliseconds."""

from portbench.spans import span_per_unit


def read(record, metric):
    return span_per_unit(record, metric, "data.put_batch")
