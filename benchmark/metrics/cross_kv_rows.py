"""Encoder rows projected to cross-attention keys and values an eval batch:
the port's ``decode.cross_kv_rows`` counter over the traced slice, over its
``eval.batch`` spans (a checkout whose port has no such counter gives
None).  The quadratic greedy projects every decoder layer's again at each
step: steps x layers x batch x encoder rows."""

from portbench.spans import per_unit


def read(record, metric):
    return per_unit(record, metric, lambda snapshot: snapshot["counters"].get(
        "decode.cross_kv_rows"))
