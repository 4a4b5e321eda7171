"""The work's share of the card's bf16 peak: the configuration's model FLOPs
per sample of the cell's kind of work (a training step's forward and
backward, or what a greedy answer needs: one encode, then each step's new
row against the cached context; ``benchmark/work/models``) times the rate
the metric moves, over 989 TFLOP/s, in %."""


def read(record, metric):
    rate = record["end_to_end"].get(metric["moves"])
    if not rate:
        return None
    return 100.0 * record["flops_per_sample"] * rate / record["peak_flops"]
