"""The port's kernel entry points in the traced slice, all calls together:
the sum of each call's bound, max(FLOPs / peak, bytes / peak bandwidth) from
its shapes (`benchmark/work/entries`), over the sum of the device time inside
the calls (their backward nodes' for the entries with a backward), in %."""


def read(record, metric):
    trace = record.get("trace")
    if not trace or not trace.get("entries"):
        return None
    bound = device = 0.0
    for entry in trace["entries"].values():
        bound += sum(max(f / record["peak_flops"], b / record["peak_bytes"])
                     for f, b in entry["work"])
        device += entry["device_s"]
    if device <= 0:
        return None
    return 100.0 * bound / device
