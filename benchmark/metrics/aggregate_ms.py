"""aggregate_ms: the mean of ``evaluate``'s ``aggregate_s`` over the window's batches after
batch 0, in ms: the predict graph's span from its ``ode`` mark to its ``end`` mark (the 5-stage
aggregation, with the nearest-vertex kernel).  A program without the key reads nothing."""
from benchmark.harness import mean_ms


def read(record):
    t = record.get("timing")
    return None if t is None or "aggregate_s" not in t else mean_ms(t["aggregate_s"][1:])
