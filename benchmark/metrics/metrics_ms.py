"""metrics_ms: the mean of ``evaluate``'s ``metrics_s`` spans over the window's batches after
batch 0 (CUDA events around the testers' replayed metric steps), in ms."""
from benchmark.harness import mean_ms


def read(record):
    t = record.get("timing")
    return None if t is None else mean_ms(t["metrics_s"][1:])
