"""predict_ms: the mean of ``evaluate``'s ``predict_s`` spans over the window's batches after
batch 0 (CUDA events around the replayed predict step: trunk, ODE with MANO FK, aggregation),
in ms."""
from benchmark.harness import mean_ms


def read(record):
    t = record.get("timing")
    return None if t is None else mean_ms(t["predict_s"][1:])
