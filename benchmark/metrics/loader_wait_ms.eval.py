"""loader_wait_ms: the mean of ``evaluate``'s ``wait_s`` (host seconds the loop waited for the
staged next batch) over the window's batches after batch 0, in ms."""
from benchmark.harness import mean_ms


def read(record):
    t = record.get("timing")
    return None if t is None else mean_ms(t["wait_s"][1:])
