"""launch_wait_ms: the mean of ``evaluate``'s ``launch_wait_s`` over the window's batches after
batch 0, in ms: how long the device waited for the host's launch of the predict graph, from an
event recorded on the stream just before ``cudaGraphLaunch`` to the graph's ``start`` mark.  A
program without the key reads nothing."""
from benchmark.harness import mean_ms


def read(record):
    t = record.get("timing")
    return None if t is None or "launch_wait_s" not in t else mean_ms(t["launch_wait_s"][1:])
