"""frame_ms_p50.infer: the median of every frame's time in the window (``evaluate``'s per-batch
host interval after batch 0, one frame a batch), in ms: a steadier statistic beside
``infer_latency_p95_ms``.  Host clock."""
import numpy as np


def read(record):
    t = record.get("timing")
    if t is None or len(t["batch_s"]) < 2:
        return None
    return 1e3 * float(np.median(np.asarray(t["batch_s"][1:])))
