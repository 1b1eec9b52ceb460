"""infer_latency_p95_ms: the 95th percentile of every frame's time in the window, one frame a
batch, one client in a closed loop: ``evaluate``'s per-batch host interval after batch 0
(linear interpolation between order statistics, numpy's default).  Host clock."""
import numpy as np


def read(record):
    t = record.get("timing")
    if t is None or len(t["batch_s"]) < 21:
        return None
    return 1e3 * float(np.percentile(np.asarray(t["batch_s"][1:]), 95))
