"""What a ``--trace 1`` run reads from ``torch.profiler``: kernel time by name, the device's
busy time (the union of its kernels' intervals) over the traced window, and the breakdown the
result line carries (the longest device operations, the longest idle gaps named by what the
host was doing).  Only the events are kept, in memory; no trace file is written.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.autograd import DeviceType


class Traced:
    """``start()`` / ``stop()`` around a steady stretch of the window; ``table()`` after."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.t0 = self.t1 = None

    def start(self):
        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def table(self) -> Dict:
        """{"kernels": {name: [seconds, count]}, "busy_s", "window_s", "breakdown"}."""
        kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        spans: List[Tuple[float, float]] = []
        host: List[Tuple[float, float, str]] = []
        for e in self.prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                k = kernels[e.name]
                k[0] += (end - start) / 1e6
                k[1] += 1
                spans.append((start, end))
            elif e.device_type == DeviceType.CPU:
                host.append((start, end, e.name))
        spans.sort()
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy_s = sum(e - s for s, e in merged) / 1e6
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                       for i in range(len(merged) - 1)), reverse=True)[:10]
        idle = [[_host_at(host, (a + b) / 2), g / 1e6] for g, a, b in gaps]
        top = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
        return {"kernels": dict(kernels), "busy_s": busy_s, "window_s": self.t1 - self.t0,
                "breakdown": {"device_ops": [[n[:160], v[0]] for n, v in top],
                              "idle_gaps": idle}}


def _host_at(host: List[Tuple[float, float, str]], t: float) -> str:
    """The innermost host operation running at time ``t`` (microseconds), or "host idle"."""
    best = None
    for s, e, name in host:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2][:160] if best else "host idle"


def kernel_seconds(table: Dict, needle: str) -> Tuple[float, int]:
    """Summed device seconds and launches of the kernels whose name contains ``needle``."""
    hits = [v for n, v in table["kernels"].items() if needle in n]
    return sum(v[0] for v in hits), sum(int(v[1]) for v in hits)
