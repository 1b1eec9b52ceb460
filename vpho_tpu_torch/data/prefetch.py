"""Double-buffered host-to-device input pipeline (counterpart of
``vpho_tpu/data/prefetch.py``).

A background thread assembles the next batch and, on a CUDA device, copies it from pinned
host memory with ``non_blocking`` copies on a side stream while the current batch runs.
The consumer's stream waits on that copy before it reads the batch.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator

import numpy as np
import torch

_SENTINEL = object()


def prefetch(batches: Iterable[Any], transform: Callable[[Any], Any] | None = None,
             depth: int = 2) -> Iterator[Any]:
    """Yield ``transform(b)`` for each batch, computed ``depth`` ahead in a daemon thread.
    An exception in the producer re-raises at the consumer's next pull."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))

    def producer():
        try:
            for b in batches:
                q.put(transform(b) if transform is not None else b)
        except BaseException as e:  # noqa: BLE001 - re-raised at the consumer
            q.put((_SENTINEL, e))
            return
        q.put((_SENTINEL, None))

    threading.Thread(target=producer, daemon=True, name="vpho-prefetch").start()
    while True:
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
            if item[1] is not None:
                raise RuntimeError("prefetch producer failed") from item[1]
            return
        yield item


class DeviceStager:
    """numpy batch -> tensors on ``device``; floats become float32.

    On CUDA each array is pinned and copied with ``non_blocking`` on a side stream; ``stage``
    returns the batch with an event that ``ready`` makes the current stream wait on."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def stage(self, arrays: Dict[str, Any]):
        host = {}
        for k, v in arrays.items():
            v = np.asarray(v)
            host[k] = torch.from_numpy(np.array(v, np.float32 if v.dtype.kind == "f" else v.dtype))
        if self.stream is None:
            return host, None
        with torch.cuda.stream(self.stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True) for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def ready(self, staged):
        """Make the current stream wait for the batch's copies; returns the batch."""
        batch, event = staged
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in batch.values():
                t.record_stream(current)
        return batch
