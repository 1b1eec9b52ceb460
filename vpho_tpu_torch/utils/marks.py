"""Stage marks: points in a step's device work, timed without making the host wait.

  * ``Clock``: marks on a device's own clock, CUDA timing events on the current stream on a
    card (``external``: events that a graph capture turns into event-record nodes, recorded
    again by every replay), the host clock on the CPU; ``Clock.seconds`` between two.
  * ``stage_mark(name)``: a mark of the step being recorded (``marking``), else nothing.  A
    step that asks for marks (``engine/graphs.py``: ``CapturedStep(..., marked=True)``) is
    recorded on external events while its graph is captured, so the graph times its own stages
    on the device, and on its device's clock while it runs op by op (the CPU, a card's warm-up).
    The predict step marks ``start``, ``trunk`` (after the trunk and the regression's MANO FK),
    ``ode`` (after the ODE and the candidates' MANO FK) and ``end``; with the ``launch`` mark its
    caller takes just before the graph's launch, ``stage_seconds`` reads them as ``STAGES``: the
    launch wait (the device waiting for the host's ``cudaGraphLaunch``), trunk, ODE and
    aggregation.

A leaf module: the models take their marks here without knowing of the engine.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

# (timing key, from mark, to mark) of a marked predict step
STAGES = (("launch_wait_s", "launch", "start"), ("trunk_s", "start", "trunk"),
          ("ode_s", "trunk", "ode"), ("aggregate_s", "ode", "end"))


class Clock:
    """Marks without host waits (module docstring)."""

    def __init__(self, device, external: bool = False):
        self.cuda = torch.device(device).type == "cuda"
        self.external = external

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True, external=self.external)
            e.record()
            return e
        return time.perf_counter()

    @staticmethod
    def seconds(a, b) -> float:
        return a.elapsed_time(b) / 1e3 if isinstance(a, torch.cuda.Event) else b - a


_marking: Optional[Tuple[Dict[str, Any], Clock]] = None     # the marks being recorded


def stage_mark(name: str) -> None:
    """A mark named ``name`` of the step being recorded; nothing outside one."""
    if _marking is not None:
        _marking[0][name] = _marking[1].mark()


@contextlib.contextmanager
def marking(clock: Clock) -> Iterator[Dict[str, Any]]:
    """Record the block's ``stage_mark`` calls on ``clock``, into the dict it yields."""
    global _marking
    prev, _marking = _marking, ({}, clock)
    try:
        yield _marking[0]
    finally:
        _marking = prev


def stage_seconds(marks: Dict[str, Any]) -> Dict[str, float]:
    """The ``STAGES`` that ``marks`` (one call's, read once the device has passed them) hold."""
    return {key: Clock.seconds(marks[a], marks[b]) for key, a, b in STAGES
            if a in marks and b in marks}
