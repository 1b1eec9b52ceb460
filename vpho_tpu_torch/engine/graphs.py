"""Captured steps: the counterpart of ``jax.jit``'s cache and dispatch, as CUDA graphs.

The JAX package jits each hot path into one program that the host dispatches once
(``vpho_tpu/engine/trainer.py::make_predict_step``, ``make_candidate_step``; the force loop's
``fori_loop``).  Here the same work is captured once per input signature as a CUDA graph and
replayed with one host launch:

  * ``CapturedStep(fn, name)`` wraps ``fn(*args)``.  Its cache is keyed, like ``jax.jit``'s, by
    the signature of the arguments: the pytree structure, each tensor leaf's shape, dtype and
    device, and every other leaf's value (baked into the graph).  A new signature runs ``fn``
    once eagerly on a side stream (the warm-up: kernels built and loaded, library handles and
    plans made), then captures it into static input buffers; every call copies its tensors into
    those buffers and replays.  The outputs are cloned after the replay, since the next replay
    overwrites the graph's own: a caller may keep them.
  * ``Graph(fn, device, name)`` is one capture of ``fn()`` over tensors that stay put (the
    force loop's state), replayed by ``replay()``.
  * On a CPU tensor a step calls ``fn`` directly: the CPU has no graphs, and the tests run the
    same step functions eagerly.  On a CUDA tensor there is no eager fallback: a capture that
    fails raises and names the line of the port where it failed.
  * Warm-up and capture run under ``torch.cuda.set_sync_debug_mode("error")``, so an operation
    that would wait for the device raises where it is called.
  * The hand-written kernels' tallies (``ops/bank_mlp.py``, ``ops/min_dist.py``,
    ``ops/metric_nn.py``: ``launches`` and ``operations``; ``ops/bn_act.py``: ``launches`` and
    ``bytes_moved``) move only when their Python wrapper runs, which under a graph is at
    capture.  A capture records how far it moved each one and puts them back; every replay adds
    those moves again, so the tallies count the launches that ran.
  * Every capture is logged once (``vpho_torch`` logger, the run's ``info.log``): the step's
    name, the signature, its seconds and the memory its pool reserved.
  * ``capturable(device)`` is the one place that decides whether a step on ``device`` is
    captured: a card without a process group or on an nccl group is; the CPU and a gloo group
    (whose collectives run through the host and cannot join a graph) run eagerly.
  * Stage marks (``utils/marks.py::stage_mark``) of a step that asks for them
    (``CapturedStep(..., marked=True)``, ``Graph(..., marked=True)``: the predict step): a
    capture turns each mark of ``fn`` into an event-record node, kept in ``Graph.marks`` and
    recorded again by every replay.  A step whose graph has a ``start`` mark takes a ``launch``
    mark on the stream just before the replay; ``CapturedStep.marks`` holds the latest call's
    marks, read once the device has passed them (``marks.stage_seconds``).  Such a step run op
    by op (``eager``: the CPU's call, a card's warm-up) takes the same marks on its device's
    clock.  In any other step a mark does nothing.
  * Host spans (``profiling.span``, seen only while a profiler records): ``<name>.copy_in``
    (the arguments' signature and, for a replay, their copy into the graph's inputs), then
    ``<name>.replay`` and ``<name>.clone_out`` of a replayed call, ``<name>.eager`` of an eager
    one.
"""
from __future__ import annotations

import contextlib
import logging
import time
import traceback
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree

from ..ops import bank_mlp as K1
from ..ops import bn_act as K4
from ..ops import metric_nn as K3
from ..ops import min_dist as K2
from ..utils import marks as M
from . import profiling as P

COUNTERS = ((K1, "launches"), (K1, "operations"), (K2, "launches"), (K2, "operations"),
            (K3, "launches"), (K3, "operations"), (K4, "launches"), (K4, "bytes_moved"))
log = logging.getLogger("vpho_torch")


def _tallies() -> List[float]:
    return [getattr(mod, name) for mod, name in COUNTERS]


def _set_tallies(values) -> None:
    for (mod, name), v in zip(COUNTERS, values):
        setattr(mod, name, v)


@contextlib.contextmanager
def no_host_sync():
    """An operation that makes the host wait for the device raises inside the block."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


_TOLD_EAGER = set()


def capturable(device: torch.device) -> bool:
    """Whether steps on ``device`` run as CUDA graphs (module docstring); an eager choice on a
    card is logged once per backend."""
    if torch.device(device).type != "cuda":
        return False
    import torch.distributed as dist

    backend = dist.get_backend() if dist.is_available() and dist.is_initialized() else None
    if backend in (None, "nccl"):
        return True
    if backend not in _TOLD_EAGER:
        _TOLD_EAGER.add(backend)
        log.info(f"the {backend} process group's collectives cannot join a CUDA graph: the "
                 f"train step runs eagerly")
    return False


def _warm(fn: Callable[[], Any], device: torch.device) -> Any:
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side), no_host_sync():
        out = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    return out


def warm_up(fn: Callable[[], Any], device: torch.device, name: str) -> Any:
    """``fn()`` once eagerly on a side stream under ``no_host_sync``, as before a capture
    (kernels built and loaded, library handles, plans and communicators made); returns its
    result.  A failure raises and names the line of the port where it failed."""
    try:
        return _warm(fn, device)
    except Exception as exc:
        raise RuntimeError(f"{name}: CUDA graph warm-up failed at {_where(exc)}: "
                           f"{type(exc).__name__}: {exc}") from exc


def _where(exc: BaseException) -> str:
    """The innermost line of the port in an exception's traceback."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__) if "vpho_tpu_torch" in f.filename
              and not f.filename.endswith("graphs.py")]
    if not frames:
        return "outside the port"
    f = frames[-1]
    return f"{f.filename.split('vpho_tpu_torch/')[-1]}:{f.lineno} `{f.line}`"


class Graph:
    """One CUDA graph of ``fn()``: ``out`` holds its outputs, ``replay()`` runs it again.

    ``fn`` takes no arguments and reads and writes tensors that stay where they are.  With
    ``warm`` (the default) it runs once eagerly on a side stream before the capture.  With
    ``marked``, ``marks`` holds the events of its stage marks, recorded by every replay."""

    def __init__(self, fn: Callable[[], Any], device: torch.device, name: str,
                 warm: bool = True, signature: str = "", marked: bool = False):
        self.name = name
        try:
            if warm:
                _warm(fn, device)
            before = _tallies()
            t0 = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph()
            try:
                # thread_local: the loader's staging thread may pin memory meanwhile
                with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                    reserved = torch.cuda.memory_reserved(device)   # after the cache is emptied
                    with no_host_sync(), (M.marking(M.Clock(device, external=True)) if marked
                                          else contextlib.nullcontext({})) as marks:
                        self.out = fn()
                    self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
            finally:
                after = _tallies()
                _set_tallies(before)            # the capture launched nothing
        except Exception as exc:
            raise RuntimeError(f"{name}: CUDA graph capture failed at {_where(exc)}: "
                               f"{type(exc).__name__}: {exc}") from exc
        self.moves = [a - b for a, b in zip(after, before)]
        self.marks = marks
        self.seconds = time.perf_counter() - t0
        log.info(f"captured {name} [{signature}] in {self.seconds:.2f} s, "
                 f"pool {self.pool_bytes / 1e9:.3f} GB")

    def replay(self) -> None:
        with P.span(f"{self.name}.replay"):
            self.graph.replay()
        _set_tallies([v + d for v, d in zip(_tallies(), self.moves)])


def _leaf_key(leaf):
    if isinstance(leaf, torch.Tensor):
        return ("tensor", tuple(leaf.shape), leaf.dtype, leaf.device)
    return ("value", leaf)


def signature(*args) -> Tuple:
    """The cache key of ``args``: their pytree structure and each leaf's key (module docstring)."""
    leaves, spec = pytree.tree_flatten(args)
    return spec, tuple(_leaf_key(x) for x in leaves)


class CapturedStep:
    """``fn(*args)`` captured once per argument signature and replayed (module docstring);
    ``marked``: ``fn`` takes stage marks, kept per call in ``marks``."""

    def __init__(self, fn: Callable, name: str, marked: bool = False):
        self.fn, self.name, self.marked = fn, name, marked
        self.graphs: Dict[Tuple, Tuple[List[Any], Graph]] = {}
        self.marks: Dict[str, Any] = {}          # the latest call's stage marks

    @staticmethod
    def _flatten(args) -> Tuple[List[Any], Any, Tuple]:
        leaves, spec = pytree.tree_flatten(args)
        return leaves, spec, signature(*args)

    @staticmethod
    def _device(leaves) -> torch.device:
        devices = {x.device for x in leaves if isinstance(x, torch.Tensor)}
        if len(devices) != 1:
            raise ValueError(f"a captured step takes its tensors on one device, got {devices}")
        return devices.pop()

    def capture(self, *args, warm: bool = True) -> None:
        """Capture the graph of ``args``' signature now (no replay); ``warm=False`` when the
        caller has just run ``fn`` eagerly on arguments of this signature (its warm-up)."""
        leaves, spec, key = self._flatten(args)
        dev = self._device(leaves)
        if dev.type != "cuda" or key in self.graphs:
            return
        with torch.inference_mode(False), torch.no_grad():
            static = [x.detach().clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        replica = pytree.tree_unflatten(static, spec)
        paths = pytree.tree_flatten_with_path(args)[0]
        signature = ", ".join(f"{pytree.keystr(p)} {tuple(x.shape)} {str(x.dtype)[6:]}"
                              for p, x in paths if isinstance(x, torch.Tensor))
        graph = Graph(lambda: self.fn(*replica), dev, self.name, warm=warm, signature=signature,
                      marked=self.marked)
        self.graphs[key] = (static, graph)

    def eager(self, device: torch.device, *args):
        """``fn(*args)`` op by op on ``device``; a marked step's stage marks (after a
        ``launch`` mark) on that device's clock."""
        with P.span(f"{self.name}.eager"):
            if not self.marked:
                return self.fn(*args)
            clock = M.Clock(device)
            with M.marking(clock) as marks:
                marks["launch"] = clock.mark()
                out = self.fn(*args)
        self.marks = marks
        return out

    def __call__(self, *args):
        with P.span(f"{self.name}.copy_in"):
            leaves, _, key = self._flatten(args)
            dev = self._device(leaves)
            entry = self.graphs.get(key)
            if entry is not None:
                static, graph = entry
                with torch.no_grad():
                    for s, x in zip(static, leaves):
                        if isinstance(x, torch.Tensor):
                            s.copy_(x)
        if dev.type != "cuda":
            return self.eager(dev, *args)
        if entry is None:                       # a new signature: capture, then replay
            self.capture(*args)
            return self(*args)
        if "start" in graph.marks:
            launch = torch.cuda.Event(enable_timing=True)
            launch.record()
            self.marks = {"launch": launch, **graph.marks}
        graph.replay()
        with P.span(f"{self.name}.clone_out"):
            return pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                                   graph.out)
