"""Data parallelism over ranks (counterpart of ``vpho_tpu/parallel/mesh.py``), on
``torch.distributed``.

The JAX package shards every global batch over a 1-D ``data`` mesh inside one jit, so its
batch-norm statistics and gradients are those of the global batch.  The port runs one process
per device (a "rank"); each rank owns a contiguous slice of every global batch and the ranks
meet at a few collectives:

  * ``init_distributed`` brings a rank up: from torchrun's environment, or as one of the ranks
    that ``spawn`` starts for ``--num_devices N`` on one host; nccl for ``cuda``, gloo for the
    CPU.  While no process group is up every helper below is the single-process identity;
  * ``local_rows`` names the rows a rank owns (an eval batch is first padded to a multiple of
    the world, the padding masked by ``_valid``) and ``take_rows`` cuts them from a host batch;
  * ``allreduce_mean_`` averages the gradients over ranks in a few flat buffers;
    ``models/layers.py::BatchNorm2d`` all-reduces its per-channel sums itself;
  * ``allgather_rows`` pools the metric and dump rows (numeric leaves only) and
    ``sync_processes`` is a barrier.

Randomness (the score-loss draws, the dropout masks, the eval ODE start state) is drawn at the
global batch on every rank from the same seed and each rank takes its rows, so N ranks at global
batch B compute what one rank computes at B.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

BUCKET_BYTES = 64 << 20          # the gradient all-reduce's flat buffers


def is_distributed() -> bool:
    """Whether a process group is up: the trainer is then data-parallel over its world."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def is_main() -> bool:
    return rank() == 0


def resolve_num_devices(num_devices: int, device: torch.device) -> int:
    """``--num_devices`` as the JAX package reads it: 0 = every visible card (one process on
    the CPU); more than the visible cards raises."""
    if device.type != "cuda":
        return max(num_devices, 1)
    visible = torch.cuda.device_count()
    n = visible if num_devices <= 0 else num_devices
    if n > visible:
        raise ValueError(f"--num_devices {num_devices}: only {visible} CUDA device(s) visible")
    return n


def init_distributed(device: torch.device, backend: Optional[str] = None,
                     init_method: Optional[str] = None, world: Optional[int] = None,
                     rank_: Optional[int] = None, local_rank: Optional[int] = None
                     ) -> torch.device:
    """Bring this process's rank up; returns the device it binds.

    With ``world`` / ``rank_`` / ``init_method`` given (the ranks ``spawn`` starts) they are
    used; else torchrun's ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` (``env://``).  Without
    either, or at a world of 1 from the environment, the process stays single-process and
    ``device`` is returned as it is.  A rank on ``cuda`` without an index binds
    ``cuda:LOCAL_RANK``.  The backend is nccl for ``cuda`` and gloo for the CPU unless
    ``backend`` says otherwise.  A multi-process request that fails to come up raises: it
    never turns into N copies of a single-process run."""
    if world is None:
        if "WORLD_SIZE" not in os.environ or int(os.environ["WORLD_SIZE"]) <= 1:
            return device
        world, rank_ = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank_))
        init_method = init_method or "env://"
    if rank_ is None or init_method is None:
        raise ValueError("init_distributed: world given without rank_ and init_method")
    local_rank = rank_ if local_rank is None else local_rank
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if is_distributed():
        raise RuntimeError("init_distributed: a process group is already up")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank_,
                            timeout=datetime.timedelta(minutes=30),
                            device_id=device if backend == "nccl" else None)
    return device


def shutdown() -> None:
    if is_distributed():
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank_: int, fn: Callable, world: int, port: int, device: str, backend, args):
    dev = init_distributed(torch.device(device), backend=backend,
                           init_method=f"tcp://localhost:{port}", world=world, rank_=rank_)
    try:
        fn(dev, *args)
    finally:
        shutdown()


def spawn(fn: Callable, world: int, device: torch.device, *args,
          backend: Optional[str] = None) -> None:
    """Run ``fn(device, *args)`` on ``world`` ranks of this host (``torch.multiprocessing``,
    a free localhost port), each with its process group up; returns when all have finished
    and raises if one failed.  ``fn`` and ``args`` must pickle."""
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(fn, world, free_port(), str(device), backend, args),
             nprocs=world, join=True)


def sync_processes() -> None:
    """A barrier (``accel.wait_for_everyone()``)."""
    if is_distributed():
        dist.barrier()


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def local_rows(n: int) -> Tuple[int, int, int]:
    """``(lo, hi, size)``: this rank owns rows ``[lo, hi)`` of a global batch of ``n`` rows
    padded to ``size``, the next multiple of the world."""
    w = world_size()
    size = -(-n // w) * w
    per = size // w
    return rank() * per, (rank() + 1) * per, size


def batch_rows(n_local: int) -> Optional[Tuple[int, int, int]]:
    """``(lo, hi, global_batch)`` of a rank's batch of ``n_local`` rows (every rank holds as
    many), for the draws made at the global batch; None while single-process."""
    if not is_distributed():
        return None
    return rank() * n_local, (rank() + 1) * n_local, world_size() * n_local


def rows_of_global(draw: torch.Tensor, n: int, n_local: int, per_row: int = 1) -> torch.Tensor:
    """This rank's rows of ``draw``, made for a global batch of ``n`` rows (``per_row`` draw
    rows each), after padding it to the world's multiple by repeating the last row's."""
    if not is_distributed():
        return draw
    lo, hi, size = batch_rows(n_local)
    if size > n:
        draw = torch.cat([draw, draw[-per_row:].repeat(size - n, *[1] * (draw.dim() - 1))])
    return draw[lo * per_row:hi * per_row]


def take_rows(batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global host batch (arrays with a leading batch axis).  The batch is
    padded to a multiple of the world by repeating its last row, with ``_valid`` False and
    ``_index`` -1 on the padding (the JAX trainer's ``pad_batch_to`` before ``shard_batch``);
    ``_n`` holds the global batch's size before that padding, the size its draws are made at."""
    if not is_distributed():
        return batch
    n = len(next(iter(batch.values())))
    lo, hi, _ = local_rows(n)
    rows = np.arange(lo, hi)
    pick = np.minimum(rows, n - 1)
    out = {k: np.asarray(v)[pick] for k, v in batch.items()}
    if n % world_size() or "_valid" in batch:
        valid = out.get("_valid", np.ones(len(rows), bool)).astype(bool) & (rows < n)
        out["_valid"] = valid
        if "_index" in out:
            out["_index"] = np.where(rows < n, out["_index"], -1)
    out["_n"] = np.full(len(rows), n)
    return out


def allreduce_mean_(tensors: Sequence[torch.Tensor], bucket_bytes: int = BUCKET_BYTES) -> None:
    """Average ``tensors`` over the ranks in place, packed into flat buffers of about
    ``bucket_bytes`` (one collective a buffer, not one a tensor)."""
    if not is_distributed():
        return
    w = world_size()

    def flush(group: List[torch.Tensor]):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(w)
        at = 0
        for t in group:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()

    group, size = [], 0
    for t in tensors:
        if group and (t.dtype != group[0].dtype or size + t.numel() * t.element_size()
                      > bucket_bytes):
            flush(group)
            group, size = [], 0
        group.append(t)
        size += t.numel() * t.element_size()
    if group:
        flush(group)


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks (a copy); ``t`` itself while single-process."""
    if not is_distributed():
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t / world_size()


def allgather_rows(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Pool every rank's list of ``{name: array}`` rows (``gather_for_metrics``): row i of the
    result is row i of every rank, concatenated along the batch axis in rank order, so the
    pooled rows are those one rank makes from the global batches.  Only numeric leaves cross
    (the JAX package's rule): carry what else a row needs as an index column.  Every rank
    must hold as many rows.  Single-process: the rows as they are."""
    if not is_distributed():
        return rows
    local = [{k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
              for k, v in r.items()} for r in rows]
    local = [{k: v for k, v in r.items() if v.dtype.kind in "biufc"} for r in local]
    gathered: List[Optional[List[Dict[str, np.ndarray]]]] = [None] * world_size()
    dist.all_gather_object(gathered, local)
    if len({len(g) for g in gathered}) != 1:
        raise RuntimeError(f"allgather_rows: the ranks hold {[len(g) for g in gathered]} rows")
    return [{k: np.concatenate([g[i][k] for g in gathered], axis=0) for k in gathered[0][i]}
            for i in range(len(local))]
