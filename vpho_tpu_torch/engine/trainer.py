"""Training and evaluation engine (counterpart of ``vpho_tpu/engine/trainer.py``).

``Trainer(cfg, device)`` builds the constants and, in ``init_state``, the model (seeded
weights, then ``--imagenet_pretrain`` and ``--pretrain``), the optimizer when it is given the
epoch's step count, and the ``--checkpoint`` state.

Training: ``train_step`` is one forward (``forward_train``, the BN statistics move), backward
and optimizer update; ``train_one_epoch`` runs it over a stream, its draws and dropout masks
from a generator seeded 1000 + epoch.  On a card (without a process group or on an nccl one)
the step is ``make_train_step``'s CUDA graphs, replayed (``TrainStep``); the CPU and gloo
groups run it op by op.  The optimizer is the JAX trainer's optax chain
(``make_optimizer``): AdamW (decoupled decay 1e-4) or L2-coupled Adam (5e-4), the global-norm
clip before the decay, ``MultiSteps`` accumulation, and the per-epoch ``exp`` / ``step`` or
per-step ``cosine`` schedule (``make_lr_schedule``), whose step counts applied updates.
``save_checkpoint`` writes ``<run>/checkpoint/epoch_N.state`` (the port's own torch payload:
params, BN statistics, buffers, optimizer state, step) and ``save_model`` the JAX package's
``final_model.pkl``.

Evaluation: ``evaluate`` runs the predict path and the metric suite over an eval stream,
``dump_predictions`` writes the prediction pkl and ``infer_candidates`` dumps the raw
hypothesis sets.  Batches are host (numpy) dicts; a background thread stages the next one on
the device while the current one runs.  Host keys: ``_valid`` masks padded tail samples out of
the metrics and the dump, ``_index`` (with ``path_of``) fills the dump's index and path
columns.  The ODE start state of batch i is ``x0_for(i, batch_size)`` when given, else a draw
from a ``torch.Generator`` seeded 128 + i on the device.  The metrics stay on the device until
the report; each batch makes one host transfer, for the prediction dump.  The predict and
candidate paths go through ``make_predict_step`` and ``make_candidate_step``, the metrics
through the testers' steps and the device preprocess through its own: on the card each is a
CUDA graph per batch signature, replayed with one launch (``engine/graphs.py``).

With ``--device_preprocess`` the loaders ship decoded frames and the batch's pixel work
(crop, colour augmentation, erasing, heatmaps) runs on the device when the batch is staged
(``data/device_pipeline.py``); a train epoch draws its erase noise from a generator seeded
0x5A5A0000 + epoch.  ``infer_ho3d`` is HO3D's codalab inference: object metrics, the
regression and the aggregated hands in the OpenGL frame as two zips in ``evaluation.txt``
order, and the prediction pkl.

Data parallelism (``parallel/mesh.py``): while a process group is up every rank holds its slice
of each global batch (the loaders build only those rows).  A train step draws its randomness at
the global batch and takes its rows, its batch norm uses the global statistics, and the
gradients are averaged over ranks before the optimizer, so every rank applies the global
batch's update.  An eval batch's ODE start state is drawn the same way; the metric and dump
rows are pooled across ranks before the report, padding masked by ``_valid``.  Rank 0 writes
the log, checkpoints, ``final_model.pkl``, the pkls, viz and zips; the others wait for it.

The JAX package's orbax ``epoch_N.state`` directories are read through ``orbax_to_torch.py``
(at the checkout's root, where JAX is installed), which writes the port's own file.
"""
from __future__ import annotations

import datetime
import itertools
import logging
import os
import pickle
import re
import sys
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..configs.config import Config
from ..data.device_pipeline import make_device_preprocess
from ..data.prefetch import DeviceStager, prefetch
from ..models import anchor as anchor_lib
from ..models import vpho as V
from ..diffusion.sampler import draw_score_noise
from ..models.layers import DropoutMasks
from ..parallel import mesh
from ..utils import transforms as T
from ..utils.marks import STAGES, Clock, stage_mark, stage_seconds
from ..utils.platform import resolve_device
from . import viz
from . import graphs as G
from .graphs import CapturedStep
from .profiling import param_count, span, trace
from .tester import TesterHand, TesterObject

X0Fn = Callable[[int, int], torch.Tensor]
SCORE_DIMS = (("hand", 96), ("obj", 9))     # the score losses' pose widths: rot6d MANO, 9-d object
_F32 = np.float32


def make_lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """step -> learning rate, in float32 arithmetic as the JAX package's schedules.  ``exp``
    and ``step`` decay per epoch of ``steps_per_epoch`` steps; ``cosine`` is optax's
    ``warmup_cosine_decay_schedule`` (from base/25 up to base over the first 10% of the steps,
    then a cosine down to base/1e4).  The step is the count of applied updates."""
    base = _F32(cfg.base_learning_rate)
    if cfg.scheduler == "exp":
        return lambda step: float(base * _F32(cfg.gamma) ** _F32(step // steps_per_epoch))
    if cfg.scheduler == "step":
        return lambda step: float(
            base * _F32(cfg.gamma) ** _F32(step // steps_per_epoch // cfg.lr_step))
    if cfg.scheduler == "cosine":
        total = cfg.max_epochs * steps_per_epoch
        warm = max(int(total * 0.1), 1)
        if total - warm <= 0:
            raise ValueError(f"cosine schedule: {total} steps leave no decay after a "
                             f"{warm}-step warm-up")
        init, end = base / _F32(25.0), base / _F32(1e4)
        alpha = end / base

        def sched(step: int) -> float:
            if step < warm:
                frac = _F32(1.0) - _F32(min(max(step, 0), warm)) / _F32(warm)
                return float((init - base) * frac + base)
            count = _F32(min(step - warm, total - warm))
            cosine = _F32(0.5) * (_F32(1.0) + np.cos(_F32(np.pi) * count / _F32(total - warm)))
            return float(base * ((_F32(1.0) - alpha) * cosine + alpha))

        return sched
    raise ValueError(cfg.scheduler)


class Optimizer:
    """The JAX trainer's optax chain over a model's parameters, updated in place:

      adamw: [clip_by_global_norm] -> scale_by_adam -> add_decayed_weights(1e-4) -> -lr
      adam:  [clip_by_global_norm] -> add_decayed_weights(5e-4) -> scale_by_adam -> -lr
             (L2-coupled, as ``torch.optim.Adam(weight_decay=5e-4)``)

    b1 0.9, b2 0.999, eps 1e-8, every parameter decayed.  With ``every`` > 1 it is
    ``optax.MultiSteps``: the running mean of ``every`` gradients is applied on every
    ``every``-th call and the calls between leave the parameters as they are.  ``count``
    counts applied updates; it sets the bias corrections and the schedule's step.

    A call is host bookkeeping, ``advance``, then device work that never waits for the device,
    so a CUDA graph can capture it: ``accumulate`` (MultiSteps' running mean) and ``apply``.
    The numbers that change from call to call, the accumulation divisor, the two bias
    corrections and the learning rate, are computed on the host as before (``_corrections``, in
    float32 as optax) and copied by ``advance`` into ``scalars``, a float32 tensor on the
    parameters' device that the device work reads.  The clip's branch is taken on the device:
    the gradients are divided by ``where(norm < clip, 1, norm)`` and multiplied by
    ``where(norm < clip, 1, clip)``, which is optax's ``where(norm < clip, g, g / norm * clip)``
    (a NaN norm divides) bit for bit."""

    b1, b2, eps = 0.9, 0.999, 1e-8
    DIVISOR, BC1, BC2, LR = range(4)            # the entries of ``scalars``

    def __init__(self, params: Dict[str, torch.Tensor], kind: str,
                 schedule: Callable[[int], float], clip: float = -1.0, every: int = 1):
        if kind not in ("adamw", "adam"):
            raise ValueError(kind)
        self.names = list(params)
        self.params = [params[k] for k in self.names]
        self.kind, self.schedule, self.clip, self.every = kind, schedule, clip, every
        zeros = lambda: [torch.zeros_like(p) for p in self.params]
        self.mu, self.nu = zeros(), zeros()
        self.acc = zeros() if every > 1 else None
        self.count = 0
        self.mini_step = 0
        self.scalars = torch.ones(4, dtype=torch.float32, device=self.params[0].device)

    def advance(self) -> bool:
        """The host's part of a call: MultiSteps' position and, on a boundary, the update
        count; the call's numbers into ``scalars`` (a copy that waits for nothing).  Returns
        whether the call applies an update."""
        divisor = float(self.mini_step + 1)
        self.mini_step += 1
        applies = self.mini_step >= self.every
        if applies:
            self.mini_step = 0
            self.count += 1
        bc1, bc2, lr = self._corrections() if applies else (1.0, 1.0, 0.0)
        host = torch.tensor([divisor, bc1, bc2, lr], dtype=torch.float32)
        if self.scalars.is_cuda:
            host = host.pin_memory()     # the host allocator keeps it until the copy has run
        self.scalars.copy_(host, non_blocking=True)
        return applies

    @torch.no_grad()
    def accumulate(self, grads: Sequence[torch.Tensor]) -> None:
        """MultiSteps' running mean: acc += (g - acc) / (calls since the last update)."""
        step = torch._foreach_sub(list(grads), self.acc)
        torch._foreach_div_(step, self.scalars[self.DIVISOR])
        torch._foreach_add_(self.acc, step)

    @torch.no_grad()
    def update(self, grads: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
        """optax's update of ``grads`` (the accumulated mean when None, which is then zeroed in
        place for the next cycle), at the numbers ``advance`` put in ``scalars``."""
        g = self.acc if grads is None else list(grads)
        if self.clip > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            keep = norm < self.clip
            g = torch._foreach_div(g, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(g, torch.where(keep, 1.0, self.clip))
        if self.kind == "adam":
            g = torch._foreach_add(g, self.params, alpha=5e-4)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(g, g), alpha=1.0 - self.b2)
        bc1, bc2, lr = (self.scalars[i] for i in (self.BC1, self.BC2, self.LR))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(u, denom)
        if self.kind == "adamw":
            torch._foreach_add_(u, self.params, alpha=1e-4)
        torch._foreach_mul_(u, -lr)
        if grads is None:
            torch._foreach_zero_(self.acc)
        return u

    @torch.no_grad()
    def apply(self, grads: Optional[Sequence[torch.Tensor]] = None) -> None:
        """The parameters moved by ``update(grads)``."""
        torch._foreach_add_(self.params, self.update(grads))

    @torch.no_grad()
    def updates(self, grads: Sequence[torch.Tensor]) -> Optional[List[torch.Tensor]]:
        """optax's ``update``: what to add to the parameters, or None between accumulation
        boundaries."""
        applies = self.advance()
        if self.acc is not None:
            self.accumulate(grads)
        if not applies:
            return None
        return self.update(None if self.acc is not None else grads)

    def _corrections(self):
        """The bias corrections and learning rate of the update being applied (``count``
        already counts it): the corrections in float32, as optax computes them."""
        bc1 = float(_F32(1.0) - _F32(self.b1) ** _F32(self.count))
        bc2 = float(_F32(1.0) - _F32(self.b2) ** _F32(self.count))
        return bc1, bc2, self.schedule(self.count - 1)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        """Apply one call's update; returns whether the parameters moved."""
        u = self.updates(grads)
        if u is not None:
            torch._foreach_add_(self.params, u)
        return u is not None

    def state_dict(self) -> Dict[str, Any]:
        named = lambda ts: None if ts is None else dict(zip(self.names, ts))
        return {"mu": named(self.mu), "nu": named(self.nu), "acc": named(self.acc),
                "count": self.count, "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for key in ("mu", "nu", "acc"):
            mine, saved = getattr(self, key), state[key]
            if (mine is None) != (saved is None):
                raise ValueError(f"optimizer state {key}: saved with another "
                                 f"--gradient_accumulation_steps")
            for name, t in zip(self.names, mine or ()):
                t.copy_(saved[name])
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])


def make_optimizer(cfg: Config, params: Dict[str, torch.Tensor],
                   steps_per_epoch: int) -> Optimizer:
    """``--optimizer`` over ``params`` with ``--gradient_clip`` and
    ``--gradient_accumulation_steps``, on ``make_lr_schedule``'s schedule."""
    return Optimizer(params, cfg.optimizer, make_lr_schedule(cfg, steps_per_epoch),
                     clip=cfg.gradient_clip, every=max(cfg.gradient_accumulation_steps, 1))


def make_predict_step(model: V.VPHONet, ctx: V.VPHOContext) -> CapturedStep:
    """The predict step (the JAX trainer's ``make_predict_step``): ``step(batch, x0)`` is
    ``forward_predict`` with the ODE start state as an input, captured as a CUDA graph once per
    batch signature on the card and replayed (``engine/graphs.py``), called eagerly on the CPU.
    Its outputs are the caller's: a later call does not overwrite them.  Its stage marks,
    ``start`` and ``end`` around ``forward_predict`` and ``trunk`` and ``ode`` inside it, time
    the trunk, the ODE and the aggregation in the graph (``utils/marks.py::STAGES``)."""
    def predict(batch, x0):
        stage_mark("start")
        pd = V.forward_predict(model, ctx, batch, x0=x0)
        stage_mark("end")
        return pd

    return CapturedStep(predict, "predict_step", marked=True)


def make_candidate_step(model: V.VPHONet, ctx: V.VPHOContext) -> CapturedStep:
    """The candidate step (the JAX trainer's ``make_candidate_step``, ``--mode
    infer_candidate``): ``step(batch, x0)`` is ``forward_candidates``' hypotheses without the
    aggregation, captured and replayed as ``make_predict_step``."""
    return CapturedStep(lambda batch, x0: V.forward_candidates(model, ctx, batch, x0=x0)[0],
                        "candidate_step")


def _gradients(total: torch.Tensor, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The gradients of ``total`` (zeros where a parameter has none), averaged over the ranks."""
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    mesh.allreduce_mean_(grads)
    return grads


class TrainStep:
    """The train step as CUDA graphs (the JAX trainer's ``make_train_step``, a jit of forward,
    backward and the optax update): ``step(batch, generator)`` is one optimizer call on a device
    batch, returning the weighted losses; what it does is ``Trainer.train_step``'s eager step.

    Graph A is ``forward_train``, the gradients, their all-reduce over an nccl group, and then
    the update (``every`` 1) or MultiSteps' accumulation; graph B, with accumulation, is the
    update of the accumulated mean, replayed on the calls that apply one.  A's first call of a
    batch signature is its warm-up: the eager step on a side stream (``graphs.warm_up``), its
    dropout masks and score-loss draws taken from ``generator`` (or given); A is then captured
    with those masks' shapes as static inputs (a second signature is logged: it costs a second
    pool of the activations' size).  Before every later call the masks and draws are taken
    from ``generator`` in the eager step's order (the masks in the order the warm-up drew
    them, then the hand's and the object's draws), so a replay sees what an eager step would
    see.  The optimizer's varying numbers are in ``Optimizer.scalars``, written by ``advance``
    on the host before the replay; the MultiSteps branch stays on the host, which knows the
    count."""

    def __init__(self, model: V.VPHONet, ctx: V.VPHOContext, optimizer: "Optimizer"):
        self.model, self.ctx, self.opt = model, ctx, optimizer
        self.device = optimizer.params[0].device
        self.graph = G.CapturedStep(self._device_step, "train_step")
        self.apply_graph: Optional[G.Graph] = None
        self.mask_shapes: Dict[Any, List[tuple]] = {}     # batch signature -> the masks drawn
        self.keys: List[str] = []                         # the losses' names, in order

    def _device_step(self, batch, masks, draws, generator=None) -> torch.Tensor:
        """One call's device work (graph A): the weighted losses stacked.  ``masks`` and
        ``draws`` None: drawn from ``generator`` (the warm-up), the masks kept in
        ``self._drawn``."""
        rows = mesh.batch_rows(int(batch["rgb"].shape[0]))
        dropout = DropoutMasks(masks=masks, generator=generator, rows=rows)
        total, losses = V.forward_train(self.model, self.ctx, batch, draws=draws,
                                        dropout=dropout, generator=generator, rows=rows)
        grads = _gradients(total, self.opt.params)
        if self.opt.acc is not None:
            self.opt.accumulate(grads)
        else:
            self.opt.apply(grads)
        self.keys, self._drawn = list(losses), dropout.drawn
        return torch.stack([v.detach().float() for v in losses.values()])

    def draw_masks(self, shapes: Sequence[tuple], generator: torch.Generator):
        """A call's dropout masks of ``shapes`` from ``generator``: the eager step draws them
        first, in this order."""
        keep = DropoutMasks().keep
        return [DropoutMasks.draw(shape, keep, generator, self.device) for shape in shapes]

    def draw_score(self, n: int, generator: torch.Generator) -> V.Draws:
        """A call's score-loss draws for a batch of ``n`` (the global batch on a rank), drawn
        after the masks, the hand's first."""
        R, sde = self.ctx.cfg.repeat_num, self.ctx.sde
        return {name: draw_score_noise(R * n, dim, sde, generator, self.device)
                for name, dim in SCORE_DIMS}

    def __call__(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                 masks: Optional[Sequence[torch.Tensor]] = None,
                 draws: Optional[V.Draws] = None) -> Dict[str, torch.Tensor]:
        """One call; ``masks`` (global, in call order) and ``draws`` (both losses') given in
        place of ``generator``'s are copied into the graph's inputs as they are."""
        with torch.inference_mode(False), torch.enable_grad():
            with span("train.advance"):
                n = (mesh.batch_rows(int(batch["rgb"].shape[0])) or (len(batch["rgb"]),))[-1]
                key = G.signature(batch)
                applies = self.opt.advance()
            if key in self.mask_shapes:
                with span("train.draws"):
                    if masks is None:
                        masks = self.draw_masks(self.mask_shapes[key], generator)
                    if draws is None:
                        draws = self.draw_score(n, generator)
                with span("train.replay"):
                    losses = self.graph(batch, list(masks), draws)
            else:
                losses = G.warm_up(lambda: self._device_step(batch, masks, draws, generator),
                                   self.device, "train_step")
                static_masks = [m.clone() for m in self._drawn]
                self.mask_shapes[key] = [tuple(m.shape) for m in static_masks]
                if len(self.mask_shapes) > 1:
                    G.log.warning(f"train_step: a batch signature of {n} rows after "
                                  f"{len(self.mask_shapes) - 1} others: its capture takes "
                                  f"another pool of the activations' size")
                R = self.ctx.cfg.repeat_num
                static_draws = draws or {name: (torch.ones(R * n, 1, device=self.device),
                                                torch.zeros(R * n, dim, device=self.device))
                                         for name, dim in SCORE_DIMS}
                self.graph.capture(batch, static_masks, static_draws, warm=False)
            if applies and self.opt.acc is not None:
                if self.apply_graph is None:      # its warm-up applies this call's update
                    self.apply_graph = G.Graph(self.opt.apply, self.device, "train_apply",
                                               signature="the accumulated mean")
                else:
                    self.apply_graph.replay()
        return dict(zip(self.keys, losses.unbind()))


def make_train_step(model: V.VPHONet, ctx: V.VPHOContext, optimizer: "Optimizer") -> TrainStep:
    """The train step (the JAX trainer's ``make_train_step``) over ``optimizer``'s parameters,
    replayed as CUDA graphs (``TrainStep``)."""
    return TrainStep(model, ctx, optimizer)


def _split_state(model: torch.nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """The model's state_dict as the JAX package's three collections."""
    params = {k for k, _ in model.named_parameters()}
    out = {"params": {}, "batch_stats": {}, "buffers": {}}
    for k, v in model.state_dict().items():
        coll = "params" if k in params else "batch_stats" if k.endswith(
            ("running_mean", "running_var", "num_batches_tracked")) else "buffers"
        out[coll][k] = v
    return out


def setup_logger(save_dir: str, name: str = "vpho_torch", main: bool = True) -> logging.Logger:
    """File (``<save_dir>/info.log``) and console logging; on a rank other than the main one,
    warnings to the console only."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO if main else logging.WARNING)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if main:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, "info.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def postprocess_obj_rt(pose9d: torch.Tensor, root_joint: torch.Tensor) -> torch.Tensor:
    """Wrist-relative (B, ..., 9) pose -> camera-frame (B, ..., 3, 4) rt."""
    rt = T.obj_9d_to_mat(pose9d)
    root = root_joint.reshape((root_joint.shape[0],) + (1,) * (rt.dim() - 3) + (3,))
    return torch.cat([rt[..., :3], rt[..., 3:] + root[..., None]], dim=-1)


def postprocess_hand_vert(vert: torch.Tensor, root_joint: torch.Tensor,
                          is_right: torch.Tensor) -> torch.Tensor:
    """Unflip left hands and move from wrist-relative to the camera frame."""
    vert = T.flip_point3d(vert, ~is_right)
    return vert + root_joint.reshape((root_joint.shape[0],) + (1,) * (vert.dim() - 2) + (3,))


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One device-to-host copy for 4-byte tensors: packed as int32 words, split on the host."""
    flat = torch.cat([t.contiguous().view(torch.int32).reshape(-1) for t in tensors.values()])
    words = flat.cpu().numpy()
    out, at = {}, 0
    for k, t in tensors.items():
        n = t.numel()
        out[k] = words[at:at + n].view(np.float32 if t.is_floating_point() else np.int32
                                       ).reshape(tuple(t.shape))
        at += n
    return out


def _filter_rows(rows, path_of, keep_index: bool = False):
    """Drop padded samples; turn the ``_index`` column into ``index`` (and ``path``), always
    with ``keep_index``, else when every kept sample has one."""
    filtered = []
    for r in rows:
        keep = np.asarray(r.pop("_valid"), bool)
        idx = np.asarray(r.pop("_index"))[keep]
        row = {k: np.asarray(v)[keep] for k, v in r.items()}
        has_index = bool((idx >= 0).all())
        if has_index or keep_index:
            row["index"] = idx
        if has_index and path_of is not None:
            row["path"] = [path_of(int(j)) for j in idx]
        filtered.append(row)
    return filtered


def format_table(table: Dict[str, Dict[str, Any]]) -> str:
    """A {row: {column: value}} report as aligned text, one line per row."""
    cols = list(dict.fromkeys(c for row in table.values() for c in row))
    cells = [[""] + cols] + [[str(k)] + [str(row.get(c, "")) for c in cols]
                             for k, row in table.items()]
    widths = [max(len(r[i]) for r in cells) for i in range(len(cols) + 1)]
    return "\n".join("  ".join(c.rjust(w) for c, w in zip(r, widths)) for r in cells)


class _Staged(NamedTuple):
    batch: Dict[str, torch.Tensor]
    valid: np.ndarray
    index: np.ndarray
    global_n: Optional[int]             # a data-parallel rank's global batch size, else None
    wait_s: float                       # host seconds waiting for the loader
    pre_span: Optional[tuple]           # the device preprocess's clock marks, or None


class Trainer:
    """Train / eval / infer runner (the JAX package's ``Trainer``)."""

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.checkpoint and os.path.isdir(cfg.checkpoint):
            raise NotImplementedError(
                f"--checkpoint {cfg.checkpoint}: an orbax checkpoint directory of the JAX "
                f"package, which the port does not read.  Convert it where JAX is installed: "
                f"python orbax_to_torch.py {cfg.checkpoint} <out>/epoch_N.state, then pass "
                f"the file to --checkpoint")
        if mesh.world_size() > 1 and cfg.cross_attention_axis == "batch":
            raise NotImplementedError(
                "--cross_attention_axis batch attends across the samples of a batch, and a "
                "data-parallel rank holds only its slice: run it on one device")
        T.set_quat_mean_impl(cfg.quat_mean_impl)
        stamp = mesh.broadcast_object(datetime.datetime.now().strftime("%Y%m%d-%H%M%S"))
        self.save_dir = os.path.join(cfg.output_dir,
                                     f"{stamp}_{cfg.mark}_{cfg.mode}_{cfg.model}")
        self.logger = setup_logger(self.save_dir, main=mesh.is_main())
        self.ctx = V.make_context(cfg.to_model_config(), cfg.mano_root or None,
                                  cfg.models_dir or None, device=self.device)
        self.tester_hand_keys = ("regression", "one_candidate", "agg_candidate")
        self.start_epoch = 0
        if cfg.checkpoint:
            m = re.search(r"epoch_(\d+)\.state", cfg.checkpoint)
            if m:
                self.start_epoch = int(m.group(1))
        self.model: Optional[V.VPHONet] = None
        self._steps: Dict[str, tuple] = {}    # kind -> ((model, optimizer), its captured step)
        self._preprocess: Dict[bool, Callable] = {}   # is_train -> the device preprocess
        self.optimizer: Optional[Optimizer] = None
        self.step = 0                                       # train_step calls so far
        self._clock = Clock(self.device)
        self._train_marks: List[tuple] = []
        self.last_train: Optional[Dict[str, Any]] = None   # the latest epoch's timing
        self._trace_done = False
        self._told_no_jpg = False
        self.last_eval: Optional[Dict[str, Any]] = None     # the latest evaluate()'s output
        self.eval_dataset = None        # real data: the eval split, whose get_path fills 'path' 

    # -- weights -----------------------------------------------------------------------

    def init_state(self, steps_per_epoch: Optional[int] = None):
        """The model with seeded weights (``--random_seed``, else 206), then the ResNet-50 of
        ``--imagenet_pretrain`` when the file exists, then ``--pretrain`` (a reference ``.pth``
        or the JAX package's ``final_model.pkl``);
        with ``steps_per_epoch`` (training) also the optimizer; then ``--checkpoint``."""
        cfg = self.cfg
        self.model = V.build_model(cfg.to_model_config(), seed=cfg.random_seed or 206,
                                   device=self.device,
                                   cross_attention_axis=cfg.cross_attention_axis)
        if cfg.imagenet_pretrain and os.path.exists(cfg.imagenet_pretrain):
            from ..utils.weights import load_resnet50_into_backbone, load_torch_file

            load_resnet50_into_backbone(self.model, load_torch_file(cfg.imagenet_pretrain))
            self.logger.info(f"Initialized backbone from {cfg.imagenet_pretrain}")
        if cfg.pretrain:
            from ..utils.weights import load_pretrain

            rep = load_pretrain(self.model, cfg.pretrain, cfg.remove_pretrained_keys)
            for k in rep["missing"]:
                self.logger.warning(f"pretrain: missing key {k}")
            for k in rep["unconsumed"][:20]:
                self.logger.warning(f"pretrain: unconsumed key {k}")
            self.logger.info(f"Loaded pretrain {cfg.pretrain}: {len(rep['imported'])} imported, "
                             f"{len(rep['missing'])} missing, {len(rep['unconsumed'])} unconsumed")
        self.logger.info(f"Model params: {param_count(self.model) / 1e6:.2f}M")
        if steps_per_epoch is not None:
            self.optimizer = make_optimizer(cfg, dict(self.model.named_parameters()),
                                            steps_per_epoch)
        if cfg.checkpoint:
            self.load_checkpoint(cfg.checkpoint)

    def save_checkpoint(self, epoch: int) -> str:
        """``<run>/checkpoint/epoch_N.state``: params, BN statistics, buffers, optimizer state
        and step."""
        path = os.path.join(self.save_dir, "checkpoint", f"epoch_{epoch}.state")
        if mesh.is_main():
            os.makedirs(os.path.dirname(path), exist_ok=True)
            opt = self.optimizer.state_dict() if self.optimizer is not None else None
            torch.save({**_split_state(self.model), "opt_state": opt, "step": self.step}, path)
            self.logger.info(f"Saved checkpoint: {path}")
        mesh.sync_processes()
        return path

    def load_checkpoint(self, path: str) -> None:
        """Restore a ``save_checkpoint`` file; the optimizer state only when training."""
        payload = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict({**payload["params"], **payload["batch_stats"],
                                    **payload["buffers"]}, strict=True)
        if self.optimizer is not None:
            if payload["opt_state"] is None:
                raise ValueError(f"{path} holds no optimizer state")
            self.optimizer.load_state_dict(payload["opt_state"])
        self.step = int(payload["step"])
        self.logger.info(f"Loaded checkpoint: {path}")

    def save_model(self) -> str:
        """``<run>/final_model.pkl`` in the JAX package's layout (its Flax trees as numpy)."""
        from ..utils.weights import save_final_model

        path = os.path.join(self.save_dir, "final_model.pkl")
        if mesh.is_main():
            save_final_model(self.model, path)
            self.logger.info(f"Saved final model: {path}")
        mesh.sync_processes()
        return path

    # -- training ----------------------------------------------------------------------

    def train_step(self, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[V.Draws] = None,
                   dropout: Optional[DropoutMasks] = None,
                   eager: bool = False) -> Dict[str, torch.Tensor]:
        """One step on a device batch: ``forward_train`` (the BN statistics move), the
        gradients of the total loss, the optimizer.  Draws and dropout masks as
        ``forward_train`` takes them (at the global batch on a data-parallel rank, whose
        gradients are then averaged over the ranks).  Returns this rank's weighted losses,
        detached.

        Where ``graphs.capturable`` says so (a card without a process group or on an nccl
        group) the step is ``make_train_step``'s replayed graphs, timed as one span; ``eager``
        (and the CPU and a gloo group) runs it op by op, timed in forward, backward and
        optimizer spans."""
        m0 = self._clock.mark()
        if G.capturable(self.device) and not eager:
            if dropout is not None and dropout.given is None:
                raise ValueError("the captured train step takes dropout masks given as "
                                 "DropoutMasks(masks=...), or draws them from generator")
            losses = self._step("train")(batch, generator,
                                         None if dropout is None else dropout.given, draws)
            self._train_marks.append((m0, self._clock.mark()))
            self.step += 1
            return losses
        params = self.optimizer.params
        rows = mesh.batch_rows(int(batch["rgb"].shape[0]))
        total, losses = V.forward_train(self.model, self.ctx, batch, draws=draws,
                                        dropout=dropout, generator=generator, rows=rows)
        m1 = self._clock.mark()
        grads = _gradients(total, params)
        m2 = self._clock.mark()
        self.optimizer.step(grads)
        self._train_marks.append((m0, m1, m2, self._clock.mark()))
        self.step += 1
        return {k: v.detach() for k, v in losses.items()}

    def train_timing(self) -> Dict[str, List[float]]:
        """Seconds per ``train_step`` since the last call (device-stream spans on a GPU): the
        whole step, and forward, backward and optimizer of the eager steps."""
        marks, self._train_marks = self._train_marks, []
        sec = self._clock.seconds
        eager = [m for m in marks if len(m) == 4]
        return {"step_s": [sec(m[0], m[-1]) for m in marks],
                "forward_s": [sec(a, b) for a, b, _, _ in eager],
                "backward_s": [sec(b, c) for _, b, c, _ in eager],
                "optimizer_s": [sec(c, d) for _, _, c, d in eager]}

    def train_one_epoch(self, epoch: int, batches: Iterable[Dict[str, Any]],
                        steps_per_epoch: int) -> Dict[str, torch.Tensor]:
        """``train_step`` over a host stream, logging the losses every ``--print_freq`` steps.
        Returns the last step's losses; ``last_train`` keeps the epoch's time, per-step spans
        and last losses (as floats)."""
        gen = torch.Generator(device=self.device).manual_seed(1000 + epoch)
        noise_gen = torch.Generator(device=self.device).manual_seed(0x5A5A0000 + epoch)
        t0 = time.perf_counter()
        last: Dict[str, torch.Tensor] = {}
        pre_spans, waits = [], []
        for i, st in enumerate(self._staged(batches, is_train=True, generator=noise_gen)):
            pre_spans.append(st.pre_span)
            waits.append(st.wait_s)
            last = self.train_step(st.batch, generator=gen)
            if i % max(self.cfg.print_freq, 1) == 0:
                with span("train.log", i):
                    vals = mesh.mean_over_ranks(torch.stack([v.float() for v in last.values()])
                                                ).cpu().tolist()
                    self.logger.info(f"[{i:04d}/{steps_per_epoch}] " + " ".join(
                        f"{k.replace('_loss', '')}:{v:.2e}" for k, v in zip(last, vals)))
        with span("train.epoch_end", epoch):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            seconds = time.perf_counter() - t0
            timing = self.train_timing()
            losses = dict(zip(last, mesh.mean_over_ranks(
                torch.stack([v.float() for v in last.values()])).cpu().tolist()))
        split = {k: 1e3 * sum(v) / max(len(v), 1) for k, v in timing.items() if v}
        self.last_train = {"seconds": seconds, "steps": len(timing["step_s"]),
                           "losses": losses, **timing, "wait_s": waits,
                           "preprocess_s": [self._clock.seconds(*sp) if sp else 0.0
                                            for sp in pre_spans]}
        self.logger.info(f"Epoch {epoch} done in {seconds:.1f}s (a step: "
                         + ", ".join(f"{k[:-2]} {v:.1f} ms" for k, v in split.items()) + ")")
        return last

    # -- loops -------------------------------------------------------------------------

    def _x0(self, i: int, st: "_Staged", x0_for: Optional[X0Fn]) -> torch.Tensor:
        """Batch i's ODE start state, drawn at the global batch (before any padding for the
        ranks); a data-parallel rank takes its rows."""
        n_local = int(st.batch["rgb"].shape[0])
        n = st.global_n or n_local
        if x0_for is not None:
            x0 = torch.as_tensor(x0_for(i, n), dtype=torch.float32, device=self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(128 + i)
            x0 = V.draw_x0(self.ctx, n, gen)
        return mesh.rows_of_global(x0, n, n_local, per_row=self.ctx.cfg.sample_num)

    def _staged(self, batches: Iterable[Dict[str, Any]], is_train: bool = False,
                generator: Optional[torch.Generator] = None) -> Iterator["_Staged"]:
        """Each host batch on the device, staged a batch ahead, then (``--device_preprocess``)
        preprocessed there.  Yields the batch, its valid mask and index, the seconds this
        thread waited for it, and the preprocess's clock marks (None without one)."""
        stager = DeviceStager(self.device)
        pre = None
        if self.cfg.device_preprocess:       # one per mode for the run: its graphs are kept
            pre = self._preprocess.get(is_train)
            if pre is None:
                pre = self._preprocess[is_train] = make_device_preprocess(self.cfg, is_train)

        def stage(batch):
            batch = dict(batch)
            valid, index = batch.pop("_valid", None), batch.pop("_index", None)
            global_n = batch.pop("_n", None)
            n = len(next(iter(batch.values())))
            valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
            index = np.full(n, -1) if index is None else np.asarray(index)
            global_n = None if global_n is None else int(global_n[0])
            return stager.stage(batch), valid, index, global_n

        it = iter(prefetch(batches, stage))
        for i in itertools.count():
            with span("stage_wait", i):
                t0 = time.perf_counter()
                try:
                    staged, valid, index, global_n = next(it)
                except StopIteration:
                    return
                wait_s = time.perf_counter() - t0
                batch, marks = stager.ready(staged), None
            if pre is not None:
                with span("preprocess", i):
                    m0 = self._clock.mark()
                    batch = pre(batch, generator=generator)
                    marks = (m0, self._clock.mark())
            yield _Staged(batch, valid, index, global_n, wait_s, marks)

    def _eval_path_of(self):
        return self.eval_dataset.get_path if self.eval_dataset is not None else None

    def _step(self, kind: str):
        """The model's predict, candidate or train step, made at first use (and anew for a new
        model or optimizer object)."""
        owner, step = self._steps.get(kind, ((None, None), None))
        if owner[0] is not self.model or owner[1] is not self.optimizer:
            if kind == "train":
                step = make_train_step(self.model, self.ctx, self.optimizer)
            else:
                make = make_predict_step if kind == "predict" else make_candidate_step
                step = make(self.model, self.ctx)
            self._steps[kind] = ((self.model, self.optimizer), step)
        return step

    def _predict(self, i: int, batch, x0):
        """The predict step.  Batch 0 runs it eagerly, the capture's warm-up, then captures the
        step (once per signature); batch 1 is traced when ``--trace_dir`` is set (a replay, on
        the card).  The step's ``marks`` then hold the call's stage marks."""
        step = self._step("predict")
        run = lambda: step(batch, x0)
        if i == 0:
            pd = step.eager(self.device, batch, x0)
            step.capture(batch, x0, warm=False)
            return pd
        if i == 1 and self.cfg.trace_dir and not self._trace_done and mesh.is_main():
            try:
                with trace(self.cfg.trace_dir) as tr:
                    pd = run()
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                self._trace_done = True
                self.logger.info(f"trace written: {tr['path']}")
                return pd
            except OSError as e:              # the trace directory: the next evaluate() retries
                self.logger.warning(f"trace failed ({e}); will retry at the next evaluate()")
        return run()

    def evaluate(self, batches: Iterable[Dict[str, Any]], path_of=None,
                 x0_for: Optional[X0Fn] = None) -> Dict[str, Any]:
        """Predict + metric suite over an eval stream.  Each batch carries gt_joint and
        gt_hand_vert (camera frame), gt_obj_rt (3, 4), cam_intr and obj_id besides the model
        inputs.  Returns the report, the dump rows and the per-batch timing: seconds waited
        for the loader, of preprocess, predict and metrics (device spans on a GPU), of the
        predict step's launch wait, trunk, ODE and aggregation (its stage marks, read after the
        batch's one wait), of the whole batch (host clock), and the frames.  While a profiler
        records, the loop's phases are ``vpho.*`` spans (``profiling.span``)."""
        path_of = path_of or self._eval_path_of()
        testers_hand = {k: TesterHand() for k in self.tester_hand_keys}
        testers_obj = {k: TesterObject(self.ctx.registry)
                       for k in ("one_candidate", "mean_candidate_pose")}
        collector_res = []
        clock = Clock(self.device)
        timing = {"wait_s": [], "preprocess_s": [], "predict_s": [], "metrics_s": [],
                  "batch_s": [], "frames": [], **{key: [] for key, _, _ in STAGES}}
        t_prev = time.perf_counter()
        with torch.inference_mode():
            for i, st in enumerate(self._staged(batches)):
                b, valid, index = st.batch, st.valid, st.index
                with span("x0", i):
                    x0 = self._x0(i, st, x0_for)
                m0 = clock.mark()
                pd = self._predict(i, b, x0)
                m1 = clock.mark()
                with span("postprocess", i):
                    root, is_right = b["root_joint"], b["is_right"].bool()
                    hv = lambda v: postprocess_hand_vert(v, root, is_right)
                    pd_vert_agg, pd_joint_agg = hv(pd["agg_hand_vert"]), hv(pd["agg_hand_joint"])
                    pd_rt_agg = postprocess_obj_rt(pd["agg_obj_6d"], root)
                    hand_preds = {
                        "regression": (hv(pd["reg_hand_joint"]), hv(pd["reg_hand_vert"])),
                        "one_candidate": (hv(pd["diff_final_hand_joint"][:, 0]),
                                          hv(pd["diff_final_hand_vert"][:, 0])),
                        "agg_candidate": (pd_joint_agg, pd_vert_agg)}
                    rt_one = postprocess_obj_rt(pd["diff_final_obj_6d"][:, 0], root)
                    obj_preds = {"one_candidate": rt_one, "mean_candidate_pose": pd_rt_agg}
                with span("testers", i):
                    for key, (pj, pv) in hand_preds.items():
                        testers_hand[key].add_batch(b["gt_joint"], pj, b["gt_hand_vert"], pv,
                                                    is_right, valid)
                    for key, rt in obj_preds.items():
                        testers_obj[key].add_batch(rt, b["gt_obj_rt"], b["obj_id"], b["cam_intr"],
                                                   valid)
                m2 = clock.mark()
                with span("rows_to_host", i):
                    row = _host({"pd_obj_rt": pd_rt_agg, "pd_hand_vert": pd_vert_agg,
                                 "pd_hand_joint": pd_joint_agg, "gt_obj_rt": b["gt_obj_rt"],
                                 "obj_id": b["obj_id"].int()})
                    row["pd_hand_vert"] = row["pd_hand_vert"].astype(np.float16)
                    collector_res.append({**row, "_valid": valid, "_index": index})
                if self.cfg.viz_freq > 0 and i % self.cfg.viz_freq == 0 and mesh.is_main():
                    with span("viz", i):
                        self._viz(i, b, pd, pd_vert_agg, pd_rt_agg)
                with span("timing", i):
                    t_now = time.perf_counter()
                    timing["wait_s"].append(st.wait_s)
                    timing["preprocess_s"].append(
                        clock.seconds(*st.pre_span) if st.pre_span else 0.0)
                    timing["predict_s"].append(clock.seconds(m0, m1))
                    timing["metrics_s"].append(clock.seconds(m1, m2))
                    for key, sec in stage_seconds(self._step("predict").marks).items():
                        timing[key].append(sec)
                    timing["batch_s"].append(t_now - t_prev)
                    timing["frames"].append(int(valid.sum()))
                    t_prev = t_now

        if self.cfg.trace_dir and not self._trace_done:
            self.logger.warning("--trace_dir set but no trace captured: the capture runs on "
                                "the second eval batch and this stream had fewer than 2")
        for t in list(testers_hand.values()) + list(testers_obj.values()):
            t.gather_rows()
        report = {"hand": {k: t.report_mm() for k, t in testers_hand.items()},
                  "object": {k: t.report() for k, t in testers_obj.items()}}
        for group, per in report.items():
            for variant, table in per.items():
                self.logger.info(f"{group}/{variant}:\n" + format_table(table))
        self.last_eval = {"report": report,
                          "collector_res": _filter_rows(mesh.allgather_rows(collector_res),
                                                        path_of),
                          "timing": timing}
        return self.last_eval

    def _viz(self, i: int, b, pd, pd_vert_agg, pd_rt_agg):
        """Batch3D pkl dumps of sample 0, and the heatmap JPGs when cv2 is installed."""
        np0 = lambda t: t[0].float().cpu().numpy()
        root, is_right = b["root_joint"], b["is_right"].bool()
        obj_id0 = int(b["obj_id"][0])
        verts0 = self.ctx.registry.verts_sampled[obj_id0].cpu().numpy()
        gt_rt0 = np0(b["gt_obj_rt"])
        rt0 = np0(pd_rt_agg)
        viz.save_viz_hand(
            self.save_dir, i, gt_vert=np0(b["gt_hand_vert"]),
            gt_obj_vert=verts0 @ gt_rt0[:, :3].T + gt_rt0[:, 3],
            pd_vert_reg=np0(postprocess_hand_vert(pd["reg_hand_vert"], root, is_right)),
            pd_vert_diff=np0(postprocess_hand_vert(pd["diff_final_hand_vert"], root, is_right)),
            pd_vert_agg=np0(pd_vert_agg))
        viz.save_viz_obj(
            self.save_dir, i, self.ctx.registry, obj_id0, gt_rt=gt_rt0,
            pd_rt_cands=np0(postprocess_obj_rt(pd["diff_final_obj_6d"], root)),
            pd_rt_agg=rt0, gt_hand=np0(b["gt_hand_vert"]))
        if viz.jpg_writer_available():
            viz.save_viz_heatmap(
                self.save_dir, i, rgb_norm=np0(b["rgb"]), bbox_hand=np0(b["bbox_hand"]),
                bbox_obj=np0(b["bbox_obj"]), pd_hm_hand=np0(pd["hand_heatmap"]),
                gt_hm_hand=np0(b["hm_hand"] if "hm_hand" in b else pd["hand_heatmap"]),
                pd_hm_obj=np0(pd["obj_heatmap"]),
                gt_hm_obj=np0(b["hm_obj"] if "hm_obj" in b else pd["obj_heatmap"]))
            if "obj_segm" in pd and "segm_obj" in b:
                viz.save_viz_segmentation(
                    self.save_dir, i, rgb_norm=np0(b["rgb"]), bbox_obj=np0(b["bbox_obj"]),
                    pd_obj_segm=np0(pd["obj_segm"])[0], gt_obj_segm=np0(b["segm_obj"])[0])
        elif not self._told_no_jpg:
            self.logger.info("cv2 is not installed: the heatmap JPGs are not written")
            self._told_no_jpg = True
        # anchor frames live on the flipped (right-hand) mesh, as in the aggregation
        vert_flip0 = pd["agg_hand_vert"][:1] + b["root_joint_flip"][:1, None]
        fp, fg = anchor_lib.force_local_to_global(self.ctx.anchor_tables,
                                                  pd["force_local"][:1], vert_flip0)
        com0 = self.ctx.registry.com[obj_id0].cpu().numpy()[None]
        viz.save_viz_force(
            self.save_dir, i, vert=np0(vert_flip0), force_point=np0(fp), force_global=np0(fg),
            gravity=np0(b["gravity"]), com=com0 @ rt0[:, :3].T + rt0[:, 3],
            obj_mesh=verts0 @ rt0[:, :3].T + rt0[:, 3])

    def dump_predictions(self, collector_res, tag: str = "") -> str:
        """The my-prediction pkl."""
        path = os.path.join(self.save_dir,
                            f"my-prediction_align-{self.cfg.clean_data_mode}{tag}.pkl")
        if mesh.is_main():
            with open(path, "wb") as f:
                pickle.dump(collector_res, f)
            self.logger.info(f"Dumped predictions: {path}")
        mesh.sync_processes()
        return path

    def infer_candidates(self, batches: Iterable[Dict[str, Any]], path_of=None,
                         x0_for: Optional[X0Fn] = None) -> str:
        """``--mode infer_candidate``: per frame, the S diffusion candidates (hand MANO 58-d,
        object 9-d), the regression joints and the physics cue, without aggregation (fp16
        where bulky).  Returns the pkl path."""
        path_of = path_of or self._eval_path_of()
        rows = []
        with torch.inference_mode():
            for i, st in enumerate(self._staged(batches)):
                b, valid, index = st.batch, st.valid, st.index
                x0 = self._x0(i, st, x0_for)
                pd = self._step("candidate")(b, x0)
                row = _host({"diff_hand_mano": pd["diff_final_hand_mano"],
                             "diff_obj_6d": pd["diff_final_obj_6d"],
                             "reg_hand_joint": pd["reg_hand_joint"],
                             "force_local": pd["force_local"],
                             "is_grasped": b["is_grasped"].float(), "obj_id": b["obj_id"].int()})
                for k in ("diff_hand_mano", "reg_hand_joint", "force_local"):
                    row[k] = row[k].astype(np.float16)
                rows.append({**row, "_valid": valid, "_index": index})
        path = os.path.join(self.save_dir,
                            f"my-candidates_align-{self.cfg.clean_data_mode}.pkl")
        rows = _filter_rows(mesh.allgather_rows(rows), path_of)
        if mesh.is_main():
            with open(path, "wb") as f:
                pickle.dump(rows, f)
            self.logger.info(f"Dumped candidates: {path}")
        mesh.sync_processes()
        return path

    def infer_ho3d(self, batches: Iterable[Dict[str, Any]], path_of=None, epoch_tag: str = "",
                   x0_for: Optional[X0Fn] = None) -> Dict[str, Any]:
        """HO3D's codalab inference over its GT-less evaluation split: the object metrics,
        then the regression and the aggregated hands, turned back to the OpenGL frame, as
        ``<run>/submit/<tag>hand_reg.zip`` and ``<tag>hand_diff.zip`` in dataset
        (``evaluation.txt``) order, and the prediction pkl (``-infer<tag>``)."""
        from ..data.ho3d import OPENGL_TO_OPENCV, dump_codalab

        path_of = path_of or self._eval_path_of()
        testers_obj = {k: TesterObject(self.ctx.registry)
                       for k in ("one_candidate", "mean_candidate_pose")}
        # the frame change is diagonal: a sign per axis, exact (no matmul, so no TF32)
        gl = torch.tensor(np.diag(OPENGL_TO_OPENCV), dtype=torch.float32, device=self.device)
        rows = []
        with torch.inference_mode():
            for i, st in enumerate(self._staged(batches)):
                b, valid = st.batch, st.valid
                pd = self._predict(i, b, self._x0(i, st, x0_for))
                root, is_right = b["root_joint"], b["is_right"].bool()
                hv = lambda v: postprocess_hand_vert(v, root, is_right)
                joint_reg, vert_reg = hv(pd["reg_hand_joint"]), hv(pd["reg_hand_vert"])
                joint_agg, vert_agg = hv(pd["agg_hand_joint"]), hv(pd["agg_hand_vert"])
                rt_agg = postprocess_obj_rt(pd["agg_obj_6d"], root)
                for key, rt in (("one_candidate",
                                 postprocess_obj_rt(pd["diff_final_obj_6d"][:, 0], root)),
                                ("mean_candidate_pose", rt_agg)):
                    testers_obj[key].add_batch(rt, b["gt_obj_rt"], b["obj_id"], b["cam_intr"],
                                               valid)
                row = _host({"pd_obj_rt": rt_agg, "pd_hand_vert": vert_agg,
                             "pd_hand_joint": joint_agg, "joint_reg_gl": joint_reg * gl,
                             "vert_reg_gl": vert_reg * gl, "joint_diff_gl": joint_agg * gl,
                             "vert_diff_gl": vert_agg * gl})
                row["pd_hand_vert"] = row["pd_hand_vert"].astype(np.float16)
                rows.append({**row, "_valid": valid, "_index": st.index})
        for t in testers_obj.values():
            t.gather_rows()
        rows = _filter_rows(mesh.allgather_rows(rows), path_of, keep_index=True)
        order = np.argsort(np.concatenate([r["index"] for r in rows]), kind="stable")
        cat = lambda key: np.concatenate([r[key] for r in rows], axis=0)[order]
        submit = os.path.join(self.save_dir, "submit")
        zips = {}
        if mesh.is_main():
            zips = {name: dump_codalab(cat(f"joint_{kind}_gl"), cat(f"vert_{kind}_gl"),
                                       os.path.join(submit, f"{epoch_tag}{name}"))
                    for name, kind in (("hand_reg", "reg"), ("hand_diff", "diff"))}
        for name, p in zips.items():
            self.logger.info(f"codalab {name}: {p}")
        report = {k: t.report() for k, t in testers_obj.items()}
        for variant, table in report.items():
            self.logger.info(f"object/{variant}:\n" + format_table(table))
        keep_keys = ("pd_obj_rt", "pd_hand_vert", "pd_hand_joint", "index", "path")
        collector_res = [{k: r[k] for k in keep_keys if k in r} for r in rows]
        self.dump_predictions(collector_res, tag=f"-infer{epoch_tag}")
        return {"report": {"object": report}, "collector_res": collector_res, "zips": zips}
