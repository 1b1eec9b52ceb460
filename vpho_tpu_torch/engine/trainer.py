"""Training and evaluation engine (counterpart of ``vpho_tpu/engine/trainer.py``).

``Trainer(cfg, device)`` builds the constants and, in ``init_state``, the model (seeded
weights, then ``--imagenet_pretrain`` and ``--pretrain``), the optimizer when it is given the
epoch's step count, and the ``--checkpoint`` state.

Training: ``train_step`` is one forward (``forward_train``, the BN statistics move), backward
and optimizer update; ``train_one_epoch`` runs it over a stream, its draws and dropout masks
from a generator seeded 1000 + epoch.  The optimizer is the JAX trainer's optax chain
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
the report; each batch makes one host transfer, for the prediction dump.

With ``--device_preprocess`` the loaders ship decoded frames and the batch's pixel work
(crop, colour augmentation, erasing, heatmaps) runs on the device when the batch is staged
(``data/device_pipeline.py``); a train epoch draws its erase noise from a generator seeded
0x5A5A0000 + epoch.  ``infer_ho3d`` is HO3D's codalab inference: object metrics, the
regression and the aggregated hands in the OpenGL frame as two zips in ``evaluation.txt``
order, and the prediction pkl.

Orbax checkpoints and multi-device runs are later slices.
"""
from __future__ import annotations

import datetime
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
from ..models.layers import DropoutMasks
from ..utils import transforms as T
from ..utils.platform import resolve_device
from . import viz
from .profiling import flops_of, param_count, trace
from .tester import TesterHand, TesterObject

X0Fn = Callable[[int, int], torch.Tensor]
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
    counts applied updates; it sets the bias corrections and the schedule's step."""

    b1, b2, eps = 0.9, 0.999, 1e-8

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

    @torch.no_grad()
    def updates(self, grads: Sequence[torch.Tensor]) -> Optional[List[torch.Tensor]]:
        """optax's ``update``: what to add to the parameters, or None between accumulation
        boundaries."""
        g = list(grads)
        if self.acc is not None:
            step = torch._foreach_sub(g, self.acc)
            torch._foreach_div_(step, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, step)
            self.mini_step += 1
            if self.mini_step < self.every:
                return None
            g, self.acc, self.mini_step = self.acc, [torch.zeros_like(a) for a in self.acc], 0
        if self.clip > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g))).item()
            if not norm < self.clip:
                g = torch._foreach_div(g, norm)
                torch._foreach_mul_(g, self.clip)
        if self.kind == "adam":
            g = torch._foreach_add(g, self.params, alpha=5e-4)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(g, g), alpha=1.0 - self.b2)
        self.count += 1
        # bias corrections in float32, as optax computes them
        bc1 = float(_F32(1.0) - _F32(self.b1) ** _F32(self.count))
        bc2 = float(_F32(1.0) - _F32(self.b2) ** _F32(self.count))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(u, denom)
        if self.kind == "adamw":
            torch._foreach_add_(u, self.params, alpha=1e-4)
        torch._foreach_mul_(u, -self.schedule(self.count - 1))
        return u

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


def _split_state(model: torch.nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """The model's state_dict as the JAX package's three collections."""
    params = {k for k, _ in model.named_parameters()}
    out = {"params": {}, "batch_stats": {}, "buffers": {}}
    for k, v in model.state_dict().items():
        coll = "params" if k in params else "batch_stats" if k.endswith(
            ("running_mean", "running_var", "num_batches_tracked")) else "buffers"
        out[coll][k] = v
    return out


def setup_logger(save_dir: str, name: str = "vpho_torch") -> logging.Logger:
    """File (``<save_dir>/info.log``) and console logging."""
    os.makedirs(save_dir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    fh = logging.FileHandler(os.path.join(save_dir, "info.log"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
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


def _filter_rows(rows, path_of):
    """Drop padded samples; turn the ``_index`` column into ``index`` (and ``path``)."""
    filtered = []
    for r in rows:
        keep = np.asarray(r.pop("_valid"), bool)
        idx = np.asarray(r.pop("_index"))[keep]
        row = {k: np.asarray(v)[keep] for k, v in r.items()}
        if (idx >= 0).all():
            row["index"] = idx
            if path_of is not None:
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


class _BatchClock:
    """Per-batch spans without host waits: CUDA events on the stream (device timeline) on a
    GPU, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    @staticmethod
    def seconds(a, b) -> float:
        return a.elapsed_time(b) / 1e3 if isinstance(a, torch.cuda.Event) else b - a


class _Staged(NamedTuple):
    batch: Dict[str, torch.Tensor]
    valid: np.ndarray
    index: np.ndarray
    wait_s: float                       # host seconds waiting for the loader
    pre_span: Optional[tuple]           # the device preprocess's clock marks, or None


class Trainer:
    """Train / eval / infer runner (the JAX package's ``Trainer``)."""

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.num_devices > 1:
            raise NotImplementedError("--num_devices > 1 is not ported yet (ROADMAP section 1, "
                                      "multi-GPU training via torch DDP)")
        if cfg.checkpoint and os.path.isdir(cfg.checkpoint):
            raise NotImplementedError(
                f"--checkpoint {cfg.checkpoint}: an orbax checkpoint directory of the JAX "
                f"package; reading orbax is not ported (ROADMAP section 1, CLI and tooling). "
                f"The port resumes from its own epoch_N.state files")
        T.set_quat_mean_impl(cfg.quat_mean_impl)
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        self.save_dir = os.path.join(cfg.output_dir,
                                     f"{stamp}_{cfg.mark}_{cfg.mode}_{cfg.model}")
        self.logger = setup_logger(self.save_dir)
        self.ctx = V.make_context(cfg.to_model_config(), cfg.mano_root or None,
                                  cfg.models_dir or None, device=self.device)
        self.tester_hand_keys = ("regression", "one_candidate", "agg_candidate")
        self.start_epoch = 0
        if cfg.checkpoint:
            m = re.search(r"epoch_(\d+)\.state", cfg.checkpoint)
            if m:
                self.start_epoch = int(m.group(1))
        self.model: Optional[V.VPHONet] = None
        self.optimizer: Optional[Optimizer] = None
        self.step = 0                                       # train_step calls so far
        self._clock = _BatchClock(self.device)
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
        os.makedirs(os.path.dirname(path), exist_ok=True)
        opt = self.optimizer.state_dict() if self.optimizer is not None else None
        torch.save({**_split_state(self.model), "opt_state": opt, "step": self.step}, path)
        self.logger.info(f"Saved checkpoint: {path}")
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
        save_final_model(self.model, path)
        self.logger.info(f"Saved final model: {path}")
        return path

    # -- training ----------------------------------------------------------------------

    def train_step(self, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[V.Draws] = None,
                   dropout: Optional[DropoutMasks] = None) -> Dict[str, torch.Tensor]:
        """One step on a device batch: ``forward_train`` (the BN statistics move), the
        gradients of the total loss, the optimizer.  Draws and dropout masks as
        ``forward_train`` takes them.  Returns the weighted losses, detached."""
        params = self.optimizer.params
        m0 = self._clock.mark()
        total, losses = V.forward_train(self.model, self.ctx, batch, draws=draws,
                                        dropout=dropout, generator=generator)
        m1 = self._clock.mark()
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        m2 = self._clock.mark()
        self.optimizer.step(grads)
        self._train_marks.append((m0, m1, m2, self._clock.mark()))
        self.step += 1
        return {k: v.detach() for k, v in losses.items()}

    def train_timing(self) -> Dict[str, List[float]]:
        """Seconds of forward, backward and optimizer per ``train_step`` since the last call
        (device-stream spans on a GPU)."""
        marks, self._train_marks = self._train_marks, []
        sec = self._clock.seconds
        return {"forward_s": [sec(a, b) for a, b, _, _ in marks],
                "backward_s": [sec(b, c) for _, b, c, _ in marks],
                "optimizer_s": [sec(c, d) for _, _, c, d in marks]}

    def train_one_epoch(self, epoch: int, batches: Iterable[Dict[str, Any]],
                        steps_per_epoch: int) -> Dict[str, torch.Tensor]:
        """``train_step`` over a host stream, logging the losses every ``--print_freq`` steps.
        Returns the last step's losses; ``last_train`` keeps the epoch's time, per-step split
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
                vals = torch.stack([v.float() for v in last.values()]).cpu().tolist()
                self.logger.info(f"[{i:04d}/{steps_per_epoch}] " + " ".join(
                    f"{k.replace('_loss', '')}:{v:.2e}" for k, v in zip(last, vals)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        timing = self.train_timing()
        split = {k: 1e3 * sum(v) / max(len(v), 1) for k, v in timing.items()}
        losses = dict(zip(last, torch.stack([v.float() for v in last.values()]).cpu().tolist()))
        self.last_train = {"seconds": seconds, "steps": len(timing["forward_s"]),
                           "losses": losses, **timing, "wait_s": waits,
                           "preprocess_s": [self._clock.seconds(*sp) if sp else 0.0
                                            for sp in pre_spans]}
        self.logger.info(f"Epoch {epoch} done in {seconds:.1f}s (a step: "
                         + ", ".join(f"{k[:-2]} {v:.1f} ms" for k, v in split.items()) + ")")
        return last

    # -- loops -------------------------------------------------------------------------

    def _x0(self, i: int, batch_size: int, x0_for: Optional[X0Fn]) -> torch.Tensor:
        if x0_for is not None:
            return torch.as_tensor(x0_for(i, batch_size), dtype=torch.float32,
                                   device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(128 + i)
        return V.draw_x0(self.ctx, batch_size, gen)

    def _staged(self, batches: Iterable[Dict[str, Any]], is_train: bool = False,
                generator: Optional[torch.Generator] = None) -> Iterator["_Staged"]:
        """Each host batch on the device, staged a batch ahead, then (``--device_preprocess``)
        preprocessed there.  Yields the batch, its valid mask and index, the seconds this
        thread waited for it, and the preprocess's clock marks (None without one)."""
        stager = DeviceStager(self.device)
        pre = make_device_preprocess(self.cfg, is_train) if self.cfg.device_preprocess else None

        def stage(batch):
            batch = dict(batch)
            valid, index = batch.pop("_valid", None), batch.pop("_index", None)
            n = len(next(iter(batch.values())))
            valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
            index = np.full(n, -1) if index is None else np.asarray(index)
            return stager.stage(batch), valid, index

        it = iter(prefetch(batches, stage))
        while True:
            t0 = time.perf_counter()
            try:
                staged, valid, index = next(it)
            except StopIteration:
                return
            wait_s = time.perf_counter() - t0
            batch, span = stager.ready(staged), None
            if pre is not None:
                m0 = self._clock.mark()
                batch = pre(batch, generator=generator)
                span = (m0, self._clock.mark())
            yield _Staged(batch, valid, index, wait_s, span)

    def _eval_path_of(self):
        return self.eval_dataset.get_path if self.eval_dataset is not None else None

    def _predict(self, i: int, batch, x0):
        """forward_predict; batch 0 also counts the graph's operations, batch 1 is traced
        when ``--trace_dir`` is set."""
        run = lambda: V.forward_predict(self.model, self.ctx, batch, x0=x0)
        if i == 0:
            pd, cost = flops_of(run)
            self.logger.info(f"predict graph: {cost['flops'] / 1e9:.2f} GFLOPs "
                             f"({cost['kernel_flops'] / 1e9:.2f} in the CUDA kernels), "
                             f"{param_count(self.model) / 1e6:.2f}M params")
            return pd
        if i == 1 and self.cfg.trace_dir and not self._trace_done:
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
        whole batch (host clock), and the frames."""
        path_of = path_of or self._eval_path_of()
        testers_hand = {k: TesterHand() for k in self.tester_hand_keys}
        testers_obj = {k: TesterObject(self.ctx.registry)
                       for k in ("one_candidate", "mean_candidate_pose")}
        collector_res = []
        clock = _BatchClock(self.device)
        timing = {"wait_s": [], "preprocess_s": [], "predict_s": [], "metrics_s": [],
                  "batch_s": [], "frames": []}
        t_prev = time.perf_counter()
        with torch.inference_mode():
            for i, st in enumerate(self._staged(batches)):
                b, valid, index = st.batch, st.valid, st.index
                x0 = self._x0(i, b["rgb"].shape[0], x0_for)
                m0 = clock.mark()
                pd = self._predict(i, b, x0)
                m1 = clock.mark()
                root, is_right = b["root_joint"], b["is_right"].bool()
                hv = lambda v: postprocess_hand_vert(v, root, is_right)
                pd_vert_agg, pd_joint_agg = hv(pd["agg_hand_vert"]), hv(pd["agg_hand_joint"])
                pd_rt_agg = postprocess_obj_rt(pd["agg_obj_6d"], root)
                hand_preds = {
                    "regression": (hv(pd["reg_hand_joint"]), hv(pd["reg_hand_vert"])),
                    "one_candidate": (hv(pd["diff_final_hand_joint"][:, 0]),
                                      hv(pd["diff_final_hand_vert"][:, 0])),
                    "agg_candidate": (pd_joint_agg, pd_vert_agg)}
                for key, (pj, pv) in hand_preds.items():
                    testers_hand[key].add_batch(b["gt_joint"], pj, b["gt_hand_vert"], pv,
                                                is_right, valid)
                obj_preds = {
                    "one_candidate": postprocess_obj_rt(pd["diff_final_obj_6d"][:, 0], root),
                    "mean_candidate_pose": pd_rt_agg}
                for key, rt in obj_preds.items():
                    testers_obj[key].add_batch(rt, b["gt_obj_rt"], b["obj_id"], b["cam_intr"],
                                               valid)
                m2 = clock.mark()
                row = _host({"pd_obj_rt": pd_rt_agg, "pd_hand_vert": pd_vert_agg,
                             "pd_hand_joint": pd_joint_agg, "gt_obj_rt": b["gt_obj_rt"],
                             "obj_id": b["obj_id"].int()})
                row["pd_hand_vert"] = row["pd_hand_vert"].astype(np.float16)
                collector_res.append({**row, "_valid": valid, "_index": index})
                if self.cfg.viz_freq > 0 and i % self.cfg.viz_freq == 0:
                    self._viz(i, b, pd, pd_vert_agg, pd_rt_agg)
                t_now = time.perf_counter()
                timing["wait_s"].append(st.wait_s)
                timing["preprocess_s"].append(clock.seconds(*st.pre_span) if st.pre_span else 0.0)
                timing["predict_s"].append(clock.seconds(m0, m1))
                timing["metrics_s"].append(clock.seconds(m1, m2))
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
                          "collector_res": _filter_rows(collector_res, path_of), "timing": timing}
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
        with open(path, "wb") as f:
            pickle.dump(collector_res, f)
        self.logger.info(f"Dumped predictions: {path}")
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
                x0 = self._x0(i, b["rgb"].shape[0], x0_for)
                pd, _ = V.forward_candidates(self.model, self.ctx, b, x0=x0)
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
        with open(path, "wb") as f:
            pickle.dump(_filter_rows(rows, path_of), f)
        self.logger.info(f"Dumped candidates: {path}")
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
                pd = self._predict(i, b, self._x0(i, b["rgb"].shape[0], x0_for))
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
                keep = np.asarray(valid, bool)
                row = {k: v[keep] for k, v in row.items()}
                row["index"] = np.asarray(st.index)[keep]
                if (row["index"] >= 0).all() and path_of is not None:
                    row["path"] = [path_of(int(j)) for j in row["index"]]
                rows.append(row)
        for t in testers_obj.values():
            t.gather_rows()
        order = np.argsort(np.concatenate([r["index"] for r in rows]), kind="stable")
        cat = lambda key: np.concatenate([r[key] for r in rows], axis=0)[order]
        submit = os.path.join(self.save_dir, "submit")
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
