"""Driver of the training cell: the window is one ``Trainer.train_one_epoch`` call.

Set-up builds the port's trainer and optimizer to the configuration, copies in the seed's
weights and makes the mix's pool of host batches.  A first ``train_one_epoch`` call on the
pool's last batch is the step's eager warm-up, which captures its graph; the weights, the
batch-norm statistics and the optimizer's state are then put back in place (``restart``), so
the graph keeps its buffers.  Set-up then drives the same trainer through its first
``checked_steps`` steps, all replays of that graph, one ``train_one_epoch`` call a step (epoch
k seeds step k's draws with 1000 + k) on pool batches 0, 1, 2.  It keeps each step's losses,
the first gradient's leaf norms (read from Adam's first moment, mu = (1 - b1) g after one
step) and each leaf's change after the last.  The window then continues the same trainer over
the pool, cycled from batch 3, until ``--seconds`` have passed.
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict

import torch

from .. import compare, weights
from ..harness import Spec, make_trainer, mean_ms
from ..reference.vpho_ref.models.mano import load_mano
from ..reference.vpho_ref.models.ycb import load_registry
from ..traffic import generator as traffic

WARM_EPOCH = -1                   # the warm-up's draws: a generator seeded 999, checked by none


def inputs(spec: Spec, seed: int, device) -> SimpleNamespace:
    sd = weights.make_state_dict(seed, device)
    pool = traffic.make_pool(spec.mix, seed, load_mano(device="cpu"), load_registry(device="cpu"))
    return SimpleNamespace(sd=sd, pool=pool)


def restart(trainer, sd: Dict[str, torch.Tensor]) -> None:
    """The trainer as it was before its first step: ``sd``'s weights and batch-norm statistics
    and a fresh optimizer, each written in place into the tensors a captured step reads."""
    trainer.model.load_state_dict(sd, strict=True)
    opt = trainer.optimizer
    for state in (opt.mu, opt.nu) + (() if opt.acc is None else (opt.acc,)):
        torch._foreach_zero_(state)
    opt.count = opt.mini_step = 0
    trainer.step = 0


def setup(spec: Spec, seed: int, device) -> SimpleNamespace:
    mix = spec.mix
    t0 = time.perf_counter()
    trainer = make_trainer(spec, device, ["--batch_size", str(mix["batch_size"])],
                           steps_per_epoch=int(mix["steps_per_epoch"]))
    t1 = time.perf_counter()
    data = inputs(spec, seed, device)
    trainer.model.load_state_dict(data.sd, strict=True)
    t2 = time.perf_counter()
    trainer.train_one_epoch(WARM_EPOCH, [data.pool[-1]], 1)
    restart(trainer, data.sd)
    t3 = time.perf_counter()
    opt = trainer.optimizer
    prog = {"losses": []}
    for k in range(int(mix["checked_steps"])):
        last = trainer.train_one_epoch(k, [data.pool[k]], 1)
        prog["losses"].append({n: float(v) for n, v in last.items()})
        if k == 0:
            prog["grad1"] = {n: float(torch.linalg.vector_norm(m.double())) / (1 - opt.b1)
                             for n, m in zip(opt.names, opt.mu)}
    prog["change"] = compare.change_norms(trainer.model.state_dict(), data.sd)
    phases = {"trainer_s": t1 - t0, "inputs_s": t2 - t1, "warm_up_s": t3 - t2,
              "checked_steps_s": time.perf_counter() - t3}
    return SimpleNamespace(spec=spec, seed=seed, device=device, trainer=trainer, data=data,
                           prog=prog, record=None, phases=phases)


def _stream(pool, first: int, seconds=None, n=None, opened=None):
    i = 0
    while n is None or i < n:
        if seconds is not None and time.perf_counter() - opened >= seconds:
            return
        yield pool[(first + i) % len(pool)]
        i += 1


def window(state, seconds: float) -> Dict:
    mix, trainer = state.spec.mix, state.trainer
    t_open = time.perf_counter()
    first = int(mix["checked_steps"])
    trainer.train_one_epoch(first, _stream(state.data.pool, first, seconds, opened=t_open),
                            int(mix["steps_per_epoch"]))
    state.record = dict(trainer.last_train)
    state.window_stats = {"steps": state.record["steps"],
                          "step_ms": mean_ms(state.record["step_s"]),
                          "wait_ms": mean_ms(state.record["wait_s"])}
    return {"t_open": t_open, "train": state.record}


def trace(state, tracer) -> None:
    """A further ``train_one_epoch`` of ``traced_steps`` replayed steps, profiled whole."""
    n = int(state.spec.mix["traced_steps"])
    tracer.start()
    state.trainer.train_one_epoch(int(state.spec.mix["checked_steps"]) + 1,
                                  _stream(state.data.pool, 0, n=n), n)
    tracer.stop()


def attempted_failed(state) -> tuple:
    rec = state.record
    finite = all(v == v and abs(v) != float("inf") for v in rec["losses"].values())
    return int(rec["steps"]), 0 if finite else int(rec["steps"])


def release(state) -> None:
    state.trainer = None
    gc.collect()
    torch.cuda.empty_cache()


def reference_steps(spec: Spec, data, device, compute_dtype=None, half_batch=False) -> Dict:
    """The reference's first steps from the seed's weights (``compute_dtype`` in place of the
    configuration's: the control; ``half_batch``: a planted fault)."""
    model_cfg = dict(spec.config["model"])
    if compute_dtype is not None:
        model_cfg["compute_dtype"] = compute_dtype
    ctx = compare.reference_context(model_cfg, device)
    model = compare.reference_model(data.sd, model_cfg["compute_dtype"], device)
    batches = [compare.to_device(data.pool[k], device)
               for k in range(int(spec.mix["checked_steps"]))]
    return compare.reference_train(model, ctx, batches, float(spec.config["learning_rate"]),
                                   half_batch=half_batch)


def check(state) -> Dict[str, float]:
    ref = reference_steps(state.spec, state.data, state.device)
    return compare.train_numbers(state.prog, ref, state.data.sd)
