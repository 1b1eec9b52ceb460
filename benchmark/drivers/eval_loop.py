"""Driver of the eval cells: the window is one ``Trainer.evaluate`` call.

Set-up builds the port's trainer to the configuration, copies in the seed's weights, makes the
mix's pool of host batches and each pool batch's ODE start state (on the device, from the
seed), and warms the pool's first batch through the set-up of the call itself: ``evaluate``
runs its batch 0 eagerly under the FLOP counter and captures the predict and metric graphs,
and the window opens when batch 1 starts (``x0_for`` below sees it).  The pool is cycled
until ``--seconds`` have passed since then; a frame is one request, closed loop.

The check runs the reference over the pool batches (or a seeded sample of frames, for a pool
of single frames) at the window's batch size, after the program's trainer is freed.
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from .. import compare, weights
from ..harness import Spec, make_trainer, mean_ms
from ..reference.vpho_ref import precision
from ..reference.vpho_ref.diffusion.sde import init_sde
from ..reference.vpho_ref.models.mano import load_mano
from ..reference.vpho_ref.models.ycb import load_registry
from ..traffic import generator as traffic

X0_DIM = 96 + 9


def inputs(spec: Spec, seed: int, device) -> SimpleNamespace:
    """The run's weights, pool of host batches and ODE start states, all from ``seed``."""
    mix, model = spec.mix, spec.config["model"]
    sd = weights.make_state_dict(seed, device)
    pool = traffic.make_pool(mix, seed, load_mano(device="cpu"), load_registry(device="cpu"))
    gen = torch.Generator(device=device).manual_seed((int(seed) * 31 + 5) % (2 ** 63))
    rows = mix["batch_size"] * model["sample_num"]
    z = torch.randn((mix["pool"] * rows, X0_DIM), generator=gen, device=device)
    x0 = list((z * init_sde(model["sde_mode"]).prior_std(model["sample_T0"])).split(rows))
    return SimpleNamespace(sd=sd, pool=pool, x0=x0)


def setup(spec: Spec, seed: int, device) -> SimpleNamespace:
    t0 = time.perf_counter()
    trainer = make_trainer(spec, device, ["--eval_batch_size", str(spec.mix["batch_size"])])
    t1 = time.perf_counter()
    data = inputs(spec, seed, device)
    trainer.model.load_state_dict(data.sd, strict=True)
    phases = {"trainer_s": t1 - t0, "inputs_s": time.perf_counter() - t1}
    return SimpleNamespace(spec=spec, seed=seed, device=device, trainer=trainer, data=data,
                           record=None, phases=phases)


def _evaluate(state, n_batches=None, seconds=None, on_batch=None) -> Dict:
    """One ``evaluate`` call over the pool, cycled: ``n_batches`` of them, or until
    ``seconds`` after batch 1 starts.  ``on_batch(i)`` is called as batch i starts."""
    pool, x0 = state.data.pool, state.data.x0
    opened = []

    def x0_for(i, n):
        if i == 1:
            opened.append(time.perf_counter())
        if on_batch is not None:
            on_batch(i)
        return x0[i % len(x0)]

    def stream():
        i = 0
        while n_batches is None or i < n_batches:
            if seconds is not None and opened and time.perf_counter() - opened[0] >= seconds:
                return
            yield pool[i % len(pool)]
            i += 1

    out = state.trainer.evaluate(stream(), x0_for=x0_for)
    return {**out, "t_open": opened[0] if opened else None}


def window(state, seconds: float) -> Dict:
    out = _evaluate(state, seconds=seconds)
    state.record = out
    t = out["timing"]
    state.phases["batch0_s"] = t["batch_s"][0]
    state.window_stats = {"batches": len(t["batch_s"]) - 1,
                          "batch_ms_p50": 1e3 * float(np.median(t["batch_s"][1:])),
                          **{f"{k[:-2]}_ms": mean_ms(t[k][1:])
                             for k in ("predict_s", "metrics_s", "wait_s")}}
    return {"t_open": out["t_open"], "timing": t, "frames": int(sum(t["frames"][1:])),
            "window_s": float(sum(t["batch_s"][1:]))}


def trace(state, tracer) -> None:
    """A second ``evaluate`` over n + 2 pool batches, profiled from batch 1 to batch n + 1:
    n steady batches (replays) with their host work."""
    n = int(state.spec.mix["traced_batches"])

    def on_batch(i):
        if i == 1:
            tracer.start()
        elif i == n + 1:
            tracer.stop()

    _evaluate(state, n_batches=n + 2, on_batch=on_batch)


def attempted_failed(state) -> tuple:
    """Frames answered, and those whose hand joints or object pose hold a non-finite value."""
    n = bad = 0
    for r in state.record["collector_res"]:
        rows = len(r["index"])
        finite = np.ones(rows, bool)
        for k in ("pd_hand_joint", "pd_obj_rt"):
            finite &= np.isfinite(np.asarray(r[k], np.float32).reshape(rows, -1)).all(-1)
        n, bad = n + rows, bad + int((~finite).sum())
    return n, bad


def release(state) -> None:
    """Free the program: its trainer, graphs and pools."""
    state.trainer = None
    gc.collect()
    torch.cuda.empty_cache()


def checked_batches(spec: Spec, seed: int) -> list:
    """The pool batches the reference recomputes: all, or a seeded sample of
    ``mix["check_sample"]``."""
    n = int(spec.mix["pool"])
    k = int(spec.mix.get("check_sample", n))
    if k >= n:
        return list(range(n))
    return sorted(np.random.RandomState(traffic.batch_seed(seed, 99991)).choice(n, k, False))


def reference_answers(spec: Spec, seed: int, data, device, low: bool = False) -> tuple:
    """The reference's answers for the checked pool batches (``low``: the control, one
    precision below the configuration's), by pool batch, and the reference's context."""
    model_cfg = spec.config["model"]
    ctx = compare.reference_context(model_cfg, device)
    model = compare.reference_model(data.sd, model_cfg["compute_dtype"], device)
    out = {}
    with precision.low(low):
        for k in checked_batches(spec, seed):
            out[k] = compare.reference_eval(model, ctx, compare.to_device(data.pool[k], device),
                                            data.x0[k])
    return out, ctx


def excluded_class(registry):
    """The class the report's averages leave out, as the tester does."""
    names = list(registry.names)
    return names.index("051_large_clamp") if "051_large_clamp" in names else None


def check(state) -> Dict[str, float]:
    spec, rec = state.spec, state.record
    report = compare.report_numbers(rec["report"]) if spec.mix.get("check_report") else None
    rows = rec["collector_res"]
    ref, ctx = reference_answers(spec, state.seed, state.data, state.device)
    obj_ids = {k: np.asarray(b["obj_id"]) for k, b in enumerate(state.data.pool)}
    return compare.eval_numbers(rows, report, ref, spec.mix["batch_size"],
                                excluded_class(ctx.registry), obj_ids)
