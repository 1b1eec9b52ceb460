#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vpho_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each:
  1. build    compile every hand-written kernel (one nvcc per source, in parallel); ptxas's
              registers, shared memory and spill bytes for each (spills fail the run)
  2. kernel   each kernel against its plain PyTorch version on the card, at the main path's
              shapes and at edge shapes, with kernel / plain / library timings and bounds; K3
              at an eval batch's shapes (64 x 4000^2 full-mesh pairs with the registry's mask,
              64 x 2048^2 sampled pairs) equal to its plain form bit for bit; K4 at each of the
              blessed trunk's 147 BN sites at B 64 (the inputs the trunk hands it, BN statistics
              away from (0, 1)) equal to the plain chain bit for bit, its summed ms per eval
              batch against its bound and the plain chain's
  3. f32      the predict slice at test size on the card (TF32 off) against the same port on
              the CPU: same weights, same ODE start state
  4. predict  the blessed eval config (patch 256, bs 64, S 100, 50 dpm3m steps, topk 30/10,
              bf16 policy) through ``make_predict_step``: the capture (with its eager warm-up),
              then 3 timed replays, kernel launch counts, frames/s, peak memory, and an eager
              per-stage time split
  4b. ode     the blessed 50-step ODE (``forward_candidates``) once more with K1's plain version
              bound into the denoiser, held against the kernel run
  5. profile  one more eager batch under torch.profiler: device busy time, idle share, top
              kernels, and the count and time of copy / cast kernels
  5b. graphs  (predict) the captured steps against the eager path: the f32 slice at test size
              (TF32 off) and the blessed bf16 batch replayed bit for bit equal to an eager run;
              K1 = 50, K2 = 2 and K4 = 147 (one a BN site) in a replayed batch by the tallies
              and by the profiler's kernel names (a replayed train step: none of the four);
              host launches, device busy ms and idle share of a replayed and an eager batch;
              frames/s over 5 eager and 5 replayed batches in turns; the capture's
              seconds and pool
  6. eval     the eval entry point, ``engine.runner.run`` in-process, at the blessed config
              (bf16, 4 batches of 64, the viz dumps of batch 0): frames/s over the batches after
              the first, the predict / metrics / host split, peak memory, K1 = 50, K2 = 2
              and K3 = 4 launches a batch (K4's 147 are counted by the predict and graphs
              lines), the headline metrics, the files written, and
              ``--eval_path`` re-scoring the dumped pkl to the object report the eval logged
  7. eval_f32 the metrics and testers on the card against the CPU for the same predictions,
              TF32 left on, within 1e-5 m; then (the ``graphs`` line, part metrics) one blessed
              eval batch's metrics (3 hand testers, 2 object testers, bs 64) eagerly under the
              profiler (device busy, idle share, top kernels, copies) with the alignment and
              the distance blocks timed apart, and replayed: the rows equal bit for bit
  8. modes    at full width: one batch of candidates per integrator (euler, heun, rk4, dpm2m at
              10 steps; dpm3m on the karras grid) replayed through ``make_candidate_step``, K1's
              launches equal to its score evaluations;
              every aggregation choice on one candidate set, K2 held against its plain version
              at the force-selection shape (N = topk_obj^2); the default aggregation timed under
              the eigh and the power quaternion mean
  9. train    the JAX package's training defaults at full width (f32, bs 64, patch 256,
              repeat_num 20, adamw, exp schedule, lr 2e-4) through ``Trainer.train_step`` on one
              fixed batch, eagerly: 1 warm-up and 5 timed steps, steps/s, frames/s, the forward /
              backward / optimizer split, peak memory; every loss finite, the last total below
              the first.  Then (the ``graphs`` line, part train) ``make_train_step``'s graphs:
              the capture (warm-up step, seconds, pool), 5 replays and 5 eager steps in turns
              (steps/s, frames/s), host launches, device busy ms and idle share of one profiled
              replay and one profiled eager step, peak memory
  10. train_f32 one train step at test size (bs 4, patch 64, repeat_num 2) on the card (TF32
              off) against the port on the CPU: same weights, draws and dropout masks; loss
              terms, gradients and BN statistics held.  Then (the ``graphs`` line, part
              train_replay) at that size with the clip binding, MultiSteps over 2 calls and an
              ``exp`` schedule of one step an epoch: 4 calls on the graphs against 4 eager calls
              from the same state and generator (losses, parameters, Adam moments, accumulator,
              BN statistics), bit for bit where two eager runs agree, else within 4x their
              difference, and the tensors where two eager runs differ
  11. train_entry ``engine.runner.run`` with ``--mode train --max_epochs 1`` (bf16, bs 64, patch
              256, the blessed sub-eval flags) on the train step's graphs, then the same epoch
              with the step run eagerly: K1 = 50, K2 = 2 and K3 = 4 launches a sub-eval batch, bf16
              steps/s both ways, every bf16 loss finite, ``epoch_1.state`` and ``final_model.pkl``;
              then a resume from ``epoch_1.state`` restores params, BN statistics, optimizer
              moments and step exactly, and ``--max_epochs 2`` trains the second epoch
  12. data    a mini DexYCB tree (256 frames of 640x480 JPEG, every third hand left) in a
              temporary directory: the decoder, and the loader's items/s at bs 64, patch 256,
              its four batches in flight, for train and eval, host and device mode, with the
              contact labels' cache cold and warm; the native host library must be live, and
              the train passes run once more on its numpy forms
  13. preprocess the device preprocess (``--device_preprocess``) of a bs-64 device-mode batch:
              ms per batch (CUDA events) and peak memory, eval (rectilinear warp) and train
              (two-pass warp and the augmentations), eagerly and replayed
              (``make_device_preprocess``'s graph, equal to the eager run bit for bit); on 4
              samples, the card against the port on the CPU in float32 with the same erase
              noise
  14. data_eval ``--mode eval --eval_full --device_preprocess`` on the tree at the blessed config
              (bf16, 4 batches): frames/s over all batches and with the loader's wait taken
              out; loader wait / preprocess / predict / metrics per batch, K1 = 50, K2 = 2 and
              K3 = 4 launches a batch, every metric finite
  15. data_train ``--mode train --max_epochs 1 --device_preprocess`` on the tree (f32, bs 64,
              patch 256, 4 steps, the blessed sub-eval flags), the step on its graphs: steps/s,
              step spans, loader wait and preprocess per step, finite losses,
              ``epoch_1.state``; the f32 sub-eval runs K2 twice and K3 four times a batch and K1's
              plain form
  16. ho3d    a mini HO3D tree (64 train frames, 10 evaluation frames, 640x480 PNG):
              ``--mode infer`` writes both codalab zips with the evaluation frames in
              ``evaluation.txt`` order (each zip row is its frame's prediction in the OpenGL
              frame); ``--mode train --max_epochs 1 --full_evaluation_freq 1
              --device_preprocess`` runs ``infer_ho3d`` after its epoch
  17. force   offline force labels: first (the ``graphs`` line, part force) a bs-64 fixture
              batch (every third hand left, every fifth sample ungrasped) at the full 3000
              iterations eagerly and on graphs, the forces equal bit for bit, s a batch both
              ways, host launches, device launches, device ms and busy share per iteration of
              each phase (profiled 20-iteration windows), DexYCB s0's hours both ways.  Then the
              batch through ``ForceOptimizer.run_batch`` (graphs): s per batch, iterations/s,
              peak memory; the final force loss below the initial one, ungrasped rows 0.  Then
              bs 8 at 10 + 40 iterations on the
              card against the CPU (TF32 off), ``force_optim_main`` on a 128-frame mini tree
              named ``DexYCB`` (every label read back by ``get_force``; no kernel launched), and
              ``--imagenet_pretrain`` + ``--pretrain x.pth`` through the eval entry point
  18. ddp     data parallelism on the one card (``ddp_phase``): the f32 train step at bs 16,
              patch 256, TF32 off, in an nccl group of one rank (eagerly, and on the train
              step's graphs: a replay, its gradients read back from Adam's first moment) and on
              two gloo ranks (two processes on cuda:0, 2 x 8, eager) against the undistributed
              step; the ranks'
              parameters and BN statistics bit-identical; a blessed eval batch of 64 = 2 x 32
              with K1 = 50, K2 = 2 and K3 = 4 launches a rank and 64 rows gathered
K3's tallies count 2 more launches for each capture of a registry's object-metrics step (its
eager warm-up).  Then the card's ``name, power.limit``, the kernels' JSON line and, last, the
result line.
Any failed check raises, so the script exits non-zero and prints no result.  It needs one
CUDA device and the checkout it sits in; without either it fails.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is the larger
# of bytes / memory rate and operations / peak rate for their type
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def say(**fields):
    print(json.dumps(fields), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def free_memory():
    """Return what deleted trainers held to the card: a trainer's ``TrainStep`` and its
    ``CapturedStep`` refer to each other, so their graphs' pools are freed by the cycle
    collector, not when the last name is deleted."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def k3_launches(registry, batches):
    """K3's launches over ``batches`` eval batches with ``registry``: 4 a batch (two object
    testers, each ADD-S and F-score / Chamfer), 2 more for the eager warm-up before each
    capture of the registry's object-metrics step."""
    from vpho_tpu_torch.engine import tester as TTE

    return 4 * batches + 2 * len(TTE.object_metrics_step(registry).graphs)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def spread_weights(model, gen):
    """Weights for a well-posed f32 comparison: kernels at 1/sqrt(fan_in), small non-zero
    biases, BN statistics away from (0, 1), and heatmap heads biased to positive heat, as a
    trained head's is.  (At init the heads' heat is ~1e-5 and of mixed sign: the cascade's
    normalized fusion weights then divide by a sum near zero and its scores nearly tie, which
    no f32 bar survives.)"""
    import torch

    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("num_batches_tracked", "t_encoder.0.W")):
                continue
            if name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=gen)
            elif t.dim() >= 2:
                fan_in = t.shape[1] if t.dim() == 3 else t[0].numel()
                t.normal_(0.0, fan_in ** -0.5, generator=gen)
            elif name.endswith("weight"):
                t.normal_(1.0, 0.1, generator=gen)
            else:
                t.normal_(0.0, 0.1 if name.endswith("running_mean") else 0.02, generator=gen)
        for head in (model.head_hm_hand, model.head_hm_obj):
            head.final_layer.bias.fill_(1.0)
    return model


# the host's calls that put work on the device, as torch.profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def profiled(fn):
    """``fn()`` under torch.profiler, ended by a synchronize: wall ms (host clock), device busy
    ms (the device-side events' own time), kernel counts by name, and the host's launch calls
    (``LAUNCH_CALLS``) by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    return dict(wall_ms=wall_ms, busy_ms=sum(e.self_device_time_total for e in device) / 1e3,
                kernels={e.key: e.count for e in device},
                kernel_ms={e.key: e.self_device_time_total / 1e3 for e in device},
                host_launches={e.key: e.count for e in events if e.key in LAUNCH_CALLS})


def count_named(counts, needle):
    return sum(n for key, n in counts.items() if needle in key)


def digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def train_step_record(trainer, batch, draws, masks, rows):
    """``trainer.train_step`` run eagerly on ``batch`` with the global draws and masks given;
    returns the losses, the gradients the optimizer saw (on the host) and the BN statistics
    after."""
    import torch

    from vpho_tpu_torch.engine.trainer import _split_state
    from vpho_tpu_torch.models.layers import DropoutMasks

    dev = trainer.device
    seen, step = {}, trainer.optimizer.step
    trainer.optimizer.step = lambda g: (seen.setdefault("g", [x.detach().cpu() for x in g]),
                                        step(g))[1]
    losses = trainer.train_step(
        {k: v.to(dev) for k, v in batch.items()},
        draws={k: (a.to(dev), b.to(dev)) for k, (a, b) in draws.items()},
        dropout=DropoutMasks(masks=[m.to(dev) for m in masks], rows=rows), eager=True)
    torch.cuda.synchronize()
    stats = {k: v.cpu() for k, v in _split_state(trainer.model)["batch_stats"].items()
             if "running" in k}
    return ({k: v.item() for k, v in losses.items()}, dict(zip(trainer.optimizer.names, seen["g"])),
            stats)


def captured_step_record(trainer, batch, draws, masks, rows):
    """``train_step_record`` on the train step's graphs: the first call (the warm-up and the
    capture), then the state put back in place and the second call, a replay.  Its gradients
    are read back from Adam's first moment, which one update from zero makes (1 - b1) g."""
    import torch

    from vpho_tpu_torch.engine.trainer import _split_state
    from vpho_tpu_torch.models.layers import DropoutMasks

    dev, opt = trainer.device, trainer.optimizer
    sd = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    opt_sd = {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v
              for k, v in opt.state_dict().items()}
    args = ({k: v.to(dev) for k, v in batch.items()},
            {k: (a.to(dev), b.to(dev)) for k, (a, b) in draws.items()}, [m.to(dev) for m in masks])
    for call in range(2):
        if call:
            trainer.model.load_state_dict(sd)
            opt.load_state_dict(opt_sd)
        losses = trainer.train_step(args[0], draws=args[1],
                                    dropout=DropoutMasks(masks=args[2], rows=rows))
    torch.cuda.synchronize()
    step = trainer._step("train")
    check(len(step.graph.graphs) == 1 and opt.count == 1, "captured_step_record: no replay")
    stats = {k: v.cpu() for k, v in _split_state(trainer.model)["batch_stats"].items()
             if "running" in k}
    grads = {n: (m / (1.0 - opt.b1)).cpu() for n, m in zip(opt.names, opt.mu)}
    return {k: v.item() for k, v in losses.items()}, grads, stats


HEADS = ("head_mano", "cross_hand", "cross_obj", "head_physics")


def bar_used(ref, run):
    """train_f32's bars for the train step ``run`` (losses, gradients, BN statistics, as
    ``train_step_record`` returns them) against ``ref``: the largest share of a bar used by the
    loss terms (rtol 1e-4), the BN statistics (1e-3 x the largest value) and each module
    group's gradients (rtol 1e-3 for the heads, 1e-2 for the denoisers, 0.15 for the trunk,
    plus 1e-4 x the group's largest gradient norm)."""
    (lr, gr, sr), (l, g, st) = ref, run
    used = {"losses": max(abs(l[k] - lr[k]) / max(abs(lr[k]), 1e-12) for k in lr) / 1e-4,
            "bn": max(((st[k] - sr[k]).abs().max() / sr[k].abs().max().clamp_min(1e-12)).item()
                      for k in sr) / 1e-3}
    scale = {}
    for k, r in gr.items():
        scale[k.split(".")[0]] = max(scale.get(k.split(".")[0], 0.0), r.norm().item())
    for k, r in gr.items():
        grp = k.split(".")[0]
        rtol = 1e-3 if grp in HEADS else 1e-2 if grp.startswith("denoiser") else 0.15
        used[grp] = max(used.get(grp, 0.0),
                        (g[k] - r).norm().item() / (rtol * r.norm().item() + 1e-4 * scale[grp]))
    return used


REPLAY_ARGV = ["--mode", "train", "--batch_size", "4", "--patch_size", "64", "--repeat_num", "2",
               "--gradient_clip", "1e-3", "--gradient_accumulation_steps", "2", "--scheduler",
               "exp", "--gamma", "0.5"]


def train_calls(dev, out_dir, sd, eager, n=4):
    """``n`` ``Trainer.train_step`` calls at ``REPLAY_ARGV``'s settings on one batch from the
    weights ``sd``, randomness from a generator seeded 7: the losses and the moved state by kind
    (on the host)."""
    import torch

    from vpho_tpu_torch.configs.config import get_config
    from vpho_tpu_torch.data import fixtures
    from vpho_tpu_torch.engine.trainer import Trainer

    trainer = Trainer(get_config(REPLAY_ARGV + ["--output_dir", out_dir]), dev)
    trainer.init_state(1)
    trainer.model.load_state_dict(sd)
    batch = fixtures.make_batch(trainer.ctx, seed=0, batch_size=4, patch_size=64)
    gen = torch.Generator(dev).manual_seed(7)
    losses = [trainer.train_step(batch, generator=gen, eager=eager) for _ in range(n)]
    torch.cuda.synchronize()
    opt = trainer.optimizer
    named = {"params": dict(zip(opt.names, opt.params)),
             "moments": {**{f"mu.{k}": t for k, t in zip(opt.names, opt.mu)},
                         **{f"nu.{k}": t for k, t in zip(opt.names, opt.nu)}},
             "acc": dict(zip(opt.names, opt.acc)),
             "bn": {k: b for k, b in trainer.model.named_buffers() if "running" in k},
             "losses": {f"call{i}.{k}": v for i, call in enumerate(losses)
                        for k, v in call.items()}}
    graphs = None if eager else len(trainer._step("train").graph.graphs)
    return {kind: {k: v.detach().float().cpu().clone() for k, v in d.items()}
            for kind, d in named.items()}, graphs


def train_replay_phase(dev, card, out_dir):
    """Phase 10's second part: ``REPLAY_ARGV`` (bs 4, patch 64, f32, TF32 off, the clip binding,
    MultiSteps over 2 calls, the learning rate moving at every update), 4 calls on the train
    step's graphs against 4 eager calls from the same state and generator, cuDNN deterministic.
    Two eager runs first give the noise: the graphs must equal the first bit for bit where the
    two agree, else stay within 4x their largest relative difference of each kind; a host
    value baked into a graph would move the parameters by the learning rate's own change."""
    import warnings

    import torch

    from vpho_tpu_torch.models import vpho as V

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        sd = V.build_model(V.ModelConfig(patch_size=64, repeat_num=2), seed=3,
                           device=dev).state_dict()
        (e1, _), (e2, _) = (train_calls(dev, out_dir, sd, eager=True) for _ in range(2))
        g, n_graphs = train_calls(dev, out_dir, sd, eager=False)
        rel = lambda a, b: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        kinds, differ = {}, {}
        for kind in e1:
            noise = max(rel(e2[kind][k], v) for k, v in e1[kind].items())
            got = max(rel(g[kind][k], v) for k, v in e1[kind].items())
            kinds[kind] = dict(eager_vs_eager=noise, graphs_vs_eager=got,
                               bit_identical=all(torch.equal(g[kind][k], v)
                                                 for k, v in e1[kind].items()))
            differ[kind] = [k for k, v in e1[kind].items() if not torch.equal(e2[kind][k], v)]
            check(got <= 4 * noise, f"train replay {kind}: {got} against eager noise {noise}")
        # where two eager runs differ: which operations have no deterministic form (warned),
        # and whether the deterministic forms make two eager runs agree
        det = None
        if any(differ.values()):
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    (d1, _), (d2, _) = (train_calls(dev, out_dir, sd, eager=True, n=1)
                                        for _ in range(2))
            finally:
                torch.use_deterministic_algorithms(False)
            det = dict(agree=all(torch.equal(d2[kind][k], v) for kind in d1
                                 for k, v in d1[kind].items()),
                       warned=sorted({str(w.message).split(" does not")[0][:100]
                                      for w in caught if "deterministic" in str(w.message)}))
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    check(n_graphs == 1, f"train replay: {n_graphs} graphs")
    say(phase="graphs", part="train_replay", card=card, batch=4, patch=64, calls=4,
        settings=" ".join(REPLAY_ARGV[2:]), tf32=False, cudnn_deterministic=True, kinds=kinds,
        eager_runs_differ_in={k: v[:8] + ([f"... {len(v)} in all"] if len(v) > 8 else [])
                              for k, v in differ.items()},
        deterministic_algorithms=det)


def ddp_rank(dev, work):
    """One of phase 18's two gloo ranks, both on ``cuda:0``: its rows of the f32 train step, then
    one blessed eval batch of 64 (its 32 rows) through ``Trainer.evaluate``."""
    import os

    import torch

    from vpho_tpu_torch.configs.config import get_config
    from vpho_tpu_torch.engine.runner import synthetic_stream
    from vpho_tpu_torch.engine.trainer import Trainer
    from vpho_tpu_torch.ops import bank_mlp as K1
    from vpho_tpu_torch.ops import metric_nn as K3
    from vpho_tpu_torch.ops import min_dist as K2
    from vpho_tpu_torch.parallel import mesh

    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = Trainer(get_config(inp["train_argv"]), dev)
    tr.init_state(8)
    tr.model.load_state_dict(inp["sd"])
    n = inp["batch"]["rgb"].shape[0] // mesh.world_size()
    lo = mesh.rank() * n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, grads, stats = train_step_record(
        tr, {k: v[lo:lo + n] for k, v in inp["batch"].items()}, inp["draws"], inp["masks"],
        mesh.batch_rows(n))
    step_s = time.perf_counter() - t0
    out = {"losses": losses, "step_s": step_s, "params_digest": digest(tr.optimizer.params),
           "stats_digest": digest(stats.values())}
    if mesh.rank() == 0:
        out.update(grads=grads, stats=stats)
    del tr
    free_memory()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    ecfg = get_config(inp["eval_argv"])
    te = Trainer(ecfg, dev)
    te.init_state()
    te.model.load_state_dict(inp["eval_sd"])
    K1.launches = K2.launches = K3.launches = 0
    res = te.evaluate(synthetic_stream(te.ctx, ecfg, 1, 64, seed=53, with_eval_keys=True))
    torch.cuda.synchronize()
    out.update(eval_launches={"bank_mlp": K1.launches, "min_dist": K2.launches,
                              "metric_nn": K3.launches},
               eval_k3_want=k3_launches(te.ctx.registry, 1),
               eval_rows=sum(len(r["index"]) for r in res["collector_res"]),
               eval_local_rows=int(64 // mesh.world_size()),
               eval_report=res["report"], eval_predict_s=res["timing"]["predict_s"])
    torch.save(out, os.path.join(work, f"rank{mesh.rank()}.pt"))


def ddp_phase(dev, card, eval_argv, kernels):
    """Phase 18: data parallelism (``parallel/mesh.py``) on the one card.  (a) an nccl process
    group of one rank; (b) two gloo ranks, two processes on cuda:0 (nccl refuses two ranks on
    one device): the f32 train step at 16 = 2 x 8 against the undistributed step with the same
    weights, draws and masks (train_f32's bars), the ranks' parameters and BN statistics bit-
    identical after it, and a blessed eval batch of 64 = 2 x 32 (K1 50 and K2 2 launches a
    rank, 64 rows gathered).  Two ranks share the card: no scaling figure."""
    import os
    import shutil
    import tempfile

    import torch

    from vpho_tpu_torch.configs.config import get_config
    from vpho_tpu_torch.data import fixtures
    from vpho_tpu_torch.engine.trainer import Trainer
    from vpho_tpu_torch.parallel import mesh

    free_memory()
    ddp_dir = os.path.join("output", "chip_smoke_ddp")
    ddp_argv = ["--mode", "train", "--batch_size", "16", "--patch_size", "256",
                "--output_dir", ddp_dir]        # the training defaults: f32, repeat_num 20
    dcfg = get_config(ddp_argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr_ref = Trainer(dcfg, dev)
    tr_ref.init_state(8)
    gen = torch.Generator().manual_seed(54)
    with torch.no_grad():
        for den in (tr_ref.model.denoiser_hand, tr_ref.model.denoiser_obj):
            l2 = den.head.head[2]
            l2.weight.copy_(torch.randn(l2.weight.shape, generator=gen) * 0.01)
            l2.bias.copy_(torch.randn(l2.bias.shape, generator=gen) * 0.01)
    ddp_sd = {k: v.cpu().clone() for k, v in tr_ref.model.state_dict().items()}
    ddp_batch = {k: v.cpu() for k, v in fixtures.make_batch(tr_ref.ctx, seed=51, batch_size=16,
                                                            patch_size=256).items()}
    R = dcfg.repeat_num
    ddp_draws = {"hand": (torch.rand(R * 16, 1, generator=gen) * (1 - 1e-5) + 1e-5,
                          torch.randn(R * 16, 96, generator=gen)),
                 "obj": (torch.rand(R * 16, 1, generator=gen) * (1 - 1e-5) + 1e-5,
                         torch.randn(R * 16, 9, generator=gen))}
    ddp_masks = [torch.rand(shape, generator=gen) < 0.9 for shape in
                 [(16, 65, 512), (1, 1, 65, 65), (16, 65, 512), (16, 65, 2048), (16, 65, 512)] * 2]
    ref = train_step_record(tr_ref, ddp_batch, ddp_draws, ddp_masks, None)
    # the step's own rounding noise: the undistributed step on images moved by one ulp.  At
    # this size a group of the heads can move past its bar from that alone
    # (bench_torch_bn_variance.py), so a group may use up to 4x what the nudge uses
    tr_ref.init_state(8)
    tr_ref.model.load_state_dict(ddp_sd)
    nudged = dict(ddp_batch, rgb=torch.nextafter(ddp_batch["rgb"],
                                                 torch.full_like(ddp_batch["rgb"], float("inf"))))
    noise = bar_used(ref, train_step_record(tr_ref, nudged, ddp_draws, ddp_masks, None))
    del tr_ref
    free_memory()

    def held(run, what):
        used = bar_used(ref, run)
        over = {g: u for g, u in used.items()
                if u > (1.0 if g in ("losses", "bn") else max(1.0, 4 * noise[g]))}
        check(not over, f"{what}: bars used {used}, a 1-ulp nudge uses {noise}")
        return used

    # (a) nccl, world 1: the gradient all-reduce and the cross-rank BN path
    mesh.init_distributed(torch.device("cuda", 0), backend="nccl",
                          init_method=f"tcp://localhost:{mesh.free_port()}", world=1, rank_=0)
    try:
        tr_a = Trainer(dcfg, dev)
        tr_a.init_state(8)
        tr_a.model.load_state_dict(ddp_sd)
        nccl_used = held(train_step_record(tr_a, ddp_batch, ddp_draws, ddp_masks,
                                           mesh.batch_rows(16)), "ddp nccl world 1")
        del tr_a
        free_memory()
        tr_g = Trainer(dcfg, dev)
        tr_g.init_state(8)
        tr_g.model.load_state_dict(ddp_sd)
        nccl_graph_used = held(captured_step_record(tr_g, ddp_batch, ddp_draws, ddp_masks,
                                                    mesh.batch_rows(16)),
                               "ddp nccl world 1, the train step's graphs")
        del tr_g
    finally:
        mesh.shutdown()
    free_memory()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    # (b) two gloo ranks with CUDA tensors, two processes on cuda:0
    work = tempfile.mkdtemp(prefix="vpho_chip_smoke_ddp_")
    torch.save({"train_argv": ddp_argv, "sd": ddp_sd, "batch": ddp_batch, "draws": ddp_draws,
                "masks": ddp_masks, "eval_sd": ddp_sd,
                "eval_argv": eval_argv[:-2] + ["--viz_freq", "-1", "--output_dir", ddp_dir]},
               os.path.join(work, "inputs.pt"))
    t_start = time.perf_counter()
    mesh.spawn(ddp_rank, 2, torch.device("cuda", 0), work, backend="gloo")
    ddp_wall_s = time.perf_counter() - t_start
    r0, r1 = (torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in (0, 1))
    shutil.rmtree(work)
    mean_losses = {k: (r0["losses"][k] + r1["losses"][k]) / 2 for k in r0["losses"]}
    gloo_used = held((mean_losses, r0["grads"], r0["stats"]), "ddp gloo 2 x 8")
    identical = (r0["params_digest"] == r1["params_digest"]
                 and r0["stats_digest"] == r1["stats_digest"])
    rank_launches = [r["eval_launches"] for r in (r0, r1)]
    say(phase="ddp", card=card, note="two ranks share one card: not a scaling figure",
        train=dict(batch="16 = 2 x 8", patch=256, repeat_num=R, dtype="float32", tf32=False),
        nudge_bar_used=noise, nccl_world1_bar_used=nccl_used,
        nccl_world1_graphs_bar_used=nccl_graph_used, gloo_2x8_bar_used=gloo_used,
        ranks_bit_identical=identical, gloo_step_s=[r0["step_s"], r1["step_s"]],
        eval=dict(batch="64 = 2 x 32", sample_num=100, steps=50, dtype="bfloat16",
                  launches_per_rank=rank_launches, rows_gathered=r0["eval_rows"],
                  predict_s_per_rank=[r0["eval_predict_s"], r1["eval_predict_s"]]),
        wall_s=ddp_wall_s)
    check(identical, "ddp: the ranks' parameters or BN statistics differ after the step")
    check(all(r["eval_launches"] == {"bank_mlp": 50, "min_dist": 2, "metric_nn": r["eval_k3_want"]}
              for r in (r0, r1)), f"ddp eval launches per rank {rank_launches}")
    check(r0["eval_rows"] == r1["eval_rows"] == 64 and r0["eval_report"] == r1["eval_report"],
          f"ddp eval rows {r0['eval_rows']}, {r1['eval_rows']}")
    for name in kernels:
        kernels[name]["launches_by_path"]["ddp_eval_per_rank"] = rank_launches[0][name]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        from vpho_tpu_torch.data import fixtures
        from vpho_tpu_torch.models import denoiser as DEN
        from vpho_tpu_torch.models import vpho as V
        from vpho_tpu_torch.ops import bank_mlp as K1
        from vpho_tpu_torch.ops import bn_act as K4
        from vpho_tpu_torch.ops import cuda_build
        from vpho_tpu_torch.ops import metric_nn as K3
        from vpho_tpu_torch.ops import min_dist as K2
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    # ---- 1. build -------------------------------------------------------------------------
    nvcc_s = cuda_build.build_all()
    ptxas = {name: cuda_build.ptxas_report(name) for name in cuda_build.SOURCES}
    say(phase="build", nvcc_s=round(nvcc_s, 3), sources=list(cuda_build.SOURCES), card=card,
        torch=torch.__version__, cuda=torch.version.cuda, ptxas=ptxas)
    for name, rep in ptxas.items():
        check(rep["spill_bytes"] == 0, f"{name}: ptxas spills {rep['spill_bytes']} bytes")

    # the blessed configuration and its model (random weights from a seed; the denoisers'
    # zero-initialised last layer gets small random values so the ODE's score is non-zero)
    cfg = V.ModelConfig(patch_size=256, sample_num=100, sampling_steps=50, topk_hand=30,
                        topk_obj=10, compute_dtype="bfloat16")
    ctx = V.make_context(cfg, device=dev)
    model = V.build_model(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for den in (model.denoiser_hand, model.denoiser_obj):
            l2 = den.head.head[2]
            l2.weight.copy_(torch.randn(l2.weight.shape, generator=gen) * 0.01)
            l2.bias.copy_(torch.randn(l2.bias.shape, generator=gen) * 0.01)
    B, S = 64, cfg.sample_num
    batch = fixtures.make_batch(ctx, seed=2, batch_size=B, patch_size=cfg.patch_size)
    x0 = V.draw_x0(ctx, B, torch.Generator().manual_seed(3))
    kernels = {}

    # ---- 2a. K1 bank_mlp: the first ODE step's operands from the blessed model ------------
    with torch.inference_mode():
        den = model.denoiser_hand
        feat_proj = den.precompute_feat(model.trunk(batch)["encoding_hand"])
        t0 = torch.full((1, 1), cfg.sample_T0, device=dev)
        t_feat, pose_feat = den.tp_feat(x0[:, :96], t0)
        fused = den.head.prepare_fused(feat_proj)
        p, add = den.head.fused_inputs(t_feat, pose_feat, fused)
        wk = fused.weights
    w1, w2 = K1.unprepare(wk)
    b2 = wk.b2
    g = torch.Generator().manual_seed(4)

    def bank_case(b, s, n=32, o=3):
        bf = torch.bfloat16
        r = lambda *shape, sc=1.0, dt=torch.float32: (torch.randn(*shape, generator=g) * sc).to(dev, dt)
        return (r(b * s, 256, dt=bf), r(n, 256, 256, sc=0.027, dt=bf), r(b, n, 256),
                r(n, 256, o, sc=0.01, dt=bf), r(n, o, sc=0.01))

    # edges: R < 64; tiles spanning up to 4 samples (add rows staged with the tile) and more
    # (read from L2); n = 1 and 5, not a multiple of the row ranges per bank; O = 1..4.
    # Bar atol 1e-3 / rtol 1e-2: a hidden value on a bf16 rounding boundary may round either
    # way in the two summation orders, and that one-ulp flip times |W2| (0.01 here, as the
    # blessed model's) stays under 1e-3.
    k1_err, k1_cases = 0.0, {}
    for name, ops, s in (("blessed", (p, w1, add, w2, b2), S),
                         ("B1_S37", bank_case(1, 37), 37), ("B3_S16", bank_case(3, 16), 16),
                         ("B2_S150", bank_case(2, 150), 150),
                         ("B20_S5_n5_O1", bank_case(20, 5, 5, 1), 5),
                         ("B7_S9_n1_O4", bank_case(7, 9, 1, 4), 9),
                         ("B4_S37_n5_O2", bank_case(4, 37, 5, 2), 37),
                         ("B3_S100_n1_O3", bank_case(3, 100, 1, 3), 100)):
        got = K1.bank_mlp(*ops, s) if name != "blessed" else K1.bank_mlp_prepared(p, wk, add, s)
        ref = K1.bank_mlp_plain(*ops, s)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        check(torch.allclose(got, ref, rtol=1e-2, atol=1e-3), f"K1 {name}: max err {err}")
        k1_cases[name] = err
        k1_err = max(k1_err, err)
    R, n, D, O = p.shape[0], w1.shape[0], w1.shape[2], w2.shape[2]

    def k1_library():
        h = torch.matmul(p, w1)                                       # (n, R, D) bf16
        h = torch.relu(h.view(n, B, S, D) + add.transpose(0, 1)[:, :, None]).to(torch.bfloat16)
        return torch.bmm(h.view(n, R, D), w2)

    flops = K1.flops(R, p.shape[1], D, n, O)
    k1_bytes = nbytes(p, w1, add, w2, b2) + R * n * O * 4
    kernels["bank_mlp"] = dict(
        name="bank_mlp", route="cuda", source="vpho_tpu_torch/csrc/bank_mlp.cu",
        replaces="vpho_tpu/ops/pallas_bank.py:48 (_kernel; pallas_call at :92)",
        max_abs_err=k1_err,
        ms=cuda_ms(lambda: K1.bank_mlp_prepared(p, wk, add, S), 50),
        plain_ms=cuda_ms(lambda: K1.bank_mlp_plain(p, w1, add, w2, b2, S), 10),
        library_ms=cuda_ms(k1_library, 20),
        bound_ms=max(flops / PEAK_BF16_FLOPS, k1_bytes / PEAK_BYTES) * 1e3,
        bound_by="operations" if flops / PEAK_BF16_FLOPS > k1_bytes / PEAK_BYTES else "bytes")
    say(phase="kernel", cases=k1_cases, **{k: v for k, v in kernels["bank_mlp"].items()
                                           if k not in ("source", "replaces", "route")})

    # ---- 2b. K2 min_dist: stage-4 and stage-5 shapes against the registry's vertices -------
    verts = ctx.registry.verts_sampled[batch["obj_id"].long()].contiguous()   # (64, 2048, 3)

    def dist_case(nc):
        return (torch.randn(B, nc, 32, 3, generator=g) * 0.08).to(dev).contiguous()

    def k2_hold(name, fp, vv):
        """K2 against its plain version on the same inputs: dist within 1e-5, idx equal at
        every clear minimum and never worse than the plain pick.  Returns the dist error."""
        d, i = K2.min_dist_and_idx(fp, vv)
        d_ref, i_ref = K2.min_dist_plain(fp, vv)
        torch.cuda.synchronize()
        err = (d - d_ref).abs().max().item()
        check(err <= 1e-5, f"K2 {name}: dist err {err}")
        fd, vd = fp.double(), vv.double()
        d2 = ((fd * fd).sum(-1)[..., None] + (vd * vd).sum(-1)[:, None, None]
              - 2.0 * torch.einsum("bnkd,bvd->bnkv", fd, vd))
        scale = d2.max()
        two = d2.topk(2, dim=-1, largest=False).values
        clear = (two[..., 1] - two[..., 0]) > 1e-6 * scale
        check(bool((i == i_ref)[clear].all()), f"K2 {name}: argmin differs at a clear minimum")
        pick = lambda ix: d2.gather(-1, ix.long()[..., None])[..., 0]
        check(bool((pick(i) <= pick(i_ref) + 1e-6 * scale).all()), f"K2 {name}: argmin not minimal")
        return err

    cases = (("stage4", dist_case(100), verts), ("stage5", dist_case(31), verts),
             ("N1", dist_case(1)[:2].contiguous(), verts[:2].contiguous()))
    k2_err = max(k2_hold(name, fp, vv) for name, fp, vv in cases)
    fp4, fp5 = cases[0][1], cases[1][1]

    def k2_bound(fp):
        k2_flops = K2.flops(fp[..., 0].numel(), verts.shape[1])
        k2_bytes = nbytes(fp, verts) + fp[..., 0].numel() * 8
        by = "operations" if k2_flops / PEAK_FP32_FLOPS > k2_bytes / PEAK_BYTES else "bytes"
        return max(k2_flops / PEAK_FP32_FLOPS, k2_bytes / PEAK_BYTES) * 1e3, by

    (bound4, by4), (bound5, _) = k2_bound(fp4), k2_bound(fp5)
    kernels["min_dist"] = dict(
        name="min_dist", route="cuda", source="vpho_tpu_torch/csrc/min_dist.cu",
        replaces="vpho_tpu/ops/pallas_dist.py:31 (_kernel; pallas_call at :56)",
        max_abs_err=k2_err,
        ms=cuda_ms(lambda: K2.min_dist_and_idx(fp4, verts), 50),
        plain_ms=cuda_ms(lambda: K2.min_dist_plain(fp4, verts), 10),
        library_ms=cuda_ms(lambda: torch.cdist(fp4.view(B, -1, 3), verts).min(-1), 10),
        bound_ms=bound4, bound_by=by4,
        stage5_ms=cuda_ms(lambda: K2.min_dist_and_idx(fp5, verts), 50),
        stage5_bound_ms=bound5,
        stage5_plain_ms=cuda_ms(lambda: K2.min_dist_plain(fp5, verts), 10),
        stage5_library_ms=cuda_ms(lambda: torch.cdist(fp5.view(B, -1, 3), verts).min(-1), 10))
    say(phase="kernel", **{k: v for k, v in kernels["min_dist"].items()
                           if k not in ("source", "replaces", "route")})

    # ---- 2c. K3 metric_nn: an eval batch's distance calls on the registry's meshes --------
    from vpho_tpu_torch.engine import metrics as TM
    from vpho_tpu_torch.utils import transforms as TT

    k3_reg, k3_ids = ctx.registry, batch["obj_id"].long()
    rg = torch.Generator().manual_seed(5)
    rot = lambda sc: TT.axis_angle_to_matrix(torch.randn(B, 3, generator=rg) * sc)
    k3_R = rot(1.0)
    k3_t = torch.cat([torch.randn(B, 2, generator=rg) * 0.02,
                      0.5 + torch.rand(B, 1, generator=rg) * 0.2], -1)
    k3_gt = torch.cat([k3_R, k3_t[..., None]], -1).to(dev)
    k3_t = k3_t + torch.randn(B, 3, generator=rg) * 0.005
    k3_pd = torch.cat([rot(0.05) @ k3_R, k3_t[..., None]], -1).to(dev)
    # the object tester's two calls: F-score / Chamfer on the padded full meshes, ADD-S on the
    # sampled points
    vf, vs = k3_reg.verts_full[k3_ids], k3_reg.verts_sampled[k3_ids]
    k3_calls = {"full": (TM._apply_rt(vf, k3_pd), TM._apply_rt(vf, k3_gt),
                         k3_reg.verts_full_mask[k3_ids]),
                "sampled": (TM._apply_rt(vs, k3_pd), TM._apply_rt(vs, k3_gt), None)}

    def k3_library(a, b):                   # a time yardstick only: cdist rounds otherwise
        d = torch.cdist(a, b)
        return d.amin(-1), d.amin(-2)

    k3_cases = {}
    for name, (a, b, m) in k3_calls.items():
        got, ref = K3.nearest(a, b, m), K3.nearest_plain(a, b, m)
        torch.cuda.synchronize()
        differ = sum(int((g.view(torch.int32) != r.view(torch.int32)).sum())
                     for g, r in zip(got, ref))
        check(differ == 0, f"K3 {name}: {differ} minima differ from the plain form's bits")
        P, Q = a.shape[1], b.shape[1]
        k3_flops = K3.flops(B, P, Q)
        k3_bytes = nbytes(a, b) + (0 if m is None else nbytes(m)) + 4 * B * (P + Q)
        k3_cases[name] = dict(
            shape=[B, P, Q], masked=m is not None, bit_identical=True,
            ms=cuda_ms(lambda: K3.nearest(a, b, m), 50),
            bound_ms=max(k3_flops / PEAK_FP32_FLOPS, k3_bytes / PEAK_BYTES) * 1e3,
            bound_by="operations" if k3_flops / PEAK_FP32_FLOPS > k3_bytes / PEAK_BYTES
            else "bytes",
            plain_ms=cuda_ms(lambda: K3.nearest_plain(a, b, m), 3),
            library_ms=cuda_ms(lambda: k3_library(a, b), 5))
    k3_batch = lambda key: 2 * sum(c[key] for c in k3_cases.values())   # two object testers
    kernels["metric_nn"] = dict(
        name="metric_nn", route="cuda", source="vpho_tpu_torch/csrc/metric_nn.cu",
        replaces="none: the JAX package leaves the metrics' distance blocks to XLA",
        bit_identical=True, ms=k3_batch("ms"), bound_ms=k3_batch("bound_ms"),
        bound_by="operations", plain_ms=k3_batch("plain_ms"),
        library_ms=k3_batch("library_ms"), per_call=k3_cases)
    say(phase="kernel", per="eval batch (4 launches)",
        **{k: v for k, v in kernels["metric_nn"].items()
           if k not in ("source", "replaces", "route")})
    del k3_calls, vf, vs

    # ---- 2d. K4 bn_act: every BN site of the blessed trunk at B 64 -------------------------
    from vpho_tpu_torch.models import layers as LY

    k4_sites, k4_real = [], K4.bn_act

    def k4_record(x, mean, var, weight, bias, eps, act=None, residual=None):
        k4_sites.append((x.clone(), act, None if residual is None else residual.clone()))
        return k4_real(x, mean, var, weight, bias, eps, act, residual)

    K4.bn_act = k4_record
    try:
        with torch.inference_mode():
            model.trunk(batch)
    finally:
        K4.bn_act = k4_real
    n_sites = len(k4_sites)
    check(n_sites == 147, f"K4: the blessed trunk has {n_sites} BN sites, not 147")
    rg = torch.Generator().manual_seed(6)
    k4, k4_bns = dict(bytes=0, channels_last_sites=0), []
    for x, act, res in k4_sites:
        bn = LY.BatchNorm2d(x.shape[1])
        with torch.no_grad():               # statistics away from (0, 1), as spread_weights'
            bn.running_mean.normal_(0.0, 0.1, generator=rg)
            bn.running_var.uniform_(0.5, 1.5, generator=rg)
            bn.weight.normal_(1.0, 0.1, generator=rg)
            bn.bias.normal_(0.0, 0.02, generator=rg)
        bn = bn.to(dev).eval()
        k4_bns.append(bn)
        with torch.inference_mode():
            got = K4.bn_act(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps,
                            act, res)
            want = LY.bn_act_plain(bn, x, act, res)
            check(torch.equal(got, want) and got.stride() == want.stride(),
                  f"K4 {tuple(x.shape)} {act} residual={res is not None}: differs from the "
                  f"plain chain in {int((got != want).sum())} elements")
        k4["bytes"] += K4.traffic(x, res)
        k4["channels_last_sites"] += int(not x.is_contiguous())

    def k4_batch(plain):
        """A replay's 147 sites, K4 or the plain chain, captured as one graph (as the predict
        graph replays them, without the host's launch time)."""
        def sites():
            for (x, act, res), bn in zip(k4_sites, k4_bns):
                if plain:
                    LY.bn_act_plain(bn, x, act, res)
                else:
                    K4.bn_act(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps,
                              act, res)

        with torch.inference_mode():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                sites()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                sites()
        ms = cuda_ms(graph.replay, 10)
        del graph
        return ms

    k4.update(ms=k4_batch(False), plain_ms=k4_batch(True),
              bound_ms=k4["bytes"] / PEAK_BYTES * 1e3)
    k4_row = dict(name="bn_act", route="cuda", source="vpho_tpu_torch/csrc/bn_act.cu",
                  replaces="none: the JAX package leaves batch norm to XLA",
                  bit_identical=True, sites=n_sites, bound_by="bytes", **k4)
    say(phase="kernel", per="eval batch (147 launches, one a BN site)",
        **{k: v for k, v in k4_row.items() if k not in ("source", "replaces", "route")})
    del k4_sites, k4_bns
    free_memory()

    # ---- 3. f32 slice on the card against the same port on the CPU ------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = V.ModelConfig(patch_size=64, sample_num=4, sampling_steps=5, topk_hand=3, topk_obj=2)
    cpu = torch.device("cpu")
    m_cpu = spread_weights(V.build_model(small, seed=5, device=cpu), gen)
    m_gpu = V.build_model(small, seed=5, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    ctx_cpu, ctx_gpu = V.make_context(small, device=cpu), V.make_context(small, device=dev)
    b_cpu = fixtures.make_batch(ctx_cpu, seed=6, batch_size=2, patch_size=64)
    # bboxes past the crop keep every candidate inside its heatmap: outside it the heat is
    # exactly +-0 and the ties' order would rest on the sign of a zero
    for k in ("bbox_hand", "bbox_hand_rect", "bbox_obj", "bbox_obj_rect"):
        b_cpu[k] = torch.tensor([[-100.0, -100.0, 164.0, 164.0]]).repeat(2, 1)
    x0_small = V.draw_x0(ctx_cpu, 2, torch.Generator().manual_seed(7))
    out_cpu = V.forward_predict(m_cpu, ctx_cpu, b_cpu, x0=x0_small)
    out_gpu = V.forward_predict(m_gpu, ctx_gpu, {k: v.to(dev) for k, v in b_cpu.items()},
                                x0=x0_small.to(dev))
    f32_err = {k: (out_gpu[k].cpu() - out_cpu[k]).abs().max().item() for k in out_cpu}
    for k in ("diff_final_hand_mano", "diff_final_obj_6d"):
        check(f32_err[k] <= 1e-3, f"f32 {k}: {f32_err[k]}")
    for k in ("agg_obj_6d", "agg_hand_mano", "agg_hand_vert", "agg_hand_joint"):
        check(f32_err[k] <= 5e-4, f"f32 {k}: {f32_err[k]}")
    say(phase="f32", max_abs_err=f32_err)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    # ---- 4. the blessed predict path, bf16 policy, through the predict step ---------------
    from vpho_tpu_torch.engine.trainer import make_candidate_step, make_predict_step

    torch.cuda.reset_peak_memory_stats()
    predict_step = make_predict_step(model, ctx)
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    predict_step.capture(batch, x0)                 # the eager warm-up, then the capture
    torch.cuda.synchronize()
    capture_wall_s = time.perf_counter() - t_start
    K1.launches = K2.launches = K3.launches = K4.launches = 0
    n_batches, times = 3, []
    for _ in range(n_batches):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        pd = predict_step(batch, x0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t_start)
    launches = {"bank_mlp": K1.launches, "min_dist": K2.launches, "metric_nn": K3.launches}
    check(launches == {"bank_mlp": 50 * n_batches, "min_dist": 2 * n_batches, "metric_nn": 0},
          f"launch counts {launches}")
    k4_row["launches"] = K4.launches
    check(K4.launches == n_sites * n_batches, f"K4 launched {K4.launches} times in "
                                              f"{n_batches} replays of {n_sites} sites")
    shapes = {"reg_hand_vert": (B, 778, 3), "hand_heatmap": (B, 21, 64, 64),
              "obj_heatmap": (B, 27, 64, 64), "diff_final_hand_mano": (B, S, 58),
              "diff_final_hand_vert": (B, S, 778, 3), "diff_final_obj_6d": (B, S, 9),
              "agg_obj_6d": (B, 9), "agg_hand_mano": (B, 58), "agg_hand_vert": (B, 778, 3),
              "agg_hand_joint": (B, 21, 3)}
    for k, shape in shapes.items():
        check(tuple(pd[k].shape) == shape, f"{k} shape {tuple(pd[k].shape)}")
        check(bool(torch.isfinite(pd[k]).all()), f"{k} has non-finite values")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name in kernels:
        kernels[name]["launches"] = launches[name]

    # per-stage split on one more batch (host clock around synchronised calls)
    def wall(fn):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t_start) * 1e3

    # (eager: the stages of one graph cannot be timed apart)
    with torch.inference_mode():
        trunk_ms = wall(lambda: model.trunk(batch))
    cand_ms = wall(lambda: V.forward_candidates(model, ctx, batch, x0=x0))
    total_ms = wall(lambda: V.forward_predict(model, ctx, batch, x0=x0))
    say(phase="predict", batch=B, sample_num=S, steps=cfg.sampling_steps, dtype="bfloat16",
        path="make_predict_step, replayed", capture_wall_s=capture_wall_s, batch_s=times,
        frames_per_s=B * len(times) / sum(times), peak_mem_gb=peak_gb, launches=launches,
        eager_split_ms=dict(trunk=trunk_ms, ode_and_fk=cand_ms - trunk_ms,
                            aggregation=total_ms - cand_ms, total=total_ms))

    # ---- 4b. the blessed ODE with K1's plain version bound into the denoiser ------------
    # Kernel and plain differ only where a hidden value rounds to the other bf16 neighbour;
    # over 50 steps that stays far inside 1e-2 on the final hand parameters (axis-angle
    # radians and shape), while a wrong tile, row or bank would move them by the score's scale.
    ode_band = 1e-2
    kernel_mano = V.forward_candidates(model, ctx, batch, x0=x0)[0]["diff_final_hand_mano"]
    bound_k1 = DEN.bank_mlp_prepared
    DEN.bank_mlp_prepared = K1.bank_mlp_prepared_plain
    try:
        before = K1.launches
        plain_mano = V.forward_candidates(model, ctx, batch, x0=x0)[0]["diff_final_hand_mano"]
        check(K1.launches == before, "the plain ODE run launched K1")
    finally:
        DEN.bank_mlp_prepared = bound_k1
    ode_err = (kernel_mano - plain_mano).abs().max().item()
    check(ode_err <= ode_band, f"ODE with kernel K1 vs plain K1: {ode_err} > {ode_band}")
    say(phase="ode", steps=cfg.sampling_steps, max_abs_diff=ode_err, band=ode_band,
        scale=plain_mano.abs().max().item())

    # ---- 5. where the device time goes: one batch under torch.profiler ------------------
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms = wall(lambda: V.forward_predict(model, ctx, batch, x0=x0))
    # device-side events only: an aten op's row repeats the time of the kernels it launched
    stats = [e for e in prof.key_averages() if e.self_device_time_total > 0
             and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in stats) / 1e3
    top = sorted(stats, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    copies = [e for e in stats if "copy" in e.key.lower() or "cast" in e.key.lower()]
    say(phase="profile", wall_ms=prof_ms, device_busy_ms=busy_ms,
        device_idle_share=1.0 - busy_ms / prof_ms,
        copy_cast=dict(launches=sum(e.count for e in copies),
                       ms=sum(e.self_device_time_total for e in copies) / 1e3),
        top=[[e.key[:70], round(e.self_device_time_total / 1e3, 3), e.count] for e in top])

    # ---- 5b. graphs (predict): the captured steps against the eager path ------------------
    # (a) the f32 slice at test size, TF32 off: a replay equal to the eager run bit for bit.
    # cuDNN's deterministic algorithms: in float32 its transposed convolution (the heatmap
    # heads' deconvolutions) may sum with atomics, and two eager runs then differ as well
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b_gpu, x0_gpu = {k: v.to(dev) for k, v in b_cpu.items()}, x0_small.to(dev)
    twice = [V.forward_predict(m_gpu, ctx_gpu, b_gpu, x0=x0_gpu) for _ in range(2)]
    f32_eager_vs_eager = {k: (twice[0][k] - v).abs().max().item() for k, v in twice[1].items()
                          if not torch.equal(twice[0][k], v)}       # the default algorithms
    del twice
    torch.backends.cudnn.deterministic = True
    f32_eager = V.forward_predict(m_gpu, ctx_gpu, b_gpu, x0=x0_gpu)
    f32_step = make_predict_step(m_gpu, ctx_gpu)
    f32_replay = f32_step(b_gpu, x0_gpu)
    torch.backends.cudnn.deterministic = False
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    f32_differ = sorted(k for k, v in f32_eager.items() if not torch.equal(f32_replay[k], v))
    check(not f32_differ, f"graphs f32: replay differs from the eager run in {f32_differ}")
    del f32_step, f32_eager, f32_replay
    # (b) the blessed bf16 batch, cuDNN deterministic, its own capture: replay against eager;
    # then phase 4's step (cuDNN's default algorithms) against an eager run, recorded only
    torch.backends.cudnn.deterministic = True
    det_step = make_predict_step(model, ctx)
    bf16_eager = V.forward_predict(model, ctx, batch, x0=x0)
    bf16_replay = det_step(batch, x0)
    torch.backends.cudnn.deterministic = False
    bf16_differ = sorted(k for k, v in bf16_eager.items() if not torch.equal(bf16_replay[k], v))
    check(not bf16_differ, f"graphs bf16: replay differs from the eager run in {bf16_differ}")
    del det_step, bf16_eager, bf16_replay
    bf16_eager, bf16_replay = V.forward_predict(model, ctx, batch, x0=x0), predict_step(batch, x0)
    default_differ = sorted(k for k, v in bf16_eager.items() if not torch.equal(bf16_replay[k], v))
    del bf16_eager, bf16_replay
    # (c) one replayed batch and one eager batch under the profiler; the tallies of the replay
    K1.launches = K2.launches = K3.launches = K4.launches = 0
    rep = profiled(lambda: predict_step(batch, x0))
    rep_tallies = {"bank_mlp": K1.launches, "min_dist": K2.launches, "metric_nn": K3.launches,
                   "bn_act": K4.launches}
    rep_profiler = {"bank_mlp": count_named(rep["kernels"], "bank_mlp_kernel"),
                    "min_dist": count_named(rep["kernels"], "min_dist_kernel"),
                    "metric_nn": count_named(rep["kernels"], "metric_nn_kernel"),
                    "bn_act": count_named(rep["kernels"], "bn_act_kernel")}
    eag = profiled(lambda: V.forward_predict(model, ctx, batch, x0=x0))
    check(rep_tallies == rep_profiler == {"bank_mlp": 50, "min_dist": 2, "metric_nn": 0,
                                          "bn_act": n_sites},
          f"graphs: a replayed batch's launches, tallies {rep_tallies}, profiler {rep_profiler}")
    check(count_named(rep["kernels"], "bn_fw_inf") == 0,
          "graphs: a replayed eval batch still launched cuDNN's inference batch norm")
    # (d) frames/s, eager and replayed in turns
    eager_ms, replay_ms = [], []
    for _ in range(6):
        eager_ms.append(wall(lambda: V.forward_predict(model, ctx, batch, x0=x0)))
        replay_ms.append(wall(lambda: predict_step(batch, x0)))
    graph = next(iter(predict_step.graphs.values()))[1]
    window = lambda p: dict(wall_ms=p["wall_ms"], device_busy_ms=p["busy_ms"],
                            device_idle_share=1.0 - p["busy_ms"] / p["wall_ms"],
                            kernels=sum(p["kernels"].values()),
                            host_launches=sum(p["host_launches"].values()),
                            host_launch_calls=p["host_launches"])
    say(phase="graphs", part="predict", card=card, batch=B, sample_num=S,
        steps=cfg.sampling_steps, f32_test_size_bit_identical=True, bf16_bit_identical=True, cudnn_deterministic=True,
        default_algorithms_replay_vs_eager_differ=default_differ,
        f32_default_algorithms_eager_vs_eager_max_abs_diff=f32_eager_vs_eager,
        replayed_launches=dict(tallies=rep_tallies, profiler=rep_profiler),
        replayed=window(rep), eager=window(eag),
        frames_per_s=dict(eager=B * 5 / sum(eager_ms[1:]) * 1e3,
                          replayed=B * 5 / sum(replay_ms[1:]) * 1e3),
        batch_ms=dict(eager=eager_ms[1:], replayed=replay_ms[1:]),
        capture_s=graph.seconds, capture_and_warmup_wall_s=capture_wall_s,
        pool_gb=graph.pool_bytes / 1e9)
    for name in kernels:
        kernels[name]["launches_by_path_replayed_batch"] = rep_tallies[name]
    k4_row["launches_by_path_replayed_batch"] = rep_tallies["bn_act"]

    # ---- 6. eval: the eval entry point in-process at the blessed config, bf16 ------------
    import dataclasses
    import math
    import os
    import pickle

    import numpy as np

    from vpho_tpu_torch.configs.config import get_config
    from vpho_tpu_torch.diffusion import sampler as SAMP
    from vpho_tpu_torch.engine import metrics as TM
    from vpho_tpu_torch.engine import runner
    from vpho_tpu_torch.engine import tester as TTE
    from vpho_tpu_torch.engine import viz
    from vpho_tpu_torch.models import aggregation as AGG
    from vpho_tpu_torch.utils import transforms as TT

    out_dir = os.path.join("output", "chip_smoke")
    eval_argv = ["--mode", "eval", "--eval_full", "--eval_batch_size", "64", "--patch_size", "256",
                 "--sample_num", "100", "--sampling_steps", "50", "--topk_hand", "30",
                 "--topk_obj", "10", "--sample_T0", "0.65", "--compute_dtype", "bfloat16",
                 "--output_dir", out_dir]          # --viz_freq 50: the viz dumps of batch 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K1.launches = K2.launches = K3.launches = 0
    t_start = time.perf_counter()
    trainer = runner.run(get_config(eval_argv))
    torch.cuda.synchronize()
    eval_wall_s = time.perf_counter() - t_start
    eval_launches = {"bank_mlp": K1.launches, "min_dist": K2.launches, "metric_nn": K3.launches}
    eval_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res, tm = trainer.last_eval, trainer.last_eval["timing"]
    n_eval = len(tm["frames"])
    check(n_eval == 4 and tm["frames"] == [64] * 4, f"eval batches {tm['frames']}")
    check(eval_launches == {"bank_mlp": 50 * n_eval, "min_dist": 2 * n_eval,
                            "metric_nn": k3_launches(trainer.ctx.registry, n_eval)},
          f"eval launch counts {eval_launches}")
    steady = slice(1, None)                # batch 0 also counts the graph's operations
    per_batch = {k: sum(tm[k][steady]) / (n_eval - 1) * 1e3
                 for k in ("batch_s", "predict_s", "metrics_s")}
    hand, obj = res["report"]["hand"]["agg_candidate"], res["report"]["object"]["mean_candidate_pose"]
    headline = {"hand_MJE_mm": float(hand["MJE"]["both"]), "hand_PA_MJE_mm": float(hand["PA_MJE"]["both"]),
                "hand_MVE_mm": float(hand["MVE"]["both"]),
                **{f"obj_{k}": obj[k]["average_instance"] for k in ("MCE", "ADD", "ADDS", "CD",
                                                                    "ADDS01d", "FSCORE@10mm")}}
    check(all(math.isfinite(v) for v in headline.values()), f"eval headline {headline}")
    files = sorted(os.path.relpath(os.path.join(r, f), trainer.save_dir)
                   for r, _, fs in os.walk(trainer.save_dir) for f in fs)
    pkl_name = "my-prediction_align-2023_CVPR_HFL.pkl"
    want = {"info.log", pkl_name, "viz/0_hand_reg_&_diff_mean.pkl",
            "viz/0_hand_multihyperthesis.pkl", "viz/0_obj_multihyperthesis.pkl",
            "viz/0_optimized_force.pkl"}
    if viz.jpg_writer_available():
        want |= {"viz/0_gt&pd_hand_heatmap.jpg", "viz/0_gt&pd_obj_heatmap.jpg"}
    check(set(files) == want, f"eval files {files}")
    rescored = runner.run(get_config(["--eval_path", os.path.join(trainer.save_dir, pkl_name)]))
    for k, table in obj.items():           # the dump has no camera: REP re-scores on a nominal K
        key = f"{k} (nominal-K!)" if k.startswith("REP") else k
        check(key in rescored, f"eval_path misses {key}")
        if key == k:
            check(rescored[k] == table, f"eval_path {k}: {rescored[k]} != {table}")
    say(phase="eval", batches=n_eval, batch=64, sample_num=100, steps=50, dtype="bfloat16",
        wall_s=eval_wall_s, frames_per_s=sum(tm["frames"][steady]) / sum(tm["batch_s"][steady]),
        per_batch_ms=dict(total=per_batch["batch_s"], predict=per_batch["predict_s"],
                          metrics=per_batch["metrics_s"],
                          host=per_batch["batch_s"] - per_batch["predict_s"] - per_batch["metrics_s"]),
        batch0_ms=tm["batch_s"][0] * 1e3, peak_mem_gb=eval_peak_gb, launches=eval_launches,
        headline=headline, files=files, jpg=viz.jpg_writer_available())

    # ---- 7. eval_f32: metrics and testers on the card against the CPU, TF32 left on --------
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    rng = np.random.RandomState(11)
    n = 8
    R = TT.axis_angle_to_matrix(torch.from_numpy(rng.randn(n, 3).astype(np.float32)))
    t = torch.from_numpy(np.concatenate([rng.randn(n, 2) * 0.02, 0.5 + rng.rand(n, 1) * 0.2],
                                        -1).astype(np.float32))
    gt_rt = torch.cat([R, t[..., None]], -1)
    dR = TT.axis_angle_to_matrix(torch.from_numpy(rng.randn(n, 3).astype(np.float32) * 0.05))
    pd_rt = torch.cat([dR @ R, (t + torch.from_numpy(rng.randn(n, 3).astype(np.float32)) * 0.005)[..., None]], -1)
    cam = torch.tensor([[300.0, 0, 128], [0, 300.0, 128], [0, 0, 1]]).repeat(n, 1, 1)
    cam[:, :2, :2] *= torch.from_numpy(rng.uniform(0.8, 1.2, (n, 1, 1)).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 21, n).astype(np.int32))
    gj = torch.from_numpy((rng.randn(n, 21, 3) * 0.05 + [0, 0, 0.6]).astype(np.float32))
    gv = torch.from_numpy((rng.randn(n, 778, 3) * 0.05 + [0, 0, 0.6]).astype(np.float32))
    pj = gj + torch.from_numpy(rng.randn(n, 21, 3).astype(np.float32)) * 0.01
    pv = gv + torch.from_numpy(rng.randn(n, 778, 3).astype(np.float32)) * 0.01
    right = torch.from_numpy(np.arange(n) % 3 > 0)           # both hands present
    per_dev, tests = {}, {}
    for name, d, reg in (("cpu", cpu, ctx_cpu.registry), ("cuda", dev, ctx_gpu.registry)):
        mv = lambda x: x.to(d)
        m = {**TM.hand_metrics(mv(gj), mv(pj), mv(gv), mv(pv)),
             **TM.object_metrics(reg, mv(pd_rt), mv(gt_rt), mv(ids), mv(cam))}
        per_dev[name] = {k: v.cpu() for k, v in m.items()}
        th, to = TTE.TesterHand(), TTE.TesterObject(reg)
        th.add_batch(mv(gj), mv(pj), mv(gv), mv(pv), mv(right))
        to.add_batch(mv(pd_rt), mv(gt_rt), mv(ids), mv(cam))
        tests[name] = (th.result(), to.result())
    rates = set(TTE.RATE_KEYS) | {k for k in per_dev["cpu"] if k.startswith("FSCORE@")}
    f32_metric_err = {}
    for k, ref in per_dev["cpu"].items():
        got = per_dev["cuda"][k]
        if k in rates:
            check(torch.equal(got, ref), f"eval_f32 {k}: rates differ")
        else:
            f32_metric_err[k] = (got - ref).abs().max().item()
            bar = 1e-5 if k != "REP" else 1e-3          # REP is in pixels
            check(f32_metric_err[k] <= bar, f"eval_f32 {k}: {f32_metric_err[k]} > {bar}")
    tester_err = {}
    for i in (0, 1):
        for k, per in tests["cpu"][i].items():
            tester_err[k] = max(abs(tests["cuda"][i][k][c] - v) for c, v in per.items())
            bar = 1e-3 if k == "REP" else 1e-5
            check(tester_err[k] <= bar, f"eval_f32 tester {k}: {tester_err[k]} > {bar}")
    tester_err = max(v for k, v in tester_err.items() if k != "REP")
    say(phase="eval_f32", samples=n, tf32=torch.backends.cuda.matmul.allow_tf32,
        max_abs_err_m=f32_metric_err, tester_max_abs_err=tester_err)

    # graphs (metrics): an eval batch's metrics at bs 64 (the evaluate loop's 3 hand testers and
    # 2 object testers), eagerly under the profiler with its parts timed apart, and replayed
    reg, nb = ctx_gpu.registry, 64
    rng = np.random.RandomState(12)
    fdev = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    mgj = fdev(rng.randn(nb, 21, 3) * 0.05 + [0, 0, 0.6])
    mgv = fdev(rng.randn(nb, 778, 3) * 0.05 + [0, 0, 0.6])
    mpj, mpv = mgj + fdev(rng.randn(nb, 21, 3) * 0.01), mgv + fdev(rng.randn(nb, 778, 3) * 0.01)
    mR = TT.axis_angle_to_matrix(fdev(rng.randn(2, nb, 3)))
    mt = fdev(np.concatenate([rng.randn(2, nb, 2) * 0.02, 0.5 + rng.rand(2, nb, 1) * 0.2], -1))
    mgt, mpd = (torch.cat([mR[i], mt[i][..., None]], -1) for i in (0, 1))
    mids = torch.from_numpy(rng.randint(0, 21, nb).astype(np.int32)).to(dev)
    mcam = cam[:1].repeat(nb, 1, 1).to(dev)
    ostep = TTE.object_metrics_step(reg)
    eager_metrics = lambda: ([TM.hand_metrics(mgj, mpj, mgv, mpv) for _ in range(3)]
                             + [TM.object_metrics(reg, mpd, mgt, mids, mcam) for _ in range(2)])
    replayed_metrics = lambda: ([TTE.HAND_METRICS(mgj, mpj, mgv, mpv) for _ in range(3)]
                                + [ostep(mpd, mgt, mids, mcam) for _ in range(2)])
    m_eager, m_replay = eager_metrics(), replayed_metrics()
    m_differ = sorted({k for a, b in zip(m_eager, m_replay) for k in a
                       if not torch.equal(a[k], b[k])})
    check(not m_differ, f"graphs metrics: replayed rows differ from the eager ones in {m_differ}")
    m_prof = profiled(eager_metrics)
    m_top = sorted(m_prof["kernel_ms"].items(), key=lambda kv: -kv[1])[:10]
    verts = lambda v, rt: TM._apply_rt(v[mids.long()], rt)
    parts = dict(
        rigid_align=cuda_ms(lambda: [(TT.rigid_align(mpj, mgj), TT.rigid_align(mpv, mgv))
                                     for _ in range(3)], 3),
        distance_blocks_adds=cuda_ms(lambda: [TM.pairwise_min_dist(verts(reg.verts_sampled, mpd),
                                                                   verts(reg.verts_sampled, mgt))
                                              for _ in range(2)], 3),
        distance_blocks_fscore_cd=cuda_ms(lambda: [TM.pairwise_min_dist(
            verts(reg.verts_full, mpd), verts(reg.verts_full, mgt),
            reg.verts_full_mask[mids.long()])
            for _ in range(2)], 3))
    H = torch.randn(nb, 3, 3, device=dev)
    torch.linalg.svd(H)                     # the solver's handle, made once
    svd_wall_ms = wall(lambda: [torch.linalg.svd(H) for _ in range(6)])
    say(phase="graphs", part="metrics", card=card, batch=nb, testers="3 hand + 2 object",
        bit_identical=True, eager_ms=cuda_ms(eager_metrics, 3),
        replayed_ms=cuda_ms(replayed_metrics, 5),
        eager_profile=dict(wall_ms=m_prof["wall_ms"], device_busy_ms=m_prof["busy_ms"],
                           device_idle_share=1.0 - m_prof["busy_ms"] / m_prof["wall_ms"],
                           kernels=sum(m_prof["kernels"].values()),
                           host_launches=sum(m_prof["host_launches"].values()),
                           copy_cast=dict(
                               kernels=sum(c for k, c in m_prof["kernels"].items()
                                           if "copy" in k.lower() or "cast" in k.lower()),
                               ms=sum(t for k, t in m_prof["kernel_ms"].items()
                                      if "copy" in k.lower() or "cast" in k.lower())),
                           top=[[k[:70], round(t, 3), m_prof["kernels"][k]] for k, t in m_top]),
        eager_parts_ms=parts, verts_full=int(reg.verts_full.shape[1]),
        svd_of_the_parent_form_wall_ms=svd_wall_ms)

    # ---- 8. modes: every integrator and aggregation choice at full width, bf16 -------------
    # (the candidate batches through make_candidate_step: captured, then one replay timed)
    modes, steps, held = {}, 10, {}
    for method, schedule in (("euler", "uniform"), ("heun", "uniform"), ("rk4", "uniform"),
                             ("dpm2m", "uniform"), ("dpm3m", "karras")):
        mctx = ctx._replace(cfg=dataclasses.replace(cfg, ode_method=method, ode_schedule=schedule,
                                                    sampling_steps=steps))
        cand_step = make_candidate_step(model, mctx)
        cand_step.capture(batch, x0)
        K1.launches = 0
        cand_ms = wall(lambda: held.update(cand=cand_step(batch, x0)))
        evals = SAMP.score_evals(method, steps)
        check(K1.launches == evals, f"{method}: K1 launched {K1.launches}, score evaluations {evals}")
        cand = held["cand"]
        check(all(bool(torch.isfinite(cand[k]).all()) for k in ("diff_final_hand_mano",
                                                                   "diff_final_obj_6d")),
              f"{method}: non-finite candidates")
        modes[f"{method}_{schedule}"] = dict(k1_launches=K1.launches, score_evals=evals, ms=cand_ms)
        del cand_step
    with torch.inference_mode():
        trunk_out = model.trunk(batch)

    # every aggregation choice on the last candidate set (dpm3m on the karras grid); the
    # inputs of K2's force-selection launch are kept to hold the kernel against its plain form
    recorded = []
    real_k2 = AGG.min_dist_and_idx

    def recording_k2(fp, vv):
        recorded.append((fp, vv))
        return real_k2(fp, vv)

    agg_runs = [(h, "heatmap", True) for h in ("heatmap_cascade", "heatmap", "2D_pt_pose",
                                                 "2D_pt_joint", "average_all", "random")]
    agg_runs += [("heatmap", o, True) for o in ("heatmap_cascade", "2D_pt_pose", "average_all",
                                                "random")]
    agg_runs += [("heatmap", "heatmap_cascade", False), ("heatmap_cascade", "heatmap_cascade", True)]
    agg_k2 = {}
    AGG.min_dist_and_idx = recording_k2
    try:
        for mh, mo, phys in agg_runs:
            actx = ctx._replace(cfg=dataclasses.replace(cfg, aggregation_mode_hand=mh,
                                                        aggregation_mode_obj=mo,
                                                        do_physics_selection=phys))
            K2.launches = 0
            pd_a = V.aggregate(actx, batch, dict(cand), trunk_out)
            name = f"{mh}/{mo}" + ("" if phys else "/no_physics")
            agg_k2[name] = K2.launches
            want_k2 = 2 if (mh, mo) == ("heatmap_cascade", "heatmap_cascade") else \
                int(mo == "heatmap_cascade" and phys)
            check(K2.launches == want_k2, f"aggregation {name}: K2 launched {K2.launches}")
            check(all(bool(torch.isfinite(pd_a[k]).all()) for k in ("agg_obj_6d", "agg_hand_joint")),
                  f"aggregation {name}: non-finite output")
            if (mh, mo, phys) == ("heatmap", "heatmap_cascade", True):
                held["force"] = recorded[-1]
    finally:
        AGG.min_dist_and_idx = real_k2
    force_fp, force_verts = held["force"]
    check(tuple(force_fp.shape) == (B, cfg.topk_obj ** 2, 32, 3), f"force selection fp {force_fp.shape}")
    force_err = k2_hold("force_selection", force_fp, force_verts)

    # the default (5-stage) aggregation under each quaternion-mean solve, in turns
    agg_ms, agg_out = {"eigh": [], "power": []}, {}

    def aggregate_with(impl):
        agg_out[impl] = V.aggregate(ctx, batch, dict(cand), trunk_out)

    try:
        for impl in ("eigh", "power", "power", "eigh"):
            TT.set_quat_mean_impl(impl)
            agg_ms[impl].append(wall(lambda: aggregate_with(impl)))
    finally:
        TT.set_quat_mean_impl("eigh")
    power_vs_eigh = {k: (agg_out["power"][k] - agg_out["eigh"][k]).abs().max().item()
                     for k in ("agg_obj_6d", "agg_hand_mano")}
    say(phase="modes", batch=B, sample_num=S, steps=steps, dtype="bfloat16", integrators=modes,
        aggregation_k2_launches=agg_k2, force_selection_k2=dict(
            shape=list(force_fp.shape), max_abs_err=force_err),
        aggregation_ms={k: sorted(v) for k, v in agg_ms.items()}, power_vs_eigh_max_diff=power_vs_eigh)
    for name in kernels:
        kernels[name]["launches_by_path"] = {"predict": launches[name], "eval": eval_launches[name]}
    kernels["min_dist"]["force_selection_max_abs_err"] = force_err

    # ---- 9. train: the JAX package's training defaults at full width, f32 ---------------
    from vpho_tpu_torch.engine.trainer import Trainer

    train_dir = os.path.join("output", "chip_smoke_train")
    train_argv = ["--mode", "train", "--batch_size", "64", "--patch_size", "256",
                  "--repeat_num", "20", "--output_dir", train_dir]
    tcfg = get_config(train_argv)
    check((tcfg.compute_dtype, tcfg.optimizer, tcfg.scheduler, tcfg.base_learning_rate,
           tcfg.gamma) == ("float32", "adamw", "exp", 2e-4, 0.96), "training defaults changed")
    del model, ctx, cand, trunk_out, held, recorded, pd, pd_a, agg_out, predict_step, trainer
    free_memory()
    trainer_t = Trainer(tcfg, dev)
    trainer_t.init_state(8)
    tbatch = fixtures.make_batch(trainer_t.ctx, seed=21, batch_size=64, patch_size=256)
    tgen = torch.Generator(device=dev).manual_seed(22)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, totals, n_timed = [], [], 5
    for i in range(1 + n_timed):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        losses = trainer_t.train_step(tbatch, generator=tgen, eager=True)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t_start)
        vals = {k: v.item() for k, v in losses.items()}
        check(all(math.isfinite(v) for v in vals.values()), f"train step {i}: {vals}")
        totals.append(vals["total_loss"])
    check(totals[-1] < totals[0], f"train: total loss {totals[0]} -> {totals[-1]}")
    split = trainer_t.train_timing()
    timed_s = step_s[1:]
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # one more step counting its operations (forward and backward), one under torch.profiler
    from vpho_tpu_torch.engine.profiling import flops_of

    eager_step = lambda: trainer_t.train_step(tbatch, generator=tgen, eager=True)
    step_flops = flops_of(eager_step)[1]["flops"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
        tprof_ms = wall(eager_step)
    tstats = [e for e in tprof.key_averages() if e.self_device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    tbusy_ms = sum(e.self_device_time_total for e in tstats) / 1e3
    ttop = sorted(tstats, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    trainer_t.train_timing()
    say(phase="train", batch=64, patch=256, repeat_num=20, dtype="float32",
        tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32, cudnn=torch.backends.cudnn.allow_tf32),
        warmup_s=step_s[0], step_s=timed_s, steps_per_s=n_timed / sum(timed_s),
        frames_per_s=64 * n_timed / sum(timed_s),
        split_ms={k[:-2]: sum(v[1:]) / n_timed * 1e3 for k, v in split.items()},
        peak_mem_gb=train_peak_gb, total_loss=totals, last_losses=vals,
        params_m=sum(p.numel() for p in trainer_t.model.parameters()) / 1e6,
        step_gflops=step_flops / 1e9, achieved_tflops=step_flops / (sum(timed_s) / n_timed) / 1e12,
        profile=dict(wall_ms=tprof_ms, device_busy_ms=tbusy_ms, device_idle_share=1.0 - tbusy_ms / tprof_ms,
                     launches=sum(e.count for e in tstats),
                     top=[[e.key[:70], round(e.self_device_time_total / 1e3, 3), e.count] for e in ttop]))

    # graphs (train): make_train_step's graphs on the same trainer and batch.  The first call
    # is the warm-up step and the capture; then 5 replays and 5 eager steps in turns
    replay_step = lambda: trainer_t.train_step(tbatch, generator=tgen)
    torch.cuda.reset_peak_memory_stats()
    capture_call_ms = wall(replay_step)
    tstep = trainer_t._step("train")
    tgraph = next(iter(tstep.graph.graphs.values()))[1]
    t_eager_ms, t_replay_ms, replay_losses = [], [], []
    for _ in range(5):
        t_eager_ms.append(wall(eager_step))
        t_replay_ms.append(wall(lambda: replay_losses.append(replay_step())))
    for i, rl in enumerate(replay_losses):
        vals = {k: v.item() for k, v in rl.items()}
        check(len(vals) == 14 and all(math.isfinite(v) for v in vals.values()),
              f"graphs train: replay {i} losses {vals}")
    t_rep = profiled(replay_step)
    t_eag = profiled(eager_step)
    graphs_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainer_t.train_timing()
    say(phase="graphs", part="train", card=card, batch=64, patch=256, repeat_num=20,
        dtype="float32", capture_call_ms=capture_call_ms, capture_s=tgraph.seconds,
        pool_gb=tgraph.pool_bytes / 1e9, step_ms=dict(eager=t_eager_ms, replayed=t_replay_ms),
        steps_per_s=dict(eager=5e3 / sum(t_eager_ms), replayed=5e3 / sum(t_replay_ms)),
        frames_per_s=dict(eager=64 * 5e3 / sum(t_eager_ms), replayed=64 * 5e3 / sum(t_replay_ms)),
        replayed=window(t_rep), eager=window(t_eag), peak_mem_gb=graphs_peak_gb,
        replayed_kernel_launches={"bank_mlp": count_named(t_rep["kernels"], "bank_mlp_kernel"),
                                  "min_dist": count_named(t_rep["kernels"], "min_dist_kernel"),
                                  "metric_nn": count_named(t_rep["kernels"], "metric_nn_kernel"),
                                  "bn_act": count_named(t_rep["kernels"], "bn_act_kernel")})
    check(count_named(t_rep["kernels"], "bank_mlp_kernel") == 0
          and count_named(t_rep["kernels"], "min_dist_kernel") == 0
          and count_named(t_rep["kernels"], "metric_nn_kernel") == 0
          and count_named(t_rep["kernels"], "bn_act_kernel") == 0,
          "graphs train: a replayed train step launched a hand-written kernel")
    k4_row["launches_train_step_replayed"] = 0
    for name in kernels:
        kernels[name]["launches_by_path"]["train_step_replayed"] = 0
    del trainer_t, tbatch, losses, tstep, tgraph, replay_losses
    free_memory()

    # ---- 10. train_f32: one small train step on the card against the port on the CPU -----
    # Same weights, the same score-loss draws and dropout masks (drawn on the CPU, replayed on
    # the card), TF32 off.  Train-mode BN over a batch of 4 is ill-conditioned in float32 (on
    # the CPU a 1-ulp change of the input moves backbone gradients by ~2-4%), so the gradient
    # bars are per module group; the heads after the encoders are well-conditioned.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vpho_tpu_torch.models.layers import DropoutMasks

    small_t = V.ModelConfig(patch_size=64, repeat_num=2)
    runs = []
    g_draw = torch.Generator().manual_seed(23)
    draws = {"hand": (torch.rand(8, 1, generator=g_draw) * (1 - 1e-5) + 1e-5, torch.randn(8, 96, generator=g_draw)),
             "obj": (torch.rand(8, 1, generator=g_draw) * (1 - 1e-5) + 1e-5, torch.randn(8, 9, generator=g_draw))}
    masks = None
    for d in (cpu, dev):
        m_t = V.build_model(small_t, seed=24, device=cpu)
        with torch.no_grad():
            for den in (m_t.denoiser_hand, m_t.denoiser_obj):    # a non-zero score
                l2 = den.head.head[2]
                l2.weight.copy_(torch.randn(l2.weight.shape, generator=torch.Generator().manual_seed(25)) * 0.01)
        m_t = m_t.to(d)
        c_t = V.make_context(small_t, device=d)
        b_t = fixtures.make_batch(c_t, seed=26, batch_size=4, patch_size=64)
        drop = (DropoutMasks(generator=torch.Generator().manual_seed(27)) if masks is None
                else DropoutMasks(masks=masks))
        total, tl = V.forward_train(m_t, c_t, b_t, dropout=drop, draws={
            k: (a.to(d), b.to(d)) for k, (a, b) in draws.items()})
        masks = drop.drawn                  # the CPU run's masks, replayed on the card
        ps = dict(m_t.named_parameters())
        grads = torch.autograd.grad(total, list(ps.values()), allow_unused=True)
        runs.append(({k: v.item() for k, v in tl.items()},
                        {k: (g if g is not None else torch.zeros_like(p)).cpu() for (k, p), g in zip(ps.items(), grads)},
                        {k: v.cpu() for k, v in m_t.state_dict().items() if "running" in k}))
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    (l_c, g_c, s_c), (l_g, g_g, s_g) = runs
    loss_rel = {k: abs(l_g[k] - l_c[k]) / max(abs(l_c[k]), 1e-12) for k in l_c}
    # per parameter |g_card - g_cpu| <= rtol |g_cpu| + 1e-4 x the module's largest gradient norm
    # (the bars of tests/test_torch_port_train.py against JAX; the absolute term covers the conv
    # biases that feed a train-mode BN, whose exact gradient is zero)
    heads = ("head_mano", "cross_hand", "cross_obj", "head_physics")
    group_of = lambda k: k.split(".")[0]
    scale = {}
    for k, ref in g_c.items():
        scale[group_of(k)] = max(scale.get(group_of(k), 0.0), ref.norm().item())
    grad_rel, bar_used = {}, {}
    for k, ref in g_c.items():
        grp = group_of(k)
        rtol = 1e-3 if grp in heads else 1e-2 if grp.startswith("denoiser") else 0.15
        err = (g_g[k] - ref).norm().item()
        grad_rel[grp] = max(grad_rel.get(grp, 0.0), err / max(ref.norm().item(), 1e-30))
        bar_used[grp] = max(bar_used.get(grp, 0.0),
                            err / (rtol * ref.norm().item() + 1e-4 * scale[grp]))
    bn_rel = max(((s_g[k] - s_c[k]).abs().max() / s_c[k].abs().max().clamp_min(1e-12)).item() for k in s_c)
    say(phase="train_f32", batch=4, patch=64, repeat_num=2, tf32=False, loss_rel_err=loss_rel,
        grad_rel_norm_err_by_group=grad_rel, grad_bar_used_by_group=bar_used,
        bn_stats_rel_err=bn_rel)
    check(max(loss_rel.values()) <= 1e-4, f"train_f32 losses {loss_rel}")
    for grp, used in bar_used.items():
        check(used <= 1.0, f"train_f32 gradients {grp}: {used} of the bar")
    check(bn_rel <= 1e-3, f"train_f32 BN statistics {bn_rel}")
    train_replay_phase(dev, card, os.path.join("output", "chip_smoke_train_replay"))

    # ---- 11. train_entry: --mode train through the entry point, bf16 ---------------------
    import glob

    entry_argv = ["--mode", "train", "--max_epochs", "1", "--compute_dtype", "bfloat16",
                  "--batch_size", "64", "--patch_size", "256", "--eval_batch_size", "64",
                  "--sample_num", "100", "--sampling_steps", "50", "--topk_hand", "30",
                  "--topk_obj", "10", "--viz_freq", "-1", "--output_dir", train_dir]
    K1.launches = K2.launches = K3.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    tr1 = runner.run(get_config(entry_argv))
    torch.cuda.synchronize()
    entry_wall_s = time.perf_counter() - t_start
    entry_launches = {"bank_mlp": K1.launches, "min_dist": K2.launches, "metric_nn": K3.launches}
    n_sub = len(tr1.last_eval["timing"]["frames"])
    check(n_sub == 2, f"train_entry sub-eval batches {n_sub}")
    check(entry_launches == {"bank_mlp": 50 * n_sub, "min_dist": 2 * n_sub,
                             "metric_nn": k3_launches(tr1.ctx.registry, n_sub)},
          f"train_entry launch counts {entry_launches}")
    lt = tr1.last_train
    check(len(lt["losses"]) == 14 and all(math.isfinite(v) for v in lt["losses"].values()),
          f"train_entry bf16 losses {lt['losses']}")
    ckpt = os.path.join(tr1.save_dir, "checkpoint", "epoch_1.state")
    check(os.path.isfile(ckpt) and os.path.isfile(os.path.join(tr1.save_dir, "final_model.pkl")),
          f"train_entry files in {tr1.save_dir}")
    check(tr1.step == 8 and tr1.optimizer.count == 8, f"train_entry steps {tr1.step}")
    check(len(tr1._step("train").graph.graphs) == 1 and not lt["forward_s"],
          "train_entry: the epoch did not run on the train step's graphs")
    # the same epoch with the step run eagerly (graphs.capturable answering no), for its rate
    from vpho_tpu_torch.engine import graphs as GR

    capturable = GR.capturable
    GR.capturable = lambda device: False
    try:
        tr_e = runner.run(get_config(entry_argv))
    finally:
        GR.capturable = capturable
    le = tr_e.last_train
    check(len(le["forward_s"]) == 8, "train_entry: the eager epoch ran on graphs")
    del tr_e
    # resume: the state restored from epoch_1.state before the first resumed step
    resume_argv = entry_argv[:2] + ["--max_epochs", "2"] + entry_argv[4:] + ["--checkpoint", ckpt]
    tr2 = Trainer(get_config(resume_argv), dev)
    tr2.init_state(8)
    sd1, sd2 = tr1.model.state_dict(), tr2.model.state_dict()
    o1, o2 = tr1.optimizer, tr2.optimizer
    exact = (tr2.start_epoch == 1 and tr2.step == tr1.step and o2.count == o1.count
             and all(torch.equal(sd1[k], sd2[k]) for k in sd1)
             and all(torch.equal(a, b) for a, b in zip(o1.mu + o1.nu, o2.mu + o2.nu)))
    check(exact, "resume from epoch_1.state is not exact")
    del tr2
    K1.launches = K2.launches = K3.launches = 0
    tr3 = runner.run(get_config(resume_argv))
    check(tr3.step == 16 and os.path.isfile(os.path.join(tr3.save_dir, "checkpoint", "epoch_2.state")),
          f"resumed run: step {tr3.step}")
    check(tr3.start_epoch == 1 and K1.launches == 100 and K2.launches == 4
          and K3.launches == k3_launches(tr3.ctx.registry, 2),
          f"resumed run launches {K1.launches}, {K2.launches}, {K3.launches}")
    say(phase="train_entry", dtype="bfloat16", batch=64, patch=256, steps=lt["steps"],
        path="make_train_step, replayed", epoch_s=lt["seconds"],
        steps_per_s=lt["steps"] / lt["seconds"], frames_per_s=64 * lt["steps"] / lt["seconds"],
        # device-stream spans of the steps after the first (the first is the warm-up, the
        # capture, and cuDNN's tuning)
        steady_step_ms=sum(lt["step_s"][1:]) / (lt["steps"] - 1) * 1e3,
        first_step_ms=lt["step_s"][0] * 1e3,
        eager=dict(epoch_s=le["seconds"], steps_per_s=le["steps"] / le["seconds"],
                   frames_per_s=64 * le["steps"] / le["seconds"],
                   steady_split_ms={k[:-2]: sum(le[k][1:]) / (le["steps"] - 1) * 1e3
                                    for k in ("step_s", "forward_s", "backward_s", "optimizer_s")}),
        last_losses=lt["losses"], wall_s=entry_wall_s, sub_eval_batches=n_sub,
        launches=entry_launches,
        files=sorted(os.path.relpath(f, tr1.save_dir) for f in glob.glob(os.path.join(tr1.save_dir, "**"), recursive=True) if os.path.isfile(f)),
        resumed_exactly=exact, resumed_epoch_s=tr3.last_train["seconds"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    for name in kernels:
        kernels[name]["launches_by_path"]["train_entry"] = entry_launches[name]

    del tr1, tr3
    free_memory()

    # ---- 12. data: the DexYCB loader on real-format frames ---------------------------------
    import shutil
    import tempfile

    from vpho_tpu_torch.data import codec
    from vpho_tpu_torch.data import dexycb as DX
    from vpho_tpu_torch.data.device_pipeline import (draw_erase_noise, make_device_preprocess,
                                                     preprocess_batch)
    from vpho_tpu_torch.data.fixtures_disk import build_mini_dexycb, build_mini_ho3d

    from vpho_tpu_torch import native as NAT

    native_live = NAT.has_native()
    check(native_live, "the native host library is not live")
    tmp_root = tempfile.mkdtemp(prefix="vpho_chip_smoke_")
    bs, patch, steps = 64, 256, 50          # the blessed batch, crop and ODE steps
    # four batches.  The loader keeps LOADER_DEPTH batches in flight and the trainer's prefetch
    # pulls ~3 more, all during batch 0's seconds (FLOP count, cuDNN tuning): a run this short
    # never waits on the loader's own rate, which the data phase measures alone
    n_frames = 4 * bs
    t_start = time.perf_counter()
    dex_root = build_mini_dexycb(os.path.join(tmp_root, "DexYCB"), n=n_frames, seed=31)
    build_s = time.perf_counter() - t_start
    loader_rate = {}
    for split, is_train in (("train", True), ("eval", False)):
        for mode, device_mode in (("host", False), ("device", True)):
            dcfg = get_config(["--data_dir", dex_root, "--patch_size", str(patch)]
                              + (["--device_preprocess"] if device_mode else []))
            ds = DX.DexYCBForceDataset(dcfg, dex_root, is_train=is_train)
            for cache in ("cold", "warm"):
                if cache == "cold":
                    shutil.rmtree(os.path.join(dex_root, "cache", "hand_contact"),
                                  ignore_errors=True)
                t_start = time.perf_counter()
                got = sum(len(b["index"]) for b in (DX.make_loader(ds, bs) if is_train else
                                                    DX.make_loader(ds, bs, drop_last=False)))
                loader_rate[f"{split}_{mode}_{cache}"] = got / (time.perf_counter() - t_start)
                check(got == n_frames, f"data {split} {mode}: {got} items")
    # the same train passes on the numpy forms of the host helpers (the library unbound)
    numpy_rate = {}
    bound = NAT._LIB
    NAT._LIB = None
    try:
        for mode, device_mode in (("host", False), ("device", True)):
            dcfg = get_config(["--data_dir", dex_root, "--patch_size", str(patch)]
                              + (["--device_preprocess"] if device_mode else []))
            ds = DX.DexYCBForceDataset(dcfg, dex_root, is_train=True)
            for cache in ("cold", "warm"):
                if cache == "cold":
                    shutil.rmtree(os.path.join(dex_root, "cache", "hand_contact"),
                                  ignore_errors=True)
                t_start = time.perf_counter()
                got = sum(len(b["index"]) for b in DX.make_loader(ds, bs))
                numpy_rate[f"train_{mode}_{cache}"] = got / (time.perf_counter() - t_start)
                check(got == n_frames, f"data numpy {mode}: {got} items")
    finally:
        NAT._LIB = bound
    say(phase="data", decoder=codec.decoder(), frames=n_frames, frame="640x480 jpg", batch=bs,
        patch=patch, in_flight=DX.LOADER_DEPTH, build_s=build_s, native=native_live,
        items_per_s=loader_rate, items_per_s_numpy_forms=numpy_rate)

    # ---- 13. preprocess: the device preprocess at bs 64 ------------------------------------
    pre_ms, pre_peak_gb, pre_err, pre_graph = {}, {}, {}, {}
    for split, is_train in (("eval", False), ("train", True)):
        dcfg = get_config(["--data_dir", dex_root, "--patch_size", str(patch),
                           "--device_preprocess"])
        ds = DX.DexYCBForceDataset(dcfg, dex_root, is_train=is_train)
        host = next(DX.make_loader(ds, bs))
        raw = {k: torch.as_tensor(v).to(dev) for k, v in host.items()}
        noise = draw_erase_noise(raw, patch, "pixel", torch.Generator(dev).manual_seed(41)) \
            if is_train else None
        kw = dict(patch_size=patch, heatmap_size=64, hand_sigma=2.0, obj_sigma=2.0,
                  is_train=is_train)
        run_pre = lambda: preprocess_batch(raw, noise=noise, **kw)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = run_pre()
        torch.cuda.synchronize()
        pre_peak_gb[split] = (torch.cuda.max_memory_allocated() - base) / 1e9
        pre_ms[split] = cuda_ms(run_pre, 10)
        check(out["rgb"].device.type == "cuda" and tuple(out["rgb"].shape) == (bs, patch, patch, 3)
              and bool(torch.isfinite(out["rgb"]).all()), f"preprocess {split} rgb")
        # the graph (make_device_preprocess): captured at its first call, then replayed
        pre_step = make_device_preprocess(dcfg, is_train)
        t_start = time.perf_counter()
        pre_step(raw, noise=noise)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t_start
        replayed = pre_step(raw, noise=noise)
        differ = sorted(k for k in out if not torch.equal(replayed[k], out[k]))
        check(not differ, f"preprocess {split}: the replay differs from the eager run in {differ}")
        pre_graph[split] = dict(bit_identical=True, capture_with_warmup_s=capture_s,
                                replayed_ms=cuda_ms(lambda: pre_step(raw, noise=noise), 10))
        del pre_step, replayed
        # the card against the CPU, float32, on 4 samples with the same noise
        four = {k: v[:4] for k, v in raw.items()}
        n4 = None if noise is None else noise[:4]
        card4 = preprocess_batch(four, noise=n4, **kw)
        cpu4 = preprocess_batch({k: v.cpu() for k, v in four.items()},
                                noise=None if n4 is None else n4.cpu(), **kw)
        pre_err[split] = {k: (card4[k].cpu() - cpu4[k]).abs().max().item()
                          for k in ("rgb", "hm_hand", "hm_obj")}
        check(pre_err[split]["rgb"] <= 2e-4 and max(pre_err[split]["hm_hand"],
                                                    pre_err[split]["hm_obj"]) <= 1e-5,
              f"preprocess {split}: card vs CPU {pre_err[split]}")
        del raw, out, host
    say(phase="preprocess", batch=bs, patch=patch, frame="640x480", ms=pre_ms,
        peak_mem_gb=pre_peak_gb, graphs=pre_graph,
        warp="pass 1 resamples all 480 source rows (no host-read window): one graph a signature",
        card_vs_cpu_max_abs_err=pre_err, band=dict(rgb=2e-4, heatmaps=1e-5))

    # ---- 14. data_eval: --mode eval on the tree, device preprocess, blessed config ---------
    blessed = ["--eval_batch_size", str(bs), "--patch_size", str(patch), "--sample_num", "100",
               "--sampling_steps", str(steps), "--topk_hand", "30", "--topk_obj", "10",
               "--sample_T0", "0.65", "--compute_dtype", "bfloat16"]
    de_argv = ["--mode", "eval", "--eval_full", "--data_dir", dex_root, "--device_preprocess",
               "--output_dir", os.path.join("output", "chip_smoke_data")] + blessed
    K1.launches = K2.launches = K3.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    tr_de = runner.run(get_config(de_argv))
    torch.cuda.synchronize()
    de_wall = time.perf_counter() - t_start
    de_launches = {"bank_mlp": K1.launches, "min_dist": K2.launches, "metric_nn": K3.launches}
    tm = tr_de.last_eval["timing"]
    n_de = len(tm["frames"])
    check(tm["frames"] == [bs] * 4, f"data_eval batches {tm['frames']}")
    check(de_launches == {"bank_mlp": steps * n_de, "min_dist": 2 * n_de,
                          "metric_nn": k3_launches(tr_de.ctx.registry, n_de)},
          f"data_eval launch counts {de_launches}")
    check(all(p > 0 for p in tm["preprocess_s"]), "data_eval: a batch skipped the preprocess")
    de_report = tr_de.last_eval["report"]
    de_values = [v for per in de_report.values() for table in per.values()
                 for row in table.values() for v in row.values()]
    check(de_values and all(math.isfinite(float(v)) for v in de_values), "data_eval metrics")
    de_split = {k[:-2]: [v * 1e3 for v in tm[k]]
                for k in ("wait_s", "preprocess_s", "predict_s", "metrics_s", "batch_s")}
    # the predict + metrics rate: the batches after the first (its FLOP count and cuDNN tuning),
    # loader wait taken out
    no_wait_s = [b - w for b, w in zip(tm["batch_s"][1:], tm["wait_s"][1:])]
    say(phase="data_eval", frames=n_frames, batches=n_de, batch=bs, dtype="bfloat16",
        wall_s=de_wall, frames_per_s=sum(tm["frames"]) / sum(tm["batch_s"]),
        frames_per_s_without_wait=sum(tm["frames"][1:]) / sum(no_wait_s),
        per_batch_ms=de_split,
        launches=de_launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del tr_de
    free_memory()

    # ---- 15. data_train: --mode train on the tree, device preprocess -----------------------
    dt_argv = ["--mode", "train", "--max_epochs", "1", "--data_dir", dex_root,
               "--device_preprocess", "--batch_size", str(bs), "--print_freq", "1", "--viz_freq",
               "-1", "--output_dir", os.path.join("output", "chip_smoke_data_train")] + blessed
    dt_argv[dt_argv.index("--compute_dtype") + 1] = "float32"
    K1.launches = K2.launches = K3.launches = 0
    t_start = time.perf_counter()
    tr_dt = runner.run(get_config(dt_argv))
    torch.cuda.synchronize()
    dt_wall = time.perf_counter() - t_start
    lt = tr_dt.last_train
    check(lt["steps"] == 4 and tr_dt.step == 4,
          f"data_train steps {lt['steps']}")
    check(len(lt["losses"]) == 14 and all(math.isfinite(v) for v in lt["losses"].values()),
          f"data_train losses {lt['losses']}")
    check(all(p > 0 for p in lt["preprocess_s"]), "data_train: a step skipped the preprocess")
    check(os.path.isfile(os.path.join(tr_dt.save_dir, "checkpoint", "epoch_1.state")),
          "data_train: no epoch_1.state")
    # the float32 sub-eval takes K1's plain einsum form (the kernel is the bf16 policy's fast
    # path, as in the JAX package), K2 twice and K3 four times a batch
    n_sub = len(tr_dt.last_eval["timing"]["frames"])
    check(K1.launches == 0 and K2.launches == 2 * n_sub
          and K3.launches == k3_launches(tr_dt.ctx.registry, n_sub),
          f"data_train sub-eval launches {K1.launches}, {K2.launches}, {K3.launches}")
    check(len(tr_dt._step("train").graph.graphs) == 1 and not lt["forward_s"],
          "data_train: the epoch did not run on the train step's graphs")
    say(phase="data_train", dtype="float32", batch=bs, patch=patch, steps=lt["steps"],
        path="make_train_step, replayed", epoch_s=lt["seconds"],
        steps_per_s=lt["steps"] / lt["seconds"], wait_ms=[w * 1e3 for w in lt["wait_s"]],
        preprocess_ms=[p * 1e3 for p in lt["preprocess_s"]],
        step_ms=[v * 1e3 for v in lt["step_s"]],
        last_losses=lt["losses"], wall_s=dt_wall, sub_eval_batches=n_sub,
        sub_eval_launches={"bank_mlp": K1.launches, "min_dist": K2.launches,
                           "metric_nn": K3.launches})
    del tr_dt
    free_memory()

    # ---- 16. ho3d: --mode infer (codalab zips) and --mode train with infer_ho3d -------------
    import zipfile

    ho_root = os.path.join(tmp_root, "HO3D_v2")
    n_ho_train, n_ho_eval = bs, 10
    build_mini_ho3d(ho_root, n_train=n_ho_train, n_eval=n_ho_eval, seed=43)
    ho_argv = ["--dataset_name", "ho3d", "--data_dir", ho_root, "--viz_freq", "-1",
               "--output_dir", os.path.join("output", "chip_smoke_ho3d")] + blessed
    K1.launches = K2.launches = K3.launches = 0
    t_start = time.perf_counter()
    tr_hi = runner.run(get_config(["--mode", "infer"] + ho_argv))
    torch.cuda.synchronize()
    hi_wall = time.perf_counter() - t_start
    check(K1.launches == steps and K2.launches == 2
          and K3.launches == k3_launches(tr_hi.ctx.registry, 1),
          f"ho3d infer launches {K1.launches}, {K2.launches}, {K3.launches}")
    rows = pickle.load(open(os.path.join(tr_hi.save_dir,
                                         "my-prediction_align-2023_CVPR_HFL-infer.pkl"), "rb"))
    order = np.concatenate([r["index"] for r in rows])
    joints_cv = np.concatenate([r["pd_hand_joint"] for r in rows])[np.argsort(order)]
    gl = np.array([1.0, -1.0, -1.0], np.float32)
    zips = {}
    for name in ("hand_reg", "hand_diff"):
        path = os.path.join(tr_hi.save_dir, "submit", f"{name}.zip")
        with zipfile.ZipFile(path) as z:
            joints, verts = (np.asarray(a) for a in json.loads(z.read(f"{name}.json")))
        check(joints.shape == (n_ho_eval, 21, 3) and verts.shape == (n_ho_eval, 778, 3)
              and np.isfinite(verts).all(), f"ho3d {name}: {joints.shape}, {verts.shape}")
        zips[name] = os.path.getsize(path)
    # the diffusion zip's row k is frame k of evaluation.txt: the pkl's prediction for
    # dataset index k, turned to the OpenGL frame (the zip rounds to 6 decimals)
    zip_err = float(np.abs(joints - joints_cv * gl).max())
    check(sorted(order.tolist()) == list(range(n_ho_eval)) and zip_err <= 1e-6,
          f"ho3d: zip order against the pkl, max err {zip_err}")
    lines = open(os.path.join(ho_root, "evaluation.txt")).read().split()
    check(lines == [f"SM1/{i:04d}" for i in reversed(range(n_ho_eval))],
          "ho3d: evaluation.txt order")
    del tr_hi
    free_memory()
    K1.launches = K2.launches = K3.launches = 0
    t_start = time.perf_counter()
    tr_ht = runner.run(get_config(["--mode", "train", "--max_epochs", "1", "--batch_size", str(bs),
                                   "--full_evaluation_freq", "1", "--device_preprocess",
                                   "--print_freq", "1"] + ho_argv))
    torch.cuda.synchronize()
    ht_wall = time.perf_counter() - t_start
    ht_files = sorted(os.path.relpath(os.path.join(r, f), tr_ht.save_dir)
                      for r, _, fs in os.walk(tr_ht.save_dir) for f in fs)
    for want in ("submit/ep1_hand_reg.zip", "submit/ep1_hand_diff.zip",
                 "checkpoint/epoch_1.state", "my-prediction_align-2023_CVPR_HFL-inferep1_.pkl"):
        check(want in ht_files, f"ho3d train: no {want} in {ht_files}")
    check(tr_ht.step == 1 and all(math.isfinite(v) for v in tr_ht.last_train["losses"].values()),
          f"ho3d train: step {tr_ht.step}, losses {tr_ht.last_train['losses']}")
    check(K1.launches == steps and K2.launches == 2
          and K3.launches == k3_launches(tr_ht.ctx.registry, 1),
          f"ho3d train infer launches {K1.launches}, {K2.launches}, {K3.launches}")
    say(phase="ho3d", train_frames=n_ho_train, eval_frames=n_ho_eval, frame="640x480 png",
        infer_wall_s=hi_wall, zip_bytes=zips, zip_vs_pkl_max_abs_err=zip_err,
        train_wall_s=ht_wall, train_losses=tr_ht.last_train["losses"],
        train_preprocess_ms=[p * 1e3 for p in tr_ht.last_train["preprocess_s"]], files=ht_files)
    del tr_ht
    free_memory()
    shutil.rmtree(tmp_root)
    for name in kernels:
        kernels[name]["launches_by_path"].update(data_eval=de_launches[name])

    # ---- 17. force: offline force labels and the weights read from outside -------------------
    from vpho_tpu_torch.cli import force_optim_main
    from vpho_tpu_torch.engine import force_optim as FO
    from vpho_tpu_torch.models.anchor import ForceAnchorTables
    from vpho_tpu_torch.utils import weights as WT

    torch.backends.cuda.matmul.allow_tf32 = False          # torch's default, as users get it
    fctx = V.make_context(V.ModelConfig(), device=dev)
    tables = fctx.anchor_tables
    fb = fixtures.make_arrays(fctx, seed=51, batch_size=bs, patch_size=64)
    fb["force_contact"] = (np.abs(np.random.RandomState(52).randn(bs, 32)) * 0.5).astype(np.float32)
    fb["is_right"] = np.arange(bs) % 3 != 2                # every third hand left
    fb["is_grasped"] = (np.arange(bs) % 5 != 4).astype(np.float32)   # every fifth ungrasped
    fin = {k: torch.as_tensor(fb[k], device=dev) for k in
           ("force_contact", "gt_hand_vert_flip", "gravity", "obj_CoM")}
    left = ~torch.as_tensor(fb["is_right"], device=dev)
    fargs = (fin["force_contact"], fin["gt_hand_vert_flip"],
             TT.flip_point3d(fin["gravity"], left), TT.flip_point3d(fin["obj_CoM"], left))
    f0 = FO._losses(torch.full((bs, 32), 0.05, device=dev), torch.zeros((bs, 32, 8), device=dev),
                    (fargs[0] > 0.1).float(), *fargs, tables)[0].item()
    # graphs (force): one bs-64 batch eagerly (the same iteration functions, no graph) and on
    # graphs, the forces equal bit for bit; the first graph run captures the two iterations
    fwall = {}

    def timed(name, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = FO.optimize_forces(*fargs, tables, **kw)
        torch.cuda.synchronize()
        fwall[name] = time.perf_counter() - t0
        return out

    f_eager = timed("eager", graphs=False)
    f_first = timed("graphs_first_with_capture")
    f_graph = timed("graphs")
    f_differ = sorted(k for k in ("force_local", "force_point", "force_global")
                      if not (torch.equal(f_graph[k], f_eager[k])
                              and torch.equal(f_first[k], f_eager[k])))
    check(not f_differ, f"graphs force: the graph run differs from the eager run in {f_differ}")
    # per iteration of each phase: n_win eager iterations and n_win replays, profiled
    loop = FO._LOOPS[(bs, fargs[0].device, FO.TOTAL_ITERS)]
    n_win, per_iter = 20, {}
    for phase, gi, step_fn in (("gravity", 0, loop.gravity_step), ("balance", 1, loop.balance_step)):
        for how in ("eager", "graphs"):
            loop.opt.reset()                         # the window stays inside the step table
            run = (lambda: [step_fn() for _ in range(n_win)]) if how == "eager" else \
                (lambda: [loop.graphs[gi].replay() for _ in range(n_win)])
            w = profiled(run)
            per_iter[f"{phase}_{how}"] = dict(
                host_launches=sum(w["host_launches"].values()) / n_win,
                device_launches=sum(w["kernels"].values()) / n_win,
                device_ms=w["busy_ms"] / n_win, wall_ms=w["wall_ms"] / n_win,
                busy_share=w["busy_ms"] / w["wall_ms"])
    # (a) one bs-64 batch at the full iteration counts through ForceOptimizer.run_batch (graphs)
    K1.launches = K2.launches = K3.launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    fres = FO.ForceOptimizer(tables).run_batch(fb)   # ends in a copy out
    force_s = time.perf_counter() - t_start
    force_peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(all(math.isfinite(v) for v in fres["losses"].values()), f"force losses {fres['losses']}")
    check(fres["losses"]["force"] < f0, f"force loss {fres['losses']['force']} !< initial {f0}")
    ungrasped = fb["is_grasped"] == 0
    check(not fres["force_local"][ungrasped].any() and not fres["force_global"][ungrasped].any()
          and np.abs(fres["force_local"][~ungrasped]).max() > 0, "force: ungrasped rows")
    n1, n2 = FO.PHASE1_ITERS, FO.TOTAL_ITERS - FO.PHASE1_ITERS
    device_s = (n1 * per_iter["gravity_graphs"]["device_ms"]
                + n2 * per_iter["balance_graphs"]["device_ms"]) / 1e3
    s0_batches = 401507 // bs                    # DexYCB's s0 train split at bs 64
    say(phase="graphs", part="force", card=card, batch=bs, iterations=FO.TOTAL_ITERS,
        bit_identical=True, s_per_batch=dict(eager=fwall["eager"], graphs=fwall["graphs"],
                                             graphs_first_with_capture=fwall["graphs_first_with_capture"]),
        per_iteration=per_iter, capture_s=[g.seconds for g in loop.graphs],
        pool_gb=sum(g.pool_bytes for g in loop.graphs) / 1e9,
        dexycb_s0_hours=dict(eager=s0_batches * fwall["eager"] / 3600,
                             graphs=s0_batches * fwall["graphs"] / 3600))
    # (b) the card against the port on the CPU, bs 8, 10 + 40 iterations, TF32 off
    cpu_tables = ForceAnchorTables(*[t.cpu() for t in tables])
    card8 = FO.optimize_forces(*[a[:8] for a in fargs], tables, 10, 50)
    cpu8 = FO.optimize_forces(*[a[:8].cpu() for a in fargs], cpu_tables, 10, 50)
    force_err = {}
    for k in ("force_local", "force_point", "force_global"):
        g, r = card8[k].cpu(), cpu8[k]
        force_err[k] = (g - r).abs().max().item()
        check(bool(((g - r).abs() <= 1e-5 + 1e-4 * r.abs()).all()), f"force {k}: card vs CPU")
    for k, v in cpu8["losses"].items():
        force_err[f"loss_{k}"] = abs(card8["losses"][k].item() / v.item() - 1.0)
        check(force_err[f"loss_{k}"] <= 1e-4, f"force loss {k}: card vs CPU")
    # (c) force_optim_main on a mini DexYCB tree named DexYCB, bs 64, full iterations
    f_root = tempfile.mkdtemp(prefix="vpho_chip_force_")
    f_dex = build_mini_dexycb(os.path.join(f_root, "DexYCB"), n=2 * bs, seed=53)
    t_start = time.perf_counter()
    force_optim_main(["--data_dir", f_dex, "--batch_size", str(bs)])
    main_s = time.perf_counter() - t_start
    force_launches = {"bank_mlp": K1.launches, "min_dist": K2.launches, "metric_nn": K3.launches}
    check(force_launches == {"bank_mlp": 0, "min_dist": 0, "metric_nn": 0},
          f"force launches {force_launches}")
    fds = DX.DexYCBForceDataset(get_config(["--data_dir", f_dex]), f_dex, is_train=True)
    n_labels = 0
    for i in range(len(fds)):
        rel = fds.get_path(i).replace(".jpg", ".pkl").replace("color_", "hand_force_")
        with open(os.path.join(f_dex, "cache", "hand_force", rel), "rb") as f:
            want = pickle.load(f)["force_local"]
        got = fds.get_force(fds.get_path(i))
        check(np.isfinite(got).all() and np.array_equal(got, want), f"force label {rel}")
        n_labels += 1
    # (d) --imagenet_pretrain and --pretrain x.pth through the entry point
    src = V.build_model(V.ModelConfig(), seed=61, device="cpu").state_dict()
    trunk = V.build_model(V.ModelConfig(), seed=62, device="cpu").state_dict()
    pth, rn50 = os.path.join(f_root, "vpho.pth"), os.path.join(f_root, "resnet50.pth")
    WT.save_torch_file(src, pth)
    fe = "feature_extractor"
    tv = {k.replace(f"{fe}.layer0_h.0.", "conv1.").replace(f"{fe}.layer0_h.1.", "bn1."): v
          for k, v in trunk.items() if k.startswith(f"{fe}.layer0_h.")}
    for layer in ("layer1", "layer2", "layer3", "layer4"):
        head = f"{fe}.{layer}_h.0."
        tv.update({layer + k[len(head) - 1:]: v for k, v in trunk.items() if k.startswith(head)})
    torch.save(tv, rn50)
    tr_w = runner.run(get_config([
        "--mode", "eval", "--imagenet_pretrain", rn50, "--pretrain", pth,
        "--remove_pretrained_keys", f"{fe}.layer2_o", "--eval_batch_size", "8", "--sample_num", "4",
        "--sampling_steps", "2", "--topk_hand", "2", "--topk_obj", "2", "--viz_freq", "-1",
        "--output_dir", os.path.join("output", "chip_smoke_weights")]))
    w_bad = [k for k, v in tr_w.model.state_dict().items() if not k.endswith("num_batches_tracked")
             and not torch.equal(v.cpu(), (trunk[k.replace("layer2_o", "layer2_h")]
                                           if k.startswith(f"{fe}.layer2_o.") else src[k]))]
    check(not w_bad, f"pretrain weights differ: {w_bad[:5]}")
    check(tr_w.last_eval["timing"]["frames"] == [8, 8], "pretrained eval batches")
    say(phase="force", batch=bs, iterations=FO.TOTAL_ITERS, phase1_iterations=FO.PHASE1_ITERS,
        path="graphs", s_per_batch=force_s, iterations_per_s=FO.TOTAL_ITERS / force_s,
        ms_per_iteration=force_s * 1e3 / FO.TOTAL_ITERS,
        dexycb_s0_hours=s0_batches * force_s / 3600,
        busy_share_derived=device_s / force_s, peak_mem_gb=force_peak_gb,
        initial_force_loss=f0, losses=fres["losses"], card_vs_cpu=force_err,
        main_frames=2 * bs, main_s=main_s, labels_read_back=n_labels, launches=force_launches,
        pretrain_keys=len(src), resnet50_keys=len(tv))
    del tr_w
    shutil.rmtree(f_root)
    for name in kernels:
        kernels[name]["launches_by_path"]["force"] = force_launches[name]

    # ---- 18. ddp: data parallelism on the one card ----------------------------------------
    ddp_phase(dev, card, eval_argv, kernels)

    print(card)
    print(json.dumps({"kernels": [kernels["bank_mlp"], kernels["min_dist"], kernels["metric_nn"],
                                  k4_row]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
