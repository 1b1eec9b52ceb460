#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vpho_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each:
  1. build    compile every hand-written kernel (one nvcc per source, in parallel); ptxas's
              registers, shared memory and spill bytes for each (spills fail the run)
  2. kernel   each kernel against its plain PyTorch version on the card, at the main path's
              shapes and at edge shapes, with kernel / plain / library timings and bounds
  3. f32      the predict slice at test size on the card (TF32 off) against the same port on
              the CPU: same weights, same ODE start state
  4. predict  the blessed eval config (patch 256, bs 64, S 100, 50 dpm3m steps, topk 30/10,
              bf16 policy) through ``forward_predict``: 1 warm-up and 2 timed batches, kernel
              launch counts, frames/s, peak memory and a per-stage time split
  4b. ode     the blessed 50-step ODE (``forward_candidates``) once more with K1's plain version
              bound into the denoiser, held against the kernel run
  5. profile  one more batch under torch.profiler: device busy time, idle share, top kernels,
              and the count and time of copy / cast kernels
  6. eval     the eval entry point, ``engine.runner.run`` in-process, at the blessed config
              (bf16, 4 batches of 64, the viz dumps of batch 0): frames/s over the batches after
              the first, the predict / metrics / host split, peak memory, K1 = 50 and K2 = 2
              launches a batch, the headline metrics, the files written, and ``--eval_path``
              re-scoring the dumped pkl to the object report the eval logged
  7. eval_f32 the metrics and testers on the card against the CPU for the same predictions,
              TF32 left on, within 1e-5 m
  8. modes    at full width: one batch of candidates per integrator (euler, heun, rk4, dpm2m at
              10 steps; dpm3m on the karras grid), K1's launches equal to its score evaluations;
              every aggregation choice on one candidate set, K2 held against its plain version
              at the force-selection shape (N = topk_obj^2); the default aggregation timed under
              the eigh and the power quaternion mean
  9. train    the JAX package's training defaults at full width (f32, bs 64, patch 256,
              repeat_num 20, adamw, exp schedule, lr 2e-4) through ``Trainer.train_step`` on one
              fixed batch: 1 warm-up and 5 timed steps, steps/s, frames/s, the forward /
              backward / optimizer split, peak memory; every loss finite, the last total below
              the first
  10. train_f32 one train step at test size (bs 4, patch 64, repeat_num 2) on the card (TF32
              off) against the port on the CPU: same weights, draws and dropout masks; loss
              terms, gradients and BN statistics held
  11. train_entry ``engine.runner.run`` with ``--mode train --max_epochs 1`` (bf16, bs 64, patch
              256, the blessed sub-eval flags): K1 = 50 and K2 = 2 launches a sub-eval batch,
              bf16 steps/s, every bf16 loss finite, ``epoch_1.state`` and ``final_model.pkl``;
              then a resume from ``epoch_1.state`` restores params, BN statistics, optimizer
              moments and step exactly, and ``--max_epochs 2`` trains the second epoch
  12. data    a mini DexYCB tree (256 frames of 640x480 JPEG, every third hand left) in a
              temporary directory: the decoder, and the loader's items/s at bs 64, patch 256,
              its four batches in flight, for train and eval, host and device mode, with the
              contact labels' cache cold and warm
  13. preprocess the device preprocess (``--device_preprocess``) of a bs-64 device-mode batch:
              ms per batch (CUDA events) and peak memory, eval (rectilinear warp) and train
              (two-pass warp and the augmentations), and the source rows the warp reads; on 4
              samples, the card against the port on the CPU in float32 with the same erase
              noise
  14. data_eval ``--mode eval --eval_full --device_preprocess`` on the tree at the blessed config
              (bf16, 4 batches): frames/s over all batches and with the loader's wait taken
              out; loader wait / preprocess / predict / metrics per batch, K1 = 50 and K2 = 2
              launches a batch, every metric finite
  15. data_train ``--mode train --max_epochs 1 --device_preprocess`` on the tree (f32, bs 64,
              patch 256, 4 steps, the blessed sub-eval flags): steps/s, loader wait and
              preprocess per step, finite losses, ``epoch_1.state``; the f32 sub-eval runs K2
              twice a batch and K1's plain form
  16. ho3d    a mini HO3D tree (64 train frames, 10 evaluation frames, 640x480 PNG):
              ``--mode infer`` writes both codalab zips with the evaluation frames in
              ``evaluation.txt`` order (each zip row is its frame's prediction in the OpenGL
              frame); ``--mode train --max_epochs 1 --full_evaluation_freq 1
              --device_preprocess`` runs ``infer_ho3d`` after its epoch
  17. force   offline force labels: a bs-64 fixture batch (every third hand left, every fifth
              sample ungrasped) through ``ForceOptimizer.run_batch`` at the full 3000 iterations:
              s per batch, iterations/s, peak memory; launches, device ms and busy share per
              iteration of each phase from a profiled 20-iteration window; the final force loss
              below the initial one, ungrasped rows 0.  Then bs 8 at 10 + 40 iterations on the
              card against the CPU (TF32 off), ``force_optim_main`` on a 128-frame mini tree
              named ``DexYCB`` (every label read back by ``get_force``; no kernel launched), and
              ``--imagenet_pretrain`` + ``--pretrain x.pth`` through the eval entry point
Then the card's ``name, power.limit``, the kernels' JSON line and, last, the result line.
Any failed check raises, so the script exits non-zero and prints no result.  It needs one
CUDA device and the checkout it sits in; without either it fails.
"""
from __future__ import annotations

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
        from vpho_tpu_torch.ops import cuda_build
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

    # ---- 4. the blessed predict path, bf16 policy -----------------------------------------
    K1.launches = K2.launches = 0
    torch.cuda.reset_peak_memory_stats()
    n_batches, times = 3, []
    for _ in range(n_batches):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        pd = V.forward_predict(model, ctx, batch, x0=x0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t_start)
    launches = {"bank_mlp": K1.launches, "min_dist": K2.launches}
    check(launches == {"bank_mlp": 50 * n_batches, "min_dist": 2 * n_batches},
          f"launch counts {launches}")
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

    with torch.inference_mode():
        trunk_ms = wall(lambda: model.trunk(batch))
    cand_ms = wall(lambda: V.forward_candidates(model, ctx, batch, x0=x0))
    total_ms = wall(lambda: V.forward_predict(model, ctx, batch, x0=x0))
    timed = times[1:]
    say(phase="predict", batch=B, sample_num=S, steps=cfg.sampling_steps, dtype="bfloat16",
        warmup_s=times[0], batch_s=timed, frames_per_s=B * len(timed) / sum(timed),
        peak_mem_gb=peak_gb, launches=launches, split_ms=dict(
            trunk=trunk_ms, ode_and_fk=cand_ms - trunk_ms, aggregation=total_ms - cand_ms,
            total=total_ms))

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
    K1.launches = K2.launches = 0
    t_start = time.perf_counter()
    trainer = runner.run(get_config(eval_argv))
    torch.cuda.synchronize()
    eval_wall_s = time.perf_counter() - t_start
    eval_launches = {"bank_mlp": K1.launches, "min_dist": K2.launches}
    eval_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res, tm = trainer.last_eval, trainer.last_eval["timing"]
    n_eval = len(tm["frames"])
    check(n_eval == 4 and tm["frames"] == [64] * 4, f"eval batches {tm['frames']}")
    check(eval_launches == {"bank_mlp": 50 * n_eval, "min_dist": 2 * n_eval},
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

    # ---- 8. modes: every integrator and aggregation choice at full width, bf16 -------------
    modes, steps, held = {}, 10, {}

    def candidates(mctx):
        held["cand"] = V.forward_candidates(model, mctx, batch, x0=x0)

    for method, schedule in (("euler", "uniform"), ("heun", "uniform"), ("rk4", "uniform"),
                             ("dpm2m", "uniform"), ("dpm3m", "karras")):
        mctx = ctx._replace(cfg=dataclasses.replace(cfg, ode_method=method, ode_schedule=schedule,
                                                    sampling_steps=steps))
        K1.launches = 0
        cand_ms = wall(lambda: candidates(mctx))
        evals = SAMP.score_evals(method, steps)
        check(K1.launches == evals, f"{method}: K1 launched {K1.launches}, score evaluations {evals}")
        cand, trunk_out = held["cand"]
        check(all(bool(torch.isfinite(cand[k]).all()) for k in ("diff_final_hand_mano",
                                                                   "diff_final_obj_6d")),
              f"{method}: non-finite candidates")
        modes[f"{method}_{schedule}"] = dict(k1_launches=K1.launches, score_evals=evals, ms=cand_ms)

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
    del model, ctx, cand, trunk_out, held, recorded, pd, pd_a, agg_out
    torch.cuda.empty_cache()
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
        losses = trainer_t.train_step(tbatch, generator=tgen)
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

    step_flops = flops_of(lambda: trainer_t.train_step(tbatch, generator=tgen))[1]["flops"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
        tprof_ms = wall(lambda: trainer_t.train_step(tbatch, generator=tgen))
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
    del trainer_t, tbatch, losses
    torch.cuda.empty_cache()

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

    # ---- 11. train_entry: --mode train through the entry point, bf16 ---------------------
    import glob

    entry_argv = ["--mode", "train", "--max_epochs", "1", "--compute_dtype", "bfloat16",
                  "--batch_size", "64", "--patch_size", "256", "--eval_batch_size", "64",
                  "--sample_num", "100", "--sampling_steps", "50", "--topk_hand", "30",
                  "--topk_obj", "10", "--viz_freq", "-1", "--output_dir", train_dir]
    K1.launches = K2.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    tr1 = runner.run(get_config(entry_argv))
    torch.cuda.synchronize()
    entry_wall_s = time.perf_counter() - t_start
    entry_launches = {"bank_mlp": K1.launches, "min_dist": K2.launches}
    n_sub = len(tr1.last_eval["timing"]["frames"])
    check(n_sub == 2, f"train_entry sub-eval batches {n_sub}")
    check(entry_launches == {"bank_mlp": 50 * n_sub, "min_dist": 2 * n_sub},
          f"train_entry launch counts {entry_launches}")
    lt = tr1.last_train
    check(len(lt["losses"]) == 14 and all(math.isfinite(v) for v in lt["losses"].values()),
          f"train_entry bf16 losses {lt['losses']}")
    ckpt = os.path.join(tr1.save_dir, "checkpoint", "epoch_1.state")
    check(os.path.isfile(ckpt) and os.path.isfile(os.path.join(tr1.save_dir, "final_model.pkl")),
          f"train_entry files in {tr1.save_dir}")
    check(tr1.step == 8 and tr1.optimizer.count == 8, f"train_entry steps {tr1.step}")
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
    K1.launches = K2.launches = 0
    tr3 = runner.run(get_config(resume_argv))
    check(tr3.step == 16 and os.path.isfile(os.path.join(tr3.save_dir, "checkpoint", "epoch_2.state")),
          f"resumed run: step {tr3.step}")
    check(tr3.start_epoch == 1 and K1.launches == 100 and K2.launches == 4,
          f"resumed run launches {K1.launches}, {K2.launches}")
    say(phase="train_entry", dtype="bfloat16", batch=64, patch=256, steps=lt["steps"],
        epoch_s=lt["seconds"], steps_per_s=lt["steps"] / lt["seconds"],
        frames_per_s=64 * lt["steps"] / lt["seconds"],
        # device-stream spans of the steps after the first (the first also tunes cuDNN)
        steady_split_ms={k[:-2]: sum(lt[k][1:]) / (lt["steps"] - 1) * 1e3
                         for k in ("forward_s", "backward_s", "optimizer_s")},
        first_step_ms={k[:-2]: lt[k][0] * 1e3 for k in ("forward_s", "backward_s", "optimizer_s")},
        last_losses=lt["losses"], wall_s=entry_wall_s, sub_eval_batches=n_sub,
        launches=entry_launches,
        files=sorted(os.path.relpath(f, tr1.save_dir) for f in glob.glob(os.path.join(tr1.save_dir, "**"), recursive=True) if os.path.isfile(f)),
        resumed_exactly=exact, resumed_epoch_s=tr3.last_train["seconds"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    for name in kernels:
        kernels[name]["launches_by_path"]["train_entry"] = entry_launches[name]

    del tr1, tr3
    torch.cuda.empty_cache()

    # ---- 12. data: the DexYCB loader on real-format frames ---------------------------------
    import shutil
    import tempfile

    from vpho_tpu_torch.data import codec
    from vpho_tpu_torch.data import dexycb as DX
    from vpho_tpu_torch.data.device_pipeline import draw_erase_noise, preprocess_batch
    from vpho_tpu_torch.data.fixtures_disk import build_mini_dexycb, build_mini_ho3d
    from vpho_tpu_torch.ops.image import warp_source_rows

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
    say(phase="data", decoder=codec.decoder(), frames=n_frames, frame="640x480 jpg", batch=bs,
        patch=patch, in_flight=DX.LOADER_DEPTH, build_s=build_s, items_per_s=loader_rate)

    # ---- 13. preprocess: the device preprocess at bs 64 ------------------------------------
    pre_ms, pre_peak_gb, pre_err, pre_rows = {}, {}, {}, {}
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
        pre_rows[split] = warp_source_rows(raw["warp_minv"], patch, raw["rgb_full"].shape[1])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = run_pre()
        torch.cuda.synchronize()
        pre_peak_gb[split] = (torch.cuda.max_memory_allocated() - base) / 1e9
        pre_ms[split] = cuda_ms(run_pre, 10)
        check(out["rgb"].device.type == "cuda" and tuple(out["rgb"].shape) == (bs, patch, patch, 3)
              and bool(torch.isfinite(out["rgb"]).all()), f"preprocess {split} rgb")
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
        peak_mem_gb=pre_peak_gb, source_rows=pre_rows, card_vs_cpu_max_abs_err=pre_err,
        band=dict(rgb=2e-4, heatmaps=1e-5))

    # ---- 14. data_eval: --mode eval on the tree, device preprocess, blessed config ---------
    blessed = ["--eval_batch_size", str(bs), "--patch_size", str(patch), "--sample_num", "100",
               "--sampling_steps", str(steps), "--topk_hand", "30", "--topk_obj", "10",
               "--sample_T0", "0.65", "--compute_dtype", "bfloat16"]
    de_argv = ["--mode", "eval", "--eval_full", "--data_dir", dex_root, "--device_preprocess",
               "--output_dir", os.path.join("output", "chip_smoke_data")] + blessed
    K1.launches = K2.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    tr_de = runner.run(get_config(de_argv))
    torch.cuda.synchronize()
    de_wall = time.perf_counter() - t_start
    de_launches = {"bank_mlp": K1.launches, "min_dist": K2.launches}
    tm = tr_de.last_eval["timing"]
    n_de = len(tm["frames"])
    check(tm["frames"] == [bs] * 4, f"data_eval batches {tm['frames']}")
    check(de_launches == {"bank_mlp": steps * n_de, "min_dist": 2 * n_de},
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
    torch.cuda.empty_cache()

    # ---- 15. data_train: --mode train on the tree, device preprocess -----------------------
    dt_argv = ["--mode", "train", "--max_epochs", "1", "--data_dir", dex_root,
               "--device_preprocess", "--batch_size", str(bs), "--print_freq", "1", "--viz_freq",
               "-1", "--output_dir", os.path.join("output", "chip_smoke_data_train")] + blessed
    dt_argv[dt_argv.index("--compute_dtype") + 1] = "float32"
    K1.launches = K2.launches = 0
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
    # path, as in the JAX package) and K2 twice a batch
    n_sub = len(tr_dt.last_eval["timing"]["frames"])
    check(K1.launches == 0 and K2.launches == 2 * n_sub,
          f"data_train sub-eval launches {K1.launches}, {K2.launches}")
    say(phase="data_train", dtype="float32", batch=bs, patch=patch, steps=lt["steps"],
        epoch_s=lt["seconds"], steps_per_s=lt["steps"] / lt["seconds"], wait_ms=[w * 1e3 for w in lt["wait_s"]],
        preprocess_ms=[p * 1e3 for p in lt["preprocess_s"]],
        step_split_ms={k[:-2]: [v * 1e3 for v in lt[k]] for k in
                       ("forward_s", "backward_s", "optimizer_s")},
        last_losses=lt["losses"], wall_s=dt_wall, sub_eval_batches=n_sub,
        sub_eval_launches={"bank_mlp": K1.launches, "min_dist": K2.launches})
    del tr_dt
    torch.cuda.empty_cache()

    # ---- 16. ho3d: --mode infer (codalab zips) and --mode train with infer_ho3d -------------
    import zipfile

    ho_root = os.path.join(tmp_root, "HO3D_v2")
    n_ho_train, n_ho_eval = bs, 10
    build_mini_ho3d(ho_root, n_train=n_ho_train, n_eval=n_ho_eval, seed=43)
    ho_argv = ["--dataset_name", "ho3d", "--data_dir", ho_root, "--viz_freq", "-1",
               "--output_dir", os.path.join("output", "chip_smoke_ho3d")] + blessed
    K1.launches = K2.launches = 0
    t_start = time.perf_counter()
    tr_hi = runner.run(get_config(["--mode", "infer"] + ho_argv))
    torch.cuda.synchronize()
    hi_wall = time.perf_counter() - t_start
    check(K1.launches == steps and K2.launches == 2,
          f"ho3d infer launches {K1.launches}, {K2.launches}")
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
    K1.launches = K2.launches = 0
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
    check(K1.launches == steps and K2.launches == 2, f"ho3d train infer launches {K1.launches}")
    say(phase="ho3d", train_frames=n_ho_train, eval_frames=n_ho_eval, frame="640x480 png",
        infer_wall_s=hi_wall, zip_bytes=zips, zip_vs_pkl_max_abs_err=zip_err,
        train_wall_s=ht_wall, train_losses=tr_ht.last_train["losses"],
        train_preprocess_ms=[p * 1e3 for p in tr_ht.last_train["preprocess_s"]], files=ht_files)
    del tr_ht
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
    # (a) one bs-64 batch at the full iteration counts through ForceOptimizer.run_batch
    K1.launches = K2.launches = 0
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

    def force_window(p1, total):
        """(device launches, device busy ms, wall ms) of one optimize_forces call, profiled."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            FO.optimize_forces(*fargs, tables, p1, total)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        return (sum(e.count for e in ev), sum(e.self_device_time_total for e in ev) / 1e3,
                wall_ms)

    n_win = 20
    w0 = force_window(0, 0)                   # set-up and the final losses only
    per_iter = {}
    for phase, (p1, total) in (("gravity", (n_win, n_win)), ("balance", (0, n_win))):
        w = force_window(p1, total)
        per_iter[phase] = dict(launches=(w[0] - w0[0]) / n_win, device_ms=(w[1] - w0[1]) / n_win,
                               wall_ms=(w[2] - w0[2]) / n_win,
                               busy_share=(w[1] - w0[1]) / (w[2] - w0[2]))
    n1, n2 = FO.PHASE1_ITERS, FO.TOTAL_ITERS - FO.PHASE1_ITERS
    device_s = (n1 * per_iter["gravity"]["device_ms"] + n2 * per_iter["balance"]["device_ms"]) / 1e3
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
    force_launches = {"bank_mlp": K1.launches, "min_dist": K2.launches}
    check(force_launches == {"bank_mlp": 0, "min_dist": 0}, f"force launches {force_launches}")
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
        s_per_batch=force_s, iterations_per_s=FO.TOTAL_ITERS / force_s,
        ms_per_iteration=force_s * 1e3 / FO.TOTAL_ITERS, per_iteration=per_iter,
        busy_share_derived=device_s / force_s, peak_mem_gb=force_peak_gb,
        initial_force_loss=f0, losses=fres["losses"], card_vs_cpu=force_err,
        main_frames=2 * bs, main_s=main_s, labels_read_back=n_labels, launches=force_launches,
        pretrain_keys=len(src), resnet50_keys=len(tv))
    del tr_w
    shutil.rmtree(f_root)
    for name in kernels:
        kernels[name]["launches_by_path"]["force"] = force_launches[name]

    print(card)
    print(json.dumps({"kernels": [kernels["bank_mlp"], kernels["min_dist"]]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
