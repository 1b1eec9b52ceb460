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

    flops = 2.0 * R * p.shape[1] * D * n + 2.0 * R * D * O * n
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

    k2_err = 0.0
    cases = (("stage4", dist_case(100), verts), ("stage5", dist_case(31), verts),
             ("N1", dist_case(1)[:2].contiguous(), verts[:2].contiguous()))
    for name, fp, vv in cases:
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
        k2_err = max(k2_err, err)
        del d2
    fp4, fp5 = cases[0][1], cases[1][1]

    def k2_bound(fp):
        # 8 flops a (query, vertex) pair: the dot product, |y|^2 and the compare
        k2_flops = 8.0 * fp[..., 0].numel() * verts.shape[1]
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

    print(card)
    print(json.dumps({"kernels": [kernels["bank_mlp"], kernels["min_dist"]]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
