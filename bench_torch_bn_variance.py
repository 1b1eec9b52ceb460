#!/usr/bin/env python3
"""How far the data-parallel train step of the PyTorch port (``vpho_tpu_torch``) lands from the
single-process step on one NVIDIA GPU, for each form of the cross-rank batch-norm variance,
against the rounding noise of the step itself.

    python3 bench_torch_bn_variance.py

For the f32 train step at (bs 16, patch 256, repeat_num 20) and (bs 4, patch 64, repeat_num 2),
TF32 off, random weights from a seed, fixed draws and dropout masks, it runs the single-process
step and then: the same step again ("repeat"), the step on images moved by one float32 ulp
("nudge"), and the step in an nccl process group of one rank with the cross-rank batch norm
computing its variance as E[x^2] - E[x]^2 ("fast", Flax's form) and in two passes ("two_pass",
the port's).  Each prints, per module group, the largest share of ``chip_smoke.py``'s train_f32
bar used against the single-process step (``chip_smoke.bar_used``: loss terms, BN statistics,
each module group's gradients), one JSON line per run, then the card's name and power limit.  Needs one CUDA device.
"""
import json
import subprocess
import sys

import torch
import torch.distributed.nn.functional as dist_nn

import chip_smoke as C
from vpho_tpu_torch.configs.config import get_config
from vpho_tpu_torch.data import fixtures
from vpho_tpu_torch.engine.trainer import Trainer
from vpho_tpu_torch.models import layers as L
from vpho_tpu_torch.parallel import mesh

def fast_variance(self, x32):
    """The cross-rank statistics with Flax's E[x^2] - E[x]^2."""
    n_ch = x32.shape[1]
    count = x32.new_full((1,), x32.numel() // n_ch)
    sums = dist_nn.all_reduce(torch.cat([x32.sum((0, 2, 3)), (x32 * x32).sum((0, 2, 3)), count]))
    mean = sums[:n_ch] / sums[-1]
    var = torch.clamp_min(sums[n_ch:2 * n_ch] / sums[-1] - mean * mean, 0.0)
    y = (x32 - mean[:, None, None]) * (torch.rsqrt(var + self.eps) * self.weight)[:, None, None]
    return y + self.bias[:, None, None], mean.detach(), var.detach()


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_torch_bn_variance: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for B, P, R in ((16, 256, 20), (4, 64, 2)):
        cfg = get_config(["--mode", "train", "--batch_size", str(B), "--patch_size", str(P),
                          "--repeat_num", str(R), "--output_dir", "output/bench_bn_variance"])
        tr = Trainer(cfg, dev)
        tr.init_state(8)
        gen = torch.Generator().manual_seed(54)
        with torch.no_grad():
            for den in (tr.model.denoiser_hand, tr.model.denoiser_obj):
                l2 = den.head.head[2]
                l2.weight.copy_(torch.randn(l2.weight.shape, generator=gen) * 0.01)
                l2.bias.copy_(torch.randn(l2.bias.shape, generator=gen) * 0.01)
        sd = {k: v.cpu().clone() for k, v in tr.model.state_dict().items()}
        batch = {k: v.cpu() for k, v in fixtures.make_batch(tr.ctx, seed=51, batch_size=B,
                                                            patch_size=P).items()}
        del tr
        draws = {"hand": (torch.rand(R * B, 1, generator=gen) * (1 - 1e-5) + 1e-5,
                          torch.randn(R * B, 96, generator=gen)),
                 "obj": (torch.rand(R * B, 1, generator=gen) * (1 - 1e-5) + 1e-5,
                         torch.randn(R * B, 9, generator=gen))}
        masks = [torch.rand(s, generator=gen) < 0.9 for s in
                 [(B, 65, 512), (1, 1, 65, 65), (B, 65, 512), (B, 65, 2048), (B, 65, 512)] * 2]

        def step(b, rows=None):
            t = Trainer(cfg, dev)
            t.init_state(8)
            t.model.load_state_dict(sd)
            return C.train_step_record(t, b, draws, masks, rows)

        ref = step(batch)
        nudged = dict(batch, rgb=torch.nextafter(batch["rgb"], torch.full_like(batch["rgb"],
                                                                               float("inf"))))
        runs = {"repeat": step(batch), "nudge": step(nudged)}
        mesh.init_distributed(torch.device("cuda", 0), backend="nccl", world=1, rank_=0,
                              init_method=f"tcp://localhost:{mesh.free_port()}")
        try:
            runs["two_pass"] = step(batch, mesh.batch_rows(B))
            two_pass, L.BatchNorm2d._cross_rank = L.BatchNorm2d._cross_rank, fast_variance
            try:
                runs["fast"] = step(batch, mesh.batch_rows(B))
            finally:
                L.BatchNorm2d._cross_rank = two_pass
        finally:
            mesh.shutdown()
        for name, run in runs.items():
            print(json.dumps({"batch": B, "patch": P, "run": name,
                              "bar_used": C.bar_used(ref, run)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
