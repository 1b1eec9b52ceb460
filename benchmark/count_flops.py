#!/usr/bin/env python3
"""The configurations' work, counted once on the reference: FLOPs a frame of the predict path
and of a training step (forward and backward), for ``mfu_pct.*``.

    python3 benchmark/count_flops.py <config> [--batch B] [--device cuda]

runs the reference (``benchmark/reference/``) at the configuration's shapes under
``torch.utils.flop_counter.FlopCounterMode``, one batch of B synthetic frames, and prints the
FLOPs divided by B (every op of both paths is linear in the batch).  The two kernels' plain
forms run outside the counter and are counted by ``roofline``'s formulas instead, so the count
is the work the configuration needs, whatever implements it.  The numbers go into the
configuration file's ``flops``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH))

from benchmark import compare, roofline, weights  # noqa: E402
from benchmark.reference.vpho_ref.models import aggregation as RA  # noqa: E402
from benchmark.reference.vpho_ref.models import denoiser as RD  # noqa: E402
from benchmark.reference.vpho_ref.models.layers import DropoutMasks  # noqa: E402
from benchmark.reference.vpho_ref.models.mano import load_mano  # noqa: E402
from benchmark.reference.vpho_ref.models.ycb import load_registry  # noqa: E402
from benchmark.traffic import generator as traffic  # noqa: E402


class KernelWork:
    """Runs K1's and K2's plain forms outside the FLOP counter and adds their formulas."""

    def __init__(self):
        self.flops = 0.0
        self._k1, self._k2 = RD.bank_mlp_prepared, RA.min_dist_and_idx

    def __enter__(self):
        from torch.utils._python_dispatch import _disable_current_modes

        def k1(pose_feat, w, add, S):
            with _disable_current_modes():
                out = self._k1(pose_feat, w, add, S)
            n, C, D = w.w1.shape
            self.flops += roofline.k1_flops(pose_feat.shape[0], C, D, n, w.w2.shape[2])
            return out

        def k2(fp, verts):
            with _disable_current_modes():
                out = self._k2(fp, verts)
            self.flops += roofline.k2_flops(fp[..., 0].numel(), verts.shape[1])
            return out

        RD.bank_mlp_prepared, RA.min_dist_and_idx = k1, k2
        return self

    def __exit__(self, *exc):
        RD.bank_mlp_prepared, RA.min_dist_and_idx = self._k1, self._k2


def count(config: dict, batch: int, device) -> dict:
    from torch.utils.flop_counter import FlopCounterMode

    model_cfg = config["model"]
    mix = {"batch_size": batch, "pool": 1, "patch_size": model_cfg.get("patch_size", 256),
           "heatmap_size": model_cfg.get("heatmap_size", 64), "eval_keys": True}
    b = traffic.make_pool(mix, 1, load_mano(device="cpu"), load_registry(device="cpu"))[0]
    b = compare.to_device(b, device)
    sd = weights.make_state_dict(1, device)
    ctx = compare.reference_context(model_cfg, device)
    model = compare.reference_model(sd, model_cfg["compute_dtype"], device)
    out = {}
    x0 = torch.randn(batch * ctx.cfg.sample_num, 105, device=device)
    with KernelWork() as kw, FlopCounterMode(display=False) as fc:
        compare.RV.forward_predict(model, ctx, b, x0=x0)
    out["predict_per_frame"] = (fc.get_total_flops() + kw.flops) / batch
    params = list(model.parameters())
    gen = torch.Generator(device=device).manual_seed(1)
    with FlopCounterMode(display=False) as fc:
        total, _ = compare.RV.forward_train(model, ctx, b, dropout=DropoutMasks(generator=gen),
                                            generator=gen)
        torch.autograd.grad(total, params, allow_unused=True)
    out["train_per_frame"] = fc.get_total_flops() / batch
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with open(os.path.join(BENCH, "configs", f"{args.config}.json")) as f:
        config = json.load(f)
    print(json.dumps({"config": args.config, "batch": args.batch,
                      **count(config, args.batch, torch.device(args.device))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
