#!/usr/bin/env python3
"""Time the PyTorch port's device preprocess (``--device_preprocess``) on one GPU.

    python3 bench_torch_preprocess.py [--root DIR] [--data_dir DIR]

Builds (once) a mini DexYCB of 64 frames of 640x480 under ``--data_dir``, takes one bs-64
device-mode batch at patch 256 for eval and one for train, and times ``preprocess_batch`` on
each with CUDA events (20 calls after one warm-up).  ``--root`` names the checkout whose
``vpho_tpu_torch`` is imported (by default this one), so two versions can be timed on one
machine, alternated (A, B, B, A).
Prints one JSON line: the card's name and power limit, ms per batch, the warp's source rows.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--data_dir", default=os.path.join(here, "output", "bench_preprocess_tree"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_preprocess.py needs a CUDA device")
    from vpho_tpu_torch.configs.config import get_config
    from vpho_tpu_torch.data import dexycb as DX
    from vpho_tpu_torch.data import device_pipeline as DP
    from vpho_tpu_torch.data.fixtures_disk import build_mini_dexycb
    from vpho_tpu_torch.ops import image

    bs, patch, reps = 64, 256, 20
    root = os.path.join(args.data_dir, "DexYCB")
    if not os.path.isdir(root):
        build_mini_dexycb(root, n=bs, seed=31)
    dev = torch.device("cuda")
    out = {"root": os.path.relpath(os.path.abspath(args.root), here),
           "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip().splitlines()[0],
           "batch": bs, "patch": patch, "reps": reps}
    for split, is_train in (("eval", False), ("train", True)):
        cfg = get_config(["--data_dir", root, "--patch_size", str(patch), "--device_preprocess"])
        ds = DX.DexYCBForceDataset(cfg, root, is_train=is_train)
        raw = {k: torch.as_tensor(v).to(dev) for k, v in next(DX.make_loader(ds, bs)).items()}
        noise = DP.draw_erase_noise(raw, patch, "pixel", torch.Generator(dev).manual_seed(41)) \
            if is_train else None
        run = lambda: DP.preprocess_batch(raw, patch_size=patch, heatmap_size=64,
                                          hand_sigma=2.0, obj_sigma=2.0, is_train=is_train,
                                          noise=noise)
        run()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            run()
        e1.record()
        torch.cuda.synchronize()
        out[f"{split}_ms"] = e0.elapsed_time(e1) / reps
        rows = getattr(image, "warp_source_rows", None)
        out[f"{split}_source_rows"] = (rows(raw["warp_minv"], patch, raw["rgb_full"].shape[1])
                                       if rows else None)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
