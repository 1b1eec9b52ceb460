"""Console entry points of the port (installed as ``vpho-torch`` and ``vpho-torch-force-optim``):

    python -m vpho_tpu_torch.cli --mode eval --eval_batch_size 64 --sample_num 100 ...
    python -m vpho_tpu_torch.engine.force_optim --data_dir <DexYCB> --batch_size 64

The flags are the JAX CLI's (``main.py``, ``force_optim.py``).  Both run on the GPU; to run on
the CPU, call ``vpho_tpu_torch.engine.runner.run(cfg, device="cpu")`` or
``force_optim_main(argv, device="cpu")`` from Python.
"""
from __future__ import annotations

import os


def train_eval_main(argv=None):
    """Eval / infer dispatch: the port's ``main.py``."""
    from .configs.config import get_config
    from .engine.runner import run

    return run(get_config(argv))


def force_optim_main(argv=None, device=None):
    """Offline pseudo-force labels (the JAX package's ``force_optim.py``): HO3D's train split
    under ``--data_dir`` with ``--dataset_name ho3d``, else DexYCB's s0 train split, else one
    synthetic batch as a smoke check.  Labels go to ``hand_force_*.pkl`` beside each dataset's
    cache; the loader drops the last ``len % --batch_size`` frames, as JAX's does."""
    from .configs.config import get_config
    from .data.dexycb import make_loader
    from .engine.force_optim import ForceOptimizer
    from .models import vpho as V
    from .utils.platform import resolve_device

    device = resolve_device(device)
    cfg = get_config(argv)
    cfg.bbox_scale_factor = 1.5               # the reference labeler's crop
    ctx = V.make_context(cfg.to_model_config(), cfg.mano_root or None, cfg.models_dir or None,
                         device=device)
    optimizer = ForceOptimizer(ctx.anchor_tables)

    def label(ds, path_of, dataset_name):
        ds.is_train = False                   # no augmentation while labelling
        for bi, batch in enumerate(make_loader(ds, cfg.batch_size)):
            paths = [path_of(int(i)) for i in batch["index"]]
            result = optimizer.run_batch(batch)
            ForceOptimizer.save_force(result, paths, dataset_name)
            print(f"batch {bi}: losses={result['losses']}")

    if cfg.dataset_name == "ho3d" and os.path.isdir(os.path.join(cfg.data_dir, "train")):
        from .data.ho3d import HO3DForceDataset

        ds = HO3DForceDataset(cfg, cfg.data_dir, split="train")
        label(ds, ds.get_path, "ho3d")
    elif os.path.exists(os.path.join(cfg.data_dir, "dex_ycb_s0_train_data.json")):
        from .data.dexycb import DexYCBForceDataset

        ds = DexYCBForceDataset(cfg, cfg.data_dir, is_train=True)
        label(ds, lambda i: os.path.join(cfg.data_dir, ds.get_path(i)), cfg.dataset_name)
    else:
        import numpy as np

        from .data.fixtures import make_arrays

        print("No real DexYCB found; running one synthetic batch as smoke check")
        batch = make_arrays(ctx, seed=0, batch_size=4, patch_size=64)
        batch["force_contact"] = np.abs(np.random.RandomState(0).randn(4, 32)).astype(np.float32)
        result = optimizer.run_batch(batch)
        print(f"losses={result['losses']}")
        print(f"force_local shape={result['force_local'].shape}")


if __name__ == "__main__":
    train_eval_main()
