"""Mode dispatch: build the eval stream and the Trainer, then run eval / infer /
infer_candidate, or re-score a dumped prediction pkl (counterpart of
``vpho_tpu/engine/runner.py``).

The port runs on the synthetic fixture stream; real DexYCB / HO3D data and training are later
slices and raise ``NotImplementedError`` rather than fall back to synthetic data.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator

import numpy as np
import torch

from ..configs.config import Config
from ..data.fixtures import make_arrays
from ..utils import transforms as T
from ..utils.platform import resolve_device
from .trainer import Trainer, postprocess_hand_vert


def _augment_eval_keys(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Attach the camera-frame ground truth the eval loop reads (gt_joint, gt_hand_vert,
    gt_obj_rt, cam_intr), derived from the batch's wrist-relative ground truth."""
    t = {k: torch.from_numpy(np.asarray(batch[k])) for k in
         ("root_joint", "is_right", "gt_hand_jt3d_flip", "gt_hand_vert_flip", "gt_obj")}
    root, is_right = t["root_joint"], t["is_right"]
    rt = T.obj_9d_to_mat(t["gt_obj"])
    out = dict(batch)
    out["gt_joint"] = postprocess_hand_vert(t["gt_hand_jt3d_flip"], root, is_right).numpy()
    out["gt_hand_vert"] = postprocess_hand_vert(t["gt_hand_vert_flip"], root, is_right).numpy()
    out["gt_obj_rt"] = torch.cat([rt[..., :3], rt[..., 3:] + root[:, :, None]], -1).numpy()
    out["cam_intr"] = batch["cam_intr_crop"]
    return out


def synthetic_stream(ctx, cfg: Config, n_batches: int, batch_size: int, seed: int = 0,
                     with_eval_keys: bool = False) -> Iterator[Dict[str, np.ndarray]]:
    """Host batches of the synthetic fixture, seeded ``seed + i``."""
    for i in range(n_batches):
        batch = make_arrays(ctx, seed + i, batch_size, cfg.patch_size)
        if with_eval_keys:
            batch = _augment_eval_keys(batch)
            batch["_index"] = np.arange(i * batch_size, (i + 1) * batch_size)
            batch["_valid"] = np.ones((batch_size,), bool)
        yield batch


def _has_real_data(cfg: Config) -> bool:
    if cfg.dataset_name == "ho3d":
        return os.path.exists(os.path.join(cfg.data_dir, "evaluation.txt")) or \
            os.path.isdir(os.path.join(cfg.data_dir, "train"))
    return os.path.isdir(os.path.join(cfg.data_dir, "20200709-subject-01")) or \
        os.path.exists(os.path.join(cfg.data_dir, "dex_ycb_s0_train_data.json"))


def run(cfg: Config, device=None):
    """Run ``cfg``'s mode on ``device`` (``cuda`` unless the caller asks for the CPU).
    Returns the re-scored report for ``--eval_path``, else the Trainer."""
    device = resolve_device(device)
    if cfg.eval_path:
        from ..models.ycb import load_registry
        from .tester import evaluate_prediction_pkl

        report = evaluate_prediction_pkl(cfg.eval_path,
                                         load_registry(cfg.models_dir or None, device=device))
        for k, v in report.items():
            print(k, v)
        return report
    if cfg.mode == "energy":
        raise NotImplementedError(
            "--mode energy is non-functional in the reference "
            "(zhoujun-7/VPHO main.py:14-15) and intentionally not rebuilt")
    if cfg.mode == "train":
        raise NotImplementedError("--mode train is not ported yet (ROADMAP section 1, training)")
    if cfg.mode == "infer" and cfg.dataset_name == "ho3d":
        raise NotImplementedError("--mode infer on HO3D (infer_ho3d, codalab zips) is not "
                                  "ported yet (ROADMAP section 1, with the data pipeline)")
    if _has_real_data(cfg):
        raise NotImplementedError(f"real {cfg.dataset_name} data under {cfg.data_dir}: the "
                                  f"loaders are not ported yet (ROADMAP section 1, data pipeline)")

    trainer = Trainer(cfg, device)
    log = trainer.logger
    if cfg.eval_repeat_num != 50:
        log.warning("--eval_repeat_num is parsed for CLI parity but consumed nowhere in the "
                    "reference; use --sample_num to set the eval hypothesis count")
    log.warning("No real DexYCB found under %s: using the synthetic fixture stream",
                cfg.data_dir)
    trainer.init_state()

    def get_eval(full: bool):
        return synthetic_stream(trainer.ctx, cfg, 4 if full else 2, cfg.eval_batch_size,
                                seed=9999, with_eval_keys=True)

    if cfg.mode == "eval":
        out = trainer.evaluate(get_eval(cfg.eval_full and cfg.dataset_name != "ho3d"))
        trainer.dump_predictions(out["collector_res"])
    elif cfg.mode == "infer_candidate":
        trainer.infer_candidates(get_eval(True))
    elif cfg.mode == "infer":
        out = trainer.evaluate(get_eval(True))
        trainer.dump_predictions(out["collector_res"], tag="-infer")
    else:
        raise ValueError(f"Invalid mode: {cfg.mode}")
    return trainer
