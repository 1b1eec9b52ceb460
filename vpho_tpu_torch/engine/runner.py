"""Mode dispatch: build the streams and the Trainer, then run train / eval / infer /
infer_candidate, or re-score a dumped prediction pkl (counterpart of
``vpho_tpu/engine/runner.py``).

The data comes from, in this order:
  1. HO3D under ``--data_dir`` (``--dataset_name ho3d``): train on its train split, the
     sub-eval on every 10th train frame, ``infer_ho3d`` (the codalab zips) on its evaluation
     split, every ``--full_evaluation_freq`` epochs when training;
  2. DexYCB under ``--data_dir``: its train and test splits, the sub-eval on every 10th test
     frame;
  3. else the synthetic fixture stream: 8 training batches an epoch.
Each epoch is followed by a checkpoint, the sub-eval (or HO3D's inference) and
``final_model.pkl``.

Ranks: under torchrun every process is a rank of its world; else ``--num_devices N`` > 1
(0 = every visible card) spawns N ranks on this host.  Each rank's streams hold its rows of the
global batches (``parallel/mesh.py``).
"""
from __future__ import annotations

import os
from typing import Dict, Iterator

import numpy as np
import torch

from ..configs.config import Config
from ..data.fixtures import host_context, make_arrays
from ..parallel import mesh
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
    """Host batches of the synthetic fixture, seeded ``seed + i``; on a data-parallel rank its
    rows of each.  The fixture's constants come to the host here, in the caller's thread
    (``fixtures.host_context``)."""
    return _synthetic_batches(host_context(ctx), cfg, n_batches, batch_size, seed,
                              with_eval_keys)


def _synthetic_batches(ctx, cfg: Config, n_batches: int, batch_size: int, seed: int,
                       with_eval_keys: bool) -> Iterator[Dict[str, np.ndarray]]:
    for i in range(n_batches):
        batch = make_arrays(ctx, seed + i, batch_size, cfg.patch_size)
        if with_eval_keys:
            batch = _augment_eval_keys(batch)
            batch["_index"] = np.arange(i * batch_size, (i + 1) * batch_size)
            batch["_valid"] = np.ones((batch_size,), bool)
        yield mesh.take_rows(batch)


def _has_real_data(cfg: Config) -> bool:
    if cfg.dataset_name == "ho3d":
        return os.path.exists(os.path.join(cfg.data_dir, "evaluation.txt")) or \
            os.path.isdir(os.path.join(cfg.data_dir, "train"))
    return os.path.isdir(os.path.join(cfg.data_dir, "20200709-subject-01")) or \
        os.path.exists(os.path.join(cfg.data_dir, "dex_ycb_s0_train_data.json"))


def _run_rank(device: torch.device, cfg: Config):
    run(cfg, device)


def run(cfg: Config, device=None):
    """Run ``cfg``'s mode on ``device`` (``cuda`` unless the caller asks for the CPU).
    Returns the re-scored report for ``--eval_path``, None in the process that spawned the
    ``--num_devices`` ranks, else the Trainer.

    A process group that is already up is used as it is; else torchrun's environment brings
    one up for the run; else ``--num_devices`` > 1 spawns that many ranks (gloo ranks on the
    CPU)."""
    device = resolve_device(device)
    if not cfg.eval_path and cfg.mode != "energy" and not mesh.is_distributed():
        device = mesh.init_distributed(device)
        if mesh.is_distributed():
            try:
                if cfg.num_devices > 0 and cfg.num_devices != mesh.world_size():
                    raise ValueError(f"--num_devices {cfg.num_devices}: torchrun started "
                                     f"{mesh.world_size()} ranks")
                return _run(cfg, device)
            finally:
                mesh.shutdown()
        n = mesh.resolve_num_devices(cfg.num_devices, device)
        if n > 1:
            mesh.spawn(_run_rank, n, device, cfg)
            return None
    return _run(cfg, device)


def _run(cfg: Config, device: torch.device):
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
    if cfg.mode == "train" and cfg.batch_size % mesh.world_size():
        raise ValueError(f"train batch size {cfg.batch_size} must be divisible by the "
                         f"{mesh.world_size()} ranks (set --batch_size or --num_devices)")
    trainer = Trainer(cfg, device)
    log = trainer.logger
    if cfg.eval_repeat_num != 50:
        log.warning("--eval_repeat_num is parsed for CLI parity but consumed nowhere in the "
                    "reference; use --sample_num to set the eval hypothesis count")
    metric_path_of = None
    if _has_real_data(cfg):
        from ..data.codec import decoder

        log.info(f"{cfg.dataset_name} under {cfg.data_dir}: frames decoded with {decoder()}"
                 + (", preprocessed on the device" if cfg.device_preprocess else ""))
    if _has_real_data(cfg) and cfg.dataset_name == "ho3d":
        from ..data.dexycb import make_loader
        from ..data.ho3d import HO3DForceDataset

        train_ds = HO3DForceDataset(cfg, cfg.data_dir, split="train")
        valid_ds = HO3DForceDataset(cfg, cfg.data_dir, split="valid")
        test_ds = HO3DForceDataset(cfg, cfg.data_dir, split="test")
        # infer_ho3d's paths are the evaluation split's; the metric eval runs on valid_ds
        trainer.eval_dataset = test_ds
        metric_path_of = valid_ds.get_path
        steps_per_epoch = max(1, len(train_ds) // cfg.batch_size)
        get_train = lambda ep: make_loader(train_ds, cfg.batch_size, shuffle=True, seed=ep)
        get_eval = lambda full: make_loader(test_ds if full else valid_ds, cfg.eval_batch_size,
                                            shuffle=False, drop_last=False)
    elif _has_real_data(cfg):
        from ..data.dexycb import DexYCBForceDataset, make_loader

        train_ds = DexYCBForceDataset(cfg, cfg.data_dir, is_train=True)
        test_ds = DexYCBForceDataset(cfg, cfg.data_dir, is_train=False)
        trainer.eval_dataset = test_ds
        steps_per_epoch = len(train_ds) // cfg.batch_size
        get_train = lambda ep: make_loader(train_ds, cfg.batch_size, shuffle=True, seed=ep)
        # every test frame is scored once: the tail batch is padded and masked by _valid
        get_eval = lambda full: make_loader(test_ds, cfg.eval_batch_size, shuffle=False,
                                            subsample=1 if full else 10, drop_last=False)
    else:
        log.warning("No real DexYCB found under %s: using the synthetic fixture stream",
                    cfg.data_dir)
        steps_per_epoch = 8
        get_train = lambda ep: synthetic_stream(trainer.ctx, cfg, steps_per_epoch,
                                                cfg.batch_size, seed=100 * ep)
        get_eval = lambda full: synthetic_stream(trainer.ctx, cfg, 4 if full else 2,
                                                 cfg.eval_batch_size, seed=9999,
                                                 with_eval_keys=True)
    trainer.init_state(steps_per_epoch if cfg.mode == "train" else None)

    if cfg.mode == "train":
        if cfg.start_with_eval:
            trainer.evaluate(get_eval(False), path_of=metric_path_of)
        for epoch in range(trainer.start_epoch, cfg.max_epochs):
            log.info(f"Epoch {epoch}/{cfg.max_epochs}")
            trainer.train_one_epoch(epoch, get_train(epoch), steps_per_epoch)
            trainer.save_checkpoint(epoch + 1)
            # HO3D runs its codalab inference every --full_evaluation_freq epochs instead,
            # with the sub-eval only when mixing train sets
            if cfg.dataset_name != "ho3d":
                trainer.evaluate(get_eval(False), path_of=metric_path_of)
            elif (epoch + 1) % cfg.full_evaluation_freq == 0:
                if cfg.use_mix_trainset:
                    trainer.evaluate(get_eval(False), path_of=metric_path_of)
                trainer.infer_ho3d(get_eval(True), epoch_tag=f"ep{epoch + 1}_")
            trainer.save_model()
    elif cfg.mode == "eval":
        # HO3D's evaluation split has no hand ground truth: the metric eval runs on valid
        out = trainer.evaluate(get_eval(cfg.eval_full and cfg.dataset_name != "ho3d"),
                               path_of=metric_path_of)
        trainer.dump_predictions(out["collector_res"])
    elif cfg.mode == "infer_candidate":
        trainer.infer_candidates(get_eval(True))
    elif cfg.mode == "infer":
        if cfg.dataset_name == "ho3d":
            trainer.infer_ho3d(get_eval(True))
        else:
            out = trainer.evaluate(get_eval(True))
            trainer.dump_predictions(out["collector_res"], tag="-infer")
    else:
        raise ValueError(f"Invalid mode: {cfg.mode}")
    return trainer
