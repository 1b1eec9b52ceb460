"""Input preprocessing on the card (counterpart of ``vpho_tpu/data/device_pipeline.py``):
``--device_preprocess``.

The loader keeps what the host must do (decoding, the crop's 2-D point arithmetic, the FK
label corrections, CLAHE, the draws of every augmentation parameter) and ships the decoded
uint8 frame with the crop's inverse affine.  This module does the pixel work on the batch's
device, in torch ops, in the JAX package's order:

    uint8 frame -> bicubic crop (ops/image.affine_warp) -> clip to [0, 255]
    [train: RGB shift -> colour jitter -> blur] -> normalize [train: erase] -> heatmaps

Eval crops never rotate (their warp is the separable bicubic product); train crops may, and
take the augmentations.  A left hand's flip is folded into the affine by the loader, and its
blur kernel mirrored.  The output drops the raw keys (``RAW_KEYS``) and carries the host
mode's ``rgb`` (B, P, P, 3), ``hm_hand`` and ``hm_obj``, so the engine is mode-agnostic.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..engine.graphs import CapturedStep
from ..ops.color import color_jitter, depthwise_blur, erase_noise_shape, erase_regions, rgb_shift
from ..ops.heatmap import adaptive_bbox_heatmap, square_bbox_heatmap
from ..ops.image import affine_warp
from ..utils.platform import device_constant

IMG_MEAN = (0.485, 0.456, 0.406)
IMG_STD = (0.229, 0.224, 0.225)

RAW_KEYS = ("rgb_full", "warp_minv", "jt2d", "kpt2d", "rgb_shift",
            "jitter_bcsh", "blur_kernel", "erase_rects")
READ_KEYS = RAW_KEYS + ("bbox_hand", "bbox_obj_rect", "is_right")


def draw_erase_noise(batch: Dict[str, torch.Tensor], patch_size: int, erase_mode: str,
                     generator: torch.Generator) -> Optional[torch.Tensor]:
    """The erase noise of a train batch from ``generator`` (None for 'const')."""
    B, R = batch["erase_rects"].shape[:2]
    shape = erase_noise_shape(erase_mode, B, R, patch_size, patch_size, 3)
    if shape is None:
        return None
    return torch.randn(shape, generator=generator, device=batch["rgb_full"].device)


def _pixels(batch: Dict[str, torch.Tensor], noise: Optional[torch.Tensor], patch_size: int,
            heatmap_size: int, hand_sigma: float, obj_sigma: float, is_train: bool,
            erase_mode: str) -> Dict[str, torch.Tensor]:
    """The pixel work of a raw batch (``READ_KEYS``): rgb, hm_hand and hm_obj."""
    x = affine_warp(batch["rgb_full"], batch["warp_minv"], patch_size)
    x = x.clamp(0.0, 255.0)               # cv2 saturates to uint8 after the warp
    if is_train:
        x = rgb_shift(x, batch["rgb_shift"].float())
        x = color_jitter(x, batch["jitter_bcsh"].float())
        x = depthwise_blur(x, batch["blur_kernel"].float())
    x = (x / 255.0 - device_constant(IMG_MEAN, x.device)) / device_constant(IMG_STD, x.device)
    if is_train:
        x = erase_regions(x, batch["erase_rects"], noise, mode=erase_mode)
    return {"rgb": x,
            "hm_hand": adaptive_bbox_heatmap(batch["jt2d"].float(), batch["bbox_hand"].float(),
                                             heatmap_size, hand_sigma),
            "hm_obj": square_bbox_heatmap(batch["kpt2d"].float(), batch["bbox_obj_rect"].float(),
                                          heatmap_size, obj_sigma, batch["is_right"].bool())}


def _check_noise(is_train, noise, generator) -> None:
    if is_train and noise is None and generator is None:
        raise ValueError("train-mode device preprocess needs its erase noise: pass noise= or "
                         "a torch.Generator as generator=")


def preprocess_batch(batch: Dict[str, torch.Tensor], patch_size: int, heatmap_size: int,
                     hand_sigma: float, obj_sigma: float, is_train: bool,
                     erase_mode: str = "pixel", noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """A raw device-mode batch -> the batch with rgb, hm_hand and hm_obj.

    Train batches need their erase noise: ``noise`` (of ``ops.color.erase_noise_shape``) or a
    ``generator`` to draw it from; without either they raise.
    """
    _check_noise(is_train, noise, generator)
    if is_train and noise is None:
        noise = draw_erase_noise(batch, patch_size, erase_mode, generator)
    out = {k: v for k, v in batch.items() if k not in RAW_KEYS}
    out.update(_pixels(batch, noise, patch_size, heatmap_size, hand_sigma, obj_sigma, is_train,
                       erase_mode))
    return out


def make_device_preprocess(cfg, is_train: bool):
    """``fn(batch, generator=None, noise=None) -> batch`` over ``cfg``'s patch and heatmap
    settings: ``preprocess_batch`` as the JAX package's jitted ``make_device_preprocess``, the
    pixel work a ``CapturedStep`` over the keys it reads (``READ_KEYS``), so on a card one CUDA
    graph per batch signature, replayed.  A train batch's erase noise is drawn from
    ``generator`` before the step and passed in.  Batches without ``rgb_full``
    (host-preprocessed) pass through unchanged."""
    kw = dict(patch_size=int(cfg.patch_size), heatmap_size=int(cfg.heatmap_size),
              hand_sigma=float(cfg.heatmap_hand_sigma), obj_sigma=float(cfg.heatmap_obj_sigma),
              is_train=is_train, erase_mode=cfg.random_erasing_mode)
    step = CapturedStep(lambda raw, noise: _pixels(raw, noise, **kw), "preprocess")

    def run(batch, generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None):
        if "rgb_full" not in batch:
            return batch
        _check_noise(is_train, noise, generator)
        if is_train and noise is None:
            noise = draw_erase_noise(batch, kw["patch_size"], kw["erase_mode"], generator)
        out = {k: v for k, v in batch.items() if k not in RAW_KEYS}
        out.update(step({k: batch[k] for k in READ_KEYS if k in batch}, noise))
        return out

    return run
