"""Host image augmentation (counterpart of ``vpho_tpu/data/augment.py``; numpy, cv2, scipy).

CLAHE, RGB shift, colour jitter, Gaussian and motion blur, each with its own probability, and
timm-style RandomErasing on the normalized image.  Every draw comes from the item's
``np.random.RandomState`` in the JAX package's order, so a port item draws the same numbers
as a JAX item.  Host mode runs the pixel work here with cv2; device mode draws only the
parameters (``sample_device_params``) and the pixels go to ``data/device_pipeline.py``.
CLAHE stays on the host in both modes (``maybe_clahe``).  All functions take and return
uint8 HWC RGB except ``run_random_erasing``, which works on the normalized float image.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy.signal import convolve2d

from .codec import require_cv2

IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_rgb(rgb: np.ndarray) -> np.ndarray:
    """uint8 HWC RGB -> normalized float32 (base.py:103-108)."""
    return (rgb.astype(np.float32) / 255.0 - IMG_MEAN) / IMG_STD


def motion_blur_kernel(k: int, ang: float) -> np.ndarray:
    """(k, k) normalized line kernel at angle ``ang`` through the center."""
    kernel = np.zeros((k, k), np.float32)
    x0, y0 = k // 2, k // 2
    dx, dy = np.cos(ang), np.sin(ang)
    for t in np.linspace(-k / 2, k / 2, 2 * k):
        xi, yi = int(round(x0 + t * dx)), int(round(y0 + t * dy))
        if 0 <= xi < k and 0 <= yi < k:
            kernel[yi, xi] = 1.0
    kernel /= max(kernel.sum(), 1.0)
    return kernel


def gaussian_kernel2d(k: int, sigma: float) -> np.ndarray:
    """(k, k) separable Gaussian: exactly cv2.GaussianBlur's kernel."""
    g = require_cv2().getGaussianKernel(k, sigma).astype(np.float32)
    return g @ g.T


def _embed_center(kernel: np.ndarray, size: int) -> np.ndarray:
    out = np.zeros((size, size), np.float32)
    k = kernel.shape[0]
    o = (size - k) // 2
    out[o:o + k, o:o + k] = kernel
    return out


@dataclasses.dataclass
class AugmentConfig:
    clahe_prob: float = 0.5
    RGB_shift_prob: float = 0.5
    shift_limit: tuple = (-20, 20)
    color_jitter_prob: float = 0.5
    brightness: tuple = (0.6, 1.3)
    contrast: tuple = (0.6, 1.3)
    saturation: tuple = (0.6, 1.3)
    hue: tuple = (-0.15, 0.15)
    gaussian_blur_prob: float = 0.5
    blur_limit: tuple = (3, 7)
    sigma_limit: tuple = (0.2, 2.0)
    motion_blur_prob: float = 0.5
    motion_blur_limit: tuple = (3, 7)
    random_erasing_prob: float = 0.5
    random_erasing_min_area: float = 0.02
    random_erasing_max_area: float = 0.2
    # the reference passes this as timm's min_count with max_count
    # defaulting to it -> a triggered image erases EXACTLY this many regions
    random_erasing_max_count: int = 2
    # timm RandomErasing fill mode (base.py:391, --random_erasing_mode):
    # 'pixel' per-pixel noise, 'rand' one noise color per region, 'const' zeros
    random_erasing_mode: str = "pixel"


class ImageAugmentor:
    def __init__(self, cfg: AugmentConfig | None = None):
        self.cfg = cfg or AugmentConfig()
        # the device path's combined-kernel canvas: a Gaussian fully convolved with a motion
        # kernel spans max_g + max_m - 1, forced odd, from the configured limits
        k = int(self.cfg.blur_limit[1]) + int(self.cfg.motion_blur_limit[1]) - 1
        self.blur_k = k + (k + 1) % 2

    @classmethod
    def from_config(cls, cfg) -> "ImageAugmentor":
        """From a ``Config``'s augmentation flags (shared by the DexYCB and HO3D loaders)."""
        return cls(AugmentConfig(
            clahe_prob=cfg.clahe_prob, RGB_shift_prob=cfg.RGB_shift_prob,
            shift_limit=tuple(cfg.shift_limit),
            color_jitter_prob=cfg.color_jitter_prob,
            brightness=tuple(cfg.brightness), contrast=tuple(cfg.contrast),
            saturation=tuple(cfg.saturation), hue=tuple(cfg.hue),
            gaussian_blur_prob=cfg.gaussian_blur_prob,
            blur_limit=tuple(cfg.blur_limit),
            sigma_limit=tuple(cfg.sigma_limit),
            motion_blur_prob=cfg.motion_blur_prob,
            motion_blur_limit=tuple(cfg.motion_blur_limit),
            random_erasing_prob=cfg.random_erasing_prob,
            random_erasing_min_area=cfg.random_erasing_min_area,
            random_erasing_max_area=cfg.random_erasing_max_area,
            random_erasing_max_count=int(cfg.random_erasing_max_count),
            random_erasing_mode=cfg.random_erasing_mode,
        ))

    def run_color(self, rgb: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        c = self.cfg
        img = rgb
        if rng.rand() < c.clahe_prob:
            img = self._clahe(img, rng)
        if rng.rand() < c.RGB_shift_prob:
            # albumentations RGBShift: independent integer shift per channel
            shift = rng.randint(c.shift_limit[0], c.shift_limit[1] + 1, size=3)
            img = np.clip(img.astype(np.int16) + shift[None, None], 0, 255).astype(np.uint8)
        if rng.rand() < c.color_jitter_prob:
            img = self._color_jitter(img, rng)
        if rng.rand() < c.gaussian_blur_prob:
            k = int(rng.choice(np.arange(c.blur_limit[0], c.blur_limit[1] + 1, 2)))
            sigma = rng.uniform(*c.sigma_limit)
            img = require_cv2().GaussianBlur(img, (k, k), sigma)
        if rng.rand() < c.motion_blur_prob:
            img = self._motion_blur(img, rng)
        return img

    @staticmethod
    def _clahe(img: np.ndarray, rng) -> np.ndarray:
        # albumentations' CLAHE(clip_limit=4.0) draws the clip limit from U(1, 4) per call
        cv2 = require_cv2()
        lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
        clahe = cv2.createCLAHE(clipLimit=float(rng.uniform(1.0, 4.0)),
                                tileGridSize=(8, 8))
        lab[..., 0] = clahe.apply(lab[..., 0])
        return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)

    def _color_jitter(self, img: np.ndarray, rng) -> np.ndarray:
        c = self.cfg
        f = img.astype(np.float32)
        f = f * rng.uniform(*c.brightness)                          # brightness
        mean = f.mean()
        f = (f - mean) * rng.uniform(*c.contrast) + mean            # contrast
        cv2 = require_cv2()
        hsv = cv2.cvtColor(np.clip(f, 0, 255).astype(np.uint8), cv2.COLOR_RGB2HSV).astype(np.float32)
        hsv[..., 1] *= rng.uniform(*c.saturation)                   # saturation
        hsv[..., 0] = (hsv[..., 0] + rng.uniform(*c.hue) * 180) % 180  # hue
        hsv[..., 1:] = np.clip(hsv[..., 1:], 0, 255)
        return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)

    def _motion_blur(self, img: np.ndarray, rng) -> np.ndarray:
        c = self.cfg
        k = int(rng.choice(np.arange(c.motion_blur_limit[0], c.motion_blur_limit[1] + 1, 2)))
        return require_cv2().filter2D(img, -1, motion_blur_kernel(k, rng.rand() * np.pi))

    # -- device-preprocess parameter draws (data/device_pipeline.py) ---------------------

    def sample_device_params(self, rng: np.random.RandomState,
                             patch: int, mirror: bool = False) -> dict:
        """Every random knob of the device preprocess, drawn on the host.

        The trigger probabilities and distributions of ``run_color`` and
        ``run_random_erasing``, with identity values where an op does not trigger (shift 0,
        bcsh (1, 1, 1, 0), a delta kernel, h = 0 rects).  CLAHE is not drawn here: it stays
        on the host, on the frame before the warp (DEVIATIONS.md D15).

        ``mirror`` (left hands): the host blurs the patch and then flips it, the device folds
        the flip into the warp and blurs the flipped image; mirroring the kernel's columns
        makes the two orders equal.
        """
        c = self.cfg
        shift = np.zeros(3, np.float32)
        if rng.rand() < c.RGB_shift_prob:
            shift = rng.randint(c.shift_limit[0], c.shift_limit[1] + 1,
                                size=3).astype(np.float32)
        bcsh = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
        if rng.rand() < c.color_jitter_prob:
            bcsh = np.array([rng.uniform(*c.brightness),
                             rng.uniform(*c.contrast),
                             rng.uniform(*c.saturation),
                             rng.uniform(*c.hue)], np.float32)
        kern = np.zeros((1, 1), np.float32)
        kern[0, 0] = 1.0
        if rng.rand() < c.gaussian_blur_prob:
            k = int(rng.choice(np.arange(c.blur_limit[0], c.blur_limit[1] + 1, 2)))
            kern = gaussian_kernel2d(k, rng.uniform(*c.sigma_limit))
        if rng.rand() < c.motion_blur_prob:
            k = int(rng.choice(np.arange(c.motion_blur_limit[0],
                                         c.motion_blur_limit[1] + 1, 2)))
            km = motion_blur_kernel(k, rng.rand() * np.pi)
            # two correlations in turn are one correlation with the kernels' full convolution
            kern = convolve2d(kern, km, mode="full").astype(np.float32)
        rects = np.zeros((max(1, c.random_erasing_max_count), 4), np.int32)
        if rng.rand() < c.random_erasing_prob:
            count = c.random_erasing_max_count
            area = patch * patch
            for r in range(count):
                for _ in range(10):
                    target = rng.uniform(c.random_erasing_min_area,
                                         c.random_erasing_max_area) * area / count
                    ratio = np.exp(rng.uniform(np.log(0.3), np.log(1 / 0.3)))
                    h = int(round(np.sqrt(target * ratio)))
                    w = int(round(np.sqrt(target / ratio)))
                    if h < patch and w < patch:
                        rects[r] = (rng.randint(0, patch - h),
                                    rng.randint(0, patch - w), h, w)
                        break
        if mirror:
            kern = kern[:, ::-1]
        return {"rgb_shift": shift, "jitter_bcsh": bcsh,
                "blur_kernel": _embed_center(kern, self.blur_k),
                "erase_rects": rects}

    def maybe_clahe(self, rgb: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        if rng.rand() < self.cfg.clahe_prob:
            return self._clahe(rgb, rng)
        return rgb

    def run_random_erasing(self, norm_img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        """timm RandomErasing on the normalized HWC float image.

        Matches timm's semantics as the reference wires it
        (base.py:386-392 passes its ``random_erasing_max_count`` cfg value
        as timm's ``min_count``, and timm defaults max_count:=min_count):
        ONE probability gate per image, then exactly ``max_count`` regions,
        each with target area ~ U(min,max)*H*W / count (DEVIATIONS.md D15).
        """
        c = self.cfg
        if rng.rand() >= c.random_erasing_prob:
            return norm_img
        img = norm_img.copy()
        H, W = img.shape[:2]
        area = H * W
        count = c.random_erasing_max_count
        for _ in range(count):
            for _ in range(10):
                target = rng.uniform(c.random_erasing_min_area,
                                     c.random_erasing_max_area) * area / count
                ratio = np.exp(rng.uniform(np.log(0.3), np.log(1 / 0.3)))
                h = int(round(np.sqrt(target * ratio)))
                w = int(round(np.sqrt(target / ratio)))
                if h < H and w < W:
                    y = rng.randint(0, H - h)
                    x = rng.randint(0, W - w)
                    if c.random_erasing_mode == "pixel":
                        fill = rng.randn(h, w, img.shape[2])
                    elif c.random_erasing_mode == "rand":
                        fill = np.broadcast_to(rng.randn(1, 1, img.shape[2]),
                                               (h, w, img.shape[2]))
                    elif c.random_erasing_mode == "const":
                        fill = np.zeros((h, w, img.shape[2]))
                    else:
                        raise ValueError(c.random_erasing_mode)
                    img[y:y + h, x:x + w] = fill.astype(img.dtype)
                    break
        return img
