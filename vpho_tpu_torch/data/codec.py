"""Frame decoding and encoding for the loaders: OpenCV, as the JAX package decodes.

``cv2`` is imported where a frame is read or written, so the port imports without it; a
loader that has to decode a frame without it raises.  ``decoder()`` names what decodes.
"""
from __future__ import annotations

import numpy as np


def require_cv2():
    try:
        import cv2
    except ImportError as exc:
        raise ImportError("reading or writing DexYCB / HO3D frames needs OpenCV (cv2), as the "
                          "JAX package's loaders; install opencv-python") from exc
    return cv2


def decoder() -> str:
    """The library that decodes frames, with its version."""
    return f"cv2 {require_cv2().__version__}"


def imread_rgb(path: str) -> np.ndarray:
    """A JPEG or PNG file -> (H, W, 3) uint8 RGB."""
    img = require_cv2().imread(path)
    if img is None:
        raise FileNotFoundError(f"cannot read an image from {path}")
    return img[..., ::-1].copy()


def imwrite_rgb(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 RGB -> a JPEG or PNG file, by the name's extension."""
    if not require_cv2().imwrite(path, np.ascontiguousarray(rgb[..., ::-1])):
        raise OSError(f"cannot write an image to {path}")
