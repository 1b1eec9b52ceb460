"""Image sampling ops on NCHW tensors (counterpart of ``vpho_tpu/ops/image.py``).

The JAX package writes each of these as dense separable weight contractions; the port keeps
the same formulation, so the numbers match without gathers:
  * ``sample_points``: per-channel point lookup, bicubic (Keys, A = -0.75) or bilinear
  * ``resample_rectilinear``: bilinear resample on a rectilinear grid
  * ``roi_align``: torchvision ``roi_align`` (aligned=False) with a fixed 2x2 sampling grid
    per bin (DEVIATIONS.md D4)
  * ``resize_bilinear``: ``jax.image.resize(..., "bilinear")``, antialiased when shrinking
  * ``affine_warp``: ``cv2.warpAffine`` bicubic crops for the device preprocess, as 4-tap
    gathers (the JAX package's dense weights would be GBs at a full batch)
Normalized coordinates follow torch's ``grid_sample`` with ``align_corners=False``.
"""
from __future__ import annotations

import torch


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _keys_kernel(d: torch.Tensor, A: float = -0.75) -> torch.Tensor:
    """Keys cubic-convolution kernel, zero for |d| >= 2."""
    ad = d.abs()
    ad2, ad3 = ad * ad, ad * ad * ad
    near = (A + 2.0) * ad3 - (A + 3.0) * ad2 + 1.0
    far = A * (ad3 - 5.0 * ad2 + 8.0 * ad - 4.0)
    return torch.where(ad < 1.0, near, torch.where(ad < 2.0, far, torch.zeros_like(ad)))


def _tent_kernel(d: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - d.abs(), 0.0)


def _axis(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=like.dtype, device=like.device)


def sample_points(input: torch.Tensor, pts: torch.Tensor, mode: str = "bicubic",
                  align_corners: bool = False) -> torch.Tensor:
    """input (B, J, H, W); pts (B, N, J, 2) normalized (x, y) -> (B, N, J)."""
    B, J, H, W = input.shape
    kern = {"bicubic": _keys_kernel, "bilinear": _tent_kernel}[mode]
    x = _unnormalize(pts[..., 0], W, align_corners)
    y = _unnormalize(pts[..., 1], H, align_corners)
    wx = kern(_axis(W, x) - x[..., None])                        # (B, N, J, W)
    wy = kern(_axis(H, y) - y[..., None])                        # (B, N, J, H)
    rows = torch.einsum("bjhw,bnjw->bnjh", input, wx)
    return (rows * wy).sum(-1)


def resample_rectilinear(x: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W); xs (B, Wout) / ys (B, Hout) absolute pixel coords ->
    (B, C, Hout, Wout), zero padding outside the image."""
    H, W = x.shape[-2:]
    wx = _tent_kernel(_axis(W, xs) - xs[..., None])               # (B, Wout, W)
    wy = _tent_kernel(_axis(H, ys) - ys[..., None])               # (B, Hout, H)
    rows = torch.einsum("bchw,bsw->bchs", x, wx.to(x.dtype))
    return torch.einsum("bchs,bth->bcts", rows, wy.to(x.dtype))


def roi_align(features: torch.Tensor, boxes: torch.Tensor, output_size: int,
              spatial_scale: float = 0.25, sampling_ratio: int = 2) -> torch.Tensor:
    """features (B, C, H, W); boxes (B, 4) xyxy in input coords, one ROI per sample ->
    (B, C, output_size, output_size)."""
    B, C, H, W = features.shape
    box = boxes.float() * spatial_scale
    x1, y1 = box[:, 0], box[:, 1]
    roi_w = torch.clamp_min(box[:, 2] - x1, 1.0)
    roi_h = torch.clamp_min(box[:, 3] - y1, 1.0)
    ii = _axis(output_size, box)
    ss = (_axis(sampling_ratio, box) + 0.5) / sampling_ratio
    grid01 = ii[:, None] + ss[None, :]                            # (os, sr)
    ys = y1[:, None, None] + grid01 * (roi_h[:, None, None] / output_size)
    xs = x1[:, None, None] + grid01 * (roi_w[:, None, None] / output_size)
    wx = _tent_kernel(_axis(W, xs) - xs[..., None]).mean(2)       # (B, os, W)
    wy = _tent_kernel(_axis(H, ys) - ys[..., None]).mean(2)       # (B, os, H)
    rows = torch.einsum("bchw,bsw->bchs", features, wx.to(features.dtype))
    return torch.einsum("bchs,bth->bcts", rows, wy.to(features.dtype))


def resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(out, in) weights of ``jax.image.resize`` with the triangle kernel: the kernel widens by
    in/out when shrinking, each column is normalized, and samples outside the input are 0."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None])
    w = _tent_kernel(x.abs() / kernel_scale)                      # (in, out)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T


def resize_bilinear(x: torch.Tensor, size: tuple) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size[0], size[1]) with ``jax.image.resize`` bilinear weights."""
    H, W = x.shape[-2:]
    if H != size[0]:
        x = torch.einsum("bchw,th->bctw", x, resize_weights(H, size[0], x.device).to(x.dtype))
    if W != size[1]:
        x = torch.einsum("bchw,sw->bchs", x, resize_weights(W, size[1], x.device).to(x.dtype))
    return x


def _resample(src: torch.Tensor, dim: int, coord: torch.Tensor) -> torch.Tensor:
    """Keys-cubic resample of ``src`` along ``dim`` at ``coord``, zero outside the image.

    ``coord`` holds one source position per output element: its shape is ``src``'s without the
    channel axis and with ``dim`` resized.  The kernel is 0 for |d| >= 2, so the four taps
    floor(coord) - 1 .. floor(coord) + 2 are all of its support; taps outside [0, n) weigh 0.
    """
    n = src.shape[dim]
    base = torch.floor(coord) - 1.0
    out = None
    for k in range(4):
        pos = base + k
        w = _keys_kernel(pos - coord) * ((pos >= 0) & (pos <= n - 1))
        idx = pos.clamp(0, n - 1).long()[..., None].expand(coord.shape + (src.shape[-1],))
        term = torch.gather(src, dim, idx).float() * w[..., None]
        out = term if out is None else out + term
    return out


def affine_warp(img: torch.Tensor, minv: torch.Tensor, out_size: int) -> torch.Tensor:
    """Batched inverse-affine warp with ``cv2.warpAffine`` semantics, NHWC.

    img (B, H, W, C), uint8 or float; minv (B, 2, 3) the DST -> SRC affine (the inverse of the
    matrix given to cv2) -> (B, P, P, C) float32, P = ``out_size``.  Bicubic (Keys, A = -0.75,
    cv2's INTER_CUBIC), zero border, pixel centres at integer coordinates.

    Two 1-D passes, as the JAX package's ``affine_warp``:
      * pass 1 resamples every source row h in x, at the column where output column j meets
        row h: x(h, j) = m00 j + m01 i(h, j) + m02 with i(h, j) = (h - m12 - m10 j) / m11
        (rows that pass 2 does not reach weigh 0 there; the shapes depend on nothing but the
        input's, so a CUDA graph captures the warp);
      * pass 2 resamples that in y at each output pixel's source row
        y(i, j) = m10 j + m11 i + m12.
    Without rotation (eval crops: m01 = m10 = 0) x depends on j alone and y on i alone, and the
    passes are the separable bicubic product, cv2's own and the JAX package's rectilinear
    path.  Under rotation the composition is the JAX package's sheared cubic product (within
    ~2/255 mean of cv2).  Each pass is four gathers and weighted sums in float32, where the
    JAX package contracts dense (b, H, P, W) weights, in bfloat16 under rotation.
    """
    B, H, W, _ = img.shape
    P = out_size
    m = minv.to(device=img.device, dtype=torch.float32)
    m00, m01, m02 = (m[:, 0, k, None, None] for k in range(3))
    m10, m11, m12 = (m[:, 1, k, None, None] for k in range(3))
    jj = torch.arange(P, dtype=torch.float32, device=img.device)
    hh = torch.arange(H, dtype=torch.float32, device=img.device)
    i_of = (hh[:, None] - m12 - m10 * jj) / m11                    # (B, H, P)
    rows = _resample(img, 2, m00 * jj + m01 * i_of + m02)
    return _resample(rows, 1, m10 * jj + m11 * jj[:, None] + m12)  # (B, P, P, C)
