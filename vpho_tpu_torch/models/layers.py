"""Shared building blocks (counterpart of ``vpho_tpu/models/layers.py``), NCHW.

``compute_dtype`` (None or ``torch.bfloat16``) is the JAX package's bf16 policy: parameters
stay float32 and every conv / linear casts its input and weights to the compute dtype.
Batch norm always normalizes in float32 (as Flax does) and returns the input's dtype.
Attribute names follow the reference torch modules, so ``state_dict`` keys match the
reference checkpoints.

At each batch-norm site the norm, the call site's residual add and its activation go through
``bn_act``: on a card in eval mode with no autograd one hand-written pass (K4,
``ops/bn_act.py``), else ``bn_act_plain``, the same chain as separate operations.

Dropout (p = 0.1, the cross modules' only random op) is active under ``train()`` and takes its
keep masks from a ``DropoutMasks`` source, so that they are an input like every other draw.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed.nn.functional as dist_nn
import torch.nn as nn
import torch.nn.functional as F

from ..ops import bn_act as _k4
from ..parallel import mesh as _mesh


def activate(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """A BN site's activation: None, "leaky" (slope 0.01) or "relu"."""
    if act == "leaky":
        return F.leaky_relu(y, 0.01)
    return torch.relu(y) if act == "relu" else y


def bn_act_plain(bn: "BatchNorm2d", x: torch.Tensor, act: Optional[str] = None,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A BN site as separate operations: ``bn.normalize`` (train or eval mode), the residual
    added in the norm's dtype, the activation."""
    y = bn.normalize(x)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return activate(y, act)


def bn_act(bn: "BatchNorm2d", x: torch.Tensor, act: Optional[str] = None,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``activate(bn(x) + residual, act)``.  On a card in eval mode with no autograd recording,
    one launch of K4 (which raises on a layout or dtype it does not take); on the CPU, in train
    mode or under autograd, ``bn_act_plain``.  Both give the same numbers."""
    if x.device.type == "cpu" or bn.training or torch.is_grad_enabled():
        return bn_act_plain(bn, x, act, residual)
    return _k4.bn_act(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps, act,
                      None if residual is None else residual.to(x.dtype))


def _cast(dtype, *ts):
    return ts if dtype is None else tuple(None if t is None else t.to(dtype) for t in ts)


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype=None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return self._conv_forward(*_cast(self.compute_dtype, x, self.weight, self.bias))


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, compute_dtype=None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        x, w, b = _cast(self.compute_dtype, x, self.weight, self.bias)
        return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Linear(nn.Linear):
    def __init__(self, *args, compute_dtype=None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return F.linear(*_cast(self.compute_dtype, x, self.weight, self.bias))


class BatchNorm2d(nn.BatchNorm2d):
    """eps 1e-5, normalized in float32, returned in the input dtype.

    In train mode it follows Flax's ``nn.BatchNorm(momentum=0.9)``, not torch's: it normalizes
    with the biased batch variance and moves the running statistics to
    ``0.9 * old + 0.1 * batch`` with that same biased variance (torch would store the unbiased
    one).  ``num_batches_tracked`` stays untouched, as Flax keeps no such counter.

    While a process group is up (``parallel/mesh.py``) the train-mode statistics are those of
    the global batch, as under the JAX package's sharded jit: the per-channel sum and count are
    all-reduced in float32 (with autograd), then the sum of squared deviations from that mean,
    and every rank moves its running statistics by the same numbers.  The variance takes the
    two passes of the single-process path (cuDNN's), not Flax's E[x^2] - E[x]^2, which
    cancels where a channel's mean is large against its spread: at full width that form moved
    the physics head's gradients past ``chip_smoke.py``'s bar from the single-process step,
    where two passes stay at the rounding noise of a 1-ulp change of the input
    (``bench_torch_bn_variance.py``)."""

    def forward(self, x):
        return bn_act(self, x)

    def normalize(self, x):
        """The norm alone, as separate operations (``bn_act_plain``'s first step)."""
        x32 = x.float()
        if not self.training:
            y = F.batch_norm(x32, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
            return y.to(x.dtype)
        if _mesh.is_distributed():
            y, mean, var = self._cross_rank(x32)
        else:
            y = F.batch_norm(x32, None, None, self.weight, self.bias, True, 0.0, self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x32, dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return y.to(x.dtype)

    def _cross_rank(self, x32: torch.Tensor):
        C = x32.shape[1]
        count = x32.new_full((1,), x32.numel() // C)
        sums = dist_nn.all_reduce(torch.cat([x32.sum((0, 2, 3)), count]))
        mean = sums[:C] / sums[-1]
        d = x32 - mean[:, None, None]
        var = dist_nn.all_reduce((d * d).sum((0, 2, 3))) / sums[-1]
        y = d * (torch.rsqrt(var + self.eps) * self.weight)[:, None, None] + self.bias[:, None, None]
        return y, mean.detach(), var.detach()


def joints_mse_loss(pd_hm: torch.Tensor, gt_hm: torch.Tensor) -> torch.Tensor:
    """Plain MSE over heatmaps."""
    return torch.mean((pd_hm - gt_hm) ** 2)


class DropoutMasks:
    """The keep masks of one forward's dropout sites, handed out in call order.

    Each site asks for a mask of its shape.  The masks come from ``masks`` when given (e.g.
    the draws of another implementation, recorded in the same call order), else from
    ``generator`` (torch's default generator when None); every mask handed out is kept in
    ``drawn``, so a run can be replayed elsewhere.  The two forms are Flax's: ``__call__`` is
    ``nn.Dropout`` (kept values divided by the keep rate, the rest exactly 0) and
    ``attention`` the attention-weight dropout of ``MultiHeadDotProductAttention`` (one
    (q, k) mask shared by the batch and the heads, applied as a multiplier).

    With ``rows`` = ``(lo, hi, global_batch)`` (a data-parallel rank's slice) every mask of a
    batched site is drawn, or given, at the global batch and rows ``lo:hi`` are handed out;
    ``drawn`` keeps the global masks.  The attention mask is the whole batch's on every rank."""

    def __init__(self, rate: float = 0.1, masks: Optional[Sequence[torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 rows: Optional[Tuple[int, int, int]] = None):
        self.keep = 1.0 - rate
        self.given = None if masks is None else list(masks)
        self.generator = generator
        self.rows = rows
        self.drawn: List[torch.Tensor] = []

    def mask(self, shape, device, batched: bool = True) -> torch.Tensor:
        shape = tuple(shape)
        if batched and self.rows is not None:
            lo, hi, total = self.rows
            if shape[0] != hi - lo:
                raise ValueError(f"dropout: a site of batch {shape[0]} on rows {lo}:{hi}")
            return self._mask((total,) + shape[1:], device)[lo:hi]
        return self._mask(shape, device)

    def _mask(self, shape, device) -> torch.Tensor:
        if self.given is not None:
            if len(self.drawn) >= len(self.given):
                raise ValueError(f"dropout: {len(self.given)} masks given, site "
                                 f"{len(self.drawn) + 1} asks for another")
            m = torch.as_tensor(self.given[len(self.drawn)], device=device).bool()
            if tuple(m.shape) != shape:
                raise ValueError(f"dropout site {len(self.drawn) + 1}: mask {tuple(m.shape)}, "
                                 f"site {shape}")
        else:
            m = self.draw(shape, self.keep, self.generator, device)
        self.drawn.append(m)
        return m

    @staticmethod
    def draw(shape, keep: float, generator: Optional[torch.Generator], device) -> torch.Tensor:
        """One keep mask of ``shape`` from ``generator`` (torch's default when None)."""
        m = torch.rand(shape, generator=generator,
                       device=generator.device if generator is not None else device) < keep
        return m.to(device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(self.mask(x.shape, x.device), x / self.keep, torch.zeros_like(x))

    def attention(self, w: torch.Tensor) -> torch.Tensor:
        """w (B, heads, q, k) softmax weights."""
        m = self.mask((1, 1) + tuple(w.shape[-2:]), w.device, batched=False)
        return w * (m.to(w.dtype) / self.keep)


class Residual(nn.Module):
    """Pre-activation residual: BN-LReLU-1x1(C/2)-BN-LReLU-3x3(C/2)-BN-LReLU-1x1(C), with a
    1x1 projection skip (``conv4``) when the channel counts differ."""

    def __init__(self, in_ch: int, out_ch: int, compute_dtype=None):
        super().__init__()
        d = compute_dtype
        self.bn = BatchNorm2d(in_ch)
        self.conv1 = Conv2d(in_ch, out_ch // 2, 1, compute_dtype=d)
        self.bn1 = BatchNorm2d(out_ch // 2)
        self.conv2 = Conv2d(out_ch // 2, out_ch // 2, 3, padding=1, compute_dtype=d)
        self.bn2 = BatchNorm2d(out_ch // 2)
        self.conv3 = Conv2d(out_ch // 2, out_ch, 1, compute_dtype=d)
        self.conv4 = Conv2d(in_ch, out_ch, 1, compute_dtype=d) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(bn_act(self.bn, x, "leaky"))
        h = self.conv2(bn_act(self.bn1, h, "leaky"))
        h = self.conv3(bn_act(self.bn2, h, "leaky"))
        skip = x if self.conv4 is None else self.conv4(x)
        return h + skip.to(h.dtype)


class Encoder(nn.Module):
    """1x1 project + 4 blocks of 2 Residuals, each block followed by a 2x2 max pool.

    (B, C_in, 32, 32) -> flattened (B, 1024) plus the per-block maps (``x_ls[1]`` is the
    (B, 256, 8, 8) map that feeds the cross modules)."""

    def __init__(self, in_ch: int, hid_dim: int = 256, n_blocks: int = 4, n_modules: int = 2,
                 compute_dtype=None):
        super().__init__()
        self.n_modules = n_modules
        self.project = Conv2d(in_ch, hid_dim, 1, compute_dtype=compute_dtype)
        self.reg = nn.ModuleList([Residual(hid_dim, hid_dim, compute_dtype)
                                  for _ in range(n_blocks * n_modules)])

    def forward(self, x):
        x = self.project(x)
        x_ls = []
        for i, block in enumerate(self.reg):
            x = block(x)
            if (i + 1) % self.n_modules == 0:
                x = F.max_pool2d(x, 2, 2)
                x_ls.append(x)
        return x.reshape(x.shape[0], -1), x_ls


class HeadHeatmap(nn.Module):
    """conv3x3 -> conv3x3 -> BN -> (identity, the reference's ``LeakyReLU(True)``, D12) ->
    deconv4x4/s2 -> BN -> ReLU -> 1x1, the last conv in float32.  32x32 -> 64x64."""

    def __init__(self, in_ch: int, out_dim: int, hidden_dim: int = 128, compute_dtype=None):
        super().__init__()
        d = compute_dtype
        self.conv_layers = nn.Sequential(
            Conv2d(in_ch, hidden_dim, 3, padding=1, compute_dtype=d),
            Conv2d(hidden_dim, hidden_dim, 3, padding=1, compute_dtype=d),
            BatchNorm2d(hidden_dim),
        )
        self.deconv_layers = nn.Sequential(
            ConvTranspose2d(hidden_dim, hidden_dim // 2, 4, stride=2, padding=1, bias=False,
                            compute_dtype=d),
            BatchNorm2d(hidden_dim // 2),
        )
        self.final_layer = Conv2d(hidden_dim // 2, out_dim, 1)

    def forward(self, x):
        deconv, bn = self.deconv_layers
        x = bn_act(bn, deconv(self.conv_layers(x)), "relu")
        return self.final_layer(x.float())


def nerf_embed(x: torch.Tensor, multires: int = 10) -> torch.Tensor:
    """(..., D) -> (..., D * (1 + 2 * multires)): [x, sin(f0 x), cos(f0 x), sin(f1 x), ...]."""
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    angles = x[..., None, :] * freqs[:, None]
    enc = torch.stack([torch.sin(angles), torch.cos(angles)], dim=-2)
    return torch.cat([x, enc.reshape(x.shape[:-1] + (2 * multires * x.shape[-1],))], dim=-1)


def sinusoid_table(length: int, d_model: int, device=None) -> torch.Tensor:
    position = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                         * (-math.log(10000.0) / d_model))
    pe = torch.zeros((length, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class MultiheadAttention(nn.Module):
    """Self-attention with torch's ``nn.MultiheadAttention`` parameter layout (packed
    ``in_proj_weight`` [q; k; v]) over a batch-first (B, L, d) input."""

    def __init__(self, d_model: int, n_heads: int, compute_dtype=None):
        super().__init__()
        self.n_heads = n_heads
        self.compute_dtype = compute_dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model, compute_dtype=compute_dtype)

    def forward(self, x, dropout: Optional[DropoutMasks] = None):
        """``dropout`` drops attention weights (``DropoutMasks.attention``) in train mode."""
        B, L, d = x.shape
        hd = d // self.n_heads
        qkv = F.linear(*_cast(self.compute_dtype, x, self.in_proj_weight, self.in_proj_bias))
        q, k, v = qkv.reshape(B, L, 3, self.n_heads, hd).unbind(2)
        q = q / math.sqrt(hd)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        if dropout is not None:
            w = dropout.attention(w)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, L, d)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer (d_ff 2048, ReLU), LayerNorm eps 1e-6 as in the JAX package.
    In train mode dropout (p 0.1) hits, in this order, the attention weights, the attention
    output, the FFN's hidden layer and the FFN output; the masks come from ``dropout`` (a
    ``DropoutMasks``, torch's default generator when None)."""

    def __init__(self, d_model: int = 512, n_heads: int = 2, d_ff: int = 2048,
                 compute_dtype=None):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads, compute_dtype)
        self.linear1 = Linear(d_model, d_ff, compute_dtype=compute_dtype)
        self.linear2 = Linear(d_ff, d_model, compute_dtype=compute_dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x, dropout: Optional[DropoutMasks] = None):
        if not self.training:
            x = self.norm1((x + self.self_attn(x)).float())
            return self.norm2((x + self.linear2(torch.relu(self.linear1(x)))).float())
        drop = dropout if dropout is not None else DropoutMasks()
        x = self.norm1((x + drop(self.self_attn(x, drop))).float())
        ff = self.linear2(drop(torch.relu(self.linear1(x))))
        return self.norm2((x + drop(ff)).float())
