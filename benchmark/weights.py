"""The benchmark's weights: one VPHONet state_dict drawn from the run's seed on the device.

Both sides get these: ``load_state_dict`` copies them into the port's model after its own
``Trainer.init_state``, and the reference builds its model from them.  The leaves are cut from
a few large draws of one ``torch.Generator`` on the device (float32, the dtype the parameters
are served in), in the scheme of the port's well-posed checks (``chip_smoke.py::spread_weights``):
kernels at 1/sqrt(fan_in), small non-zero biases, batch-norm statistics away from (0, 1), the
heatmap heads biased to positive heat as a trained head's is, and the score heads' last layer
at 0.01, so that the ODE's score is neither zero nor large.  The Fourier features of the
diffusion time keep their N(0, 30) scale.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch

from .reference.vpho_ref.models import vpho as RV


def _rule(name: str, shape: Tuple[int, ...]) -> Tuple[str, float, float]:
    """(kind, mean, std) of one leaf; kind "normal", "lognormal" (running variances) or
    "zero" (counters)."""
    if name.endswith("num_batches_tracked"):
        return "zero", 0.0, 0.0
    if name.endswith("t_encoder.0.W"):
        return "normal", 0.0, 30.0
    if name.endswith("running_var"):
        return "lognormal", 0.0, 0.3
    if name.startswith(("denoiser_hand.head.head.2", "denoiser_obj.head.head.2")):
        return "normal", 0.0, 0.01
    if name.startswith(("head_hm_hand.final_layer.bias", "head_hm_obj.final_layer.bias")):
        return "normal", 1.0, 0.0
    if len(shape) >= 2:
        fan_in = shape[1] if len(shape) == 3 else int(torch.Size(shape[1:]).numel())
        return "normal", 0.0, fan_in ** -0.5
    if name.endswith("weight"):
        return "normal", 1.0, 0.1
    return "normal", 0.0, 0.1 if name.endswith("running_mean") else 0.02


@functools.lru_cache(maxsize=1)
def layout() -> List[Tuple[str, Tuple[int, ...], torch.dtype]]:
    """The state_dict's leaves (name, shape, dtype), from the reference model built on the
    meta device: the same 982 keys the port loads strictly."""
    with torch.device("meta"):
        model = RV.VPHONet()
    return [(k, tuple(v.shape), v.dtype) for k, v in model.state_dict().items()]


@torch.no_grad()
def make_state_dict(seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's weights: views into three flat buffers (the normal and lognormal leaves'
    draws, and the integer counters)."""
    leaves = layout()
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    floats = [(n, s, _rule(n, s)) for n, s, d in leaves if d.is_floating_point]
    floats.sort(key=lambda x: x[2][0] == "lognormal")          # the lognormal leaves last
    sizes = [int(torch.Size(s).numel()) for _, s, _ in floats]
    mean = torch.tensor([r[1] for _, _, r in floats], dtype=torch.float32, device=device)
    std = torch.tensor([r[2] for _, _, r in floats], dtype=torch.float32, device=device)
    counts = torch.tensor(sizes, device=device)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.mul_(std.repeat_interleave(counts)).add_(mean.repeat_interleave(counts))
    n_log = sum(sz for sz, (_, _, r) in zip(sizes, floats) if r[0] == "lognormal")
    flat[flat.numel() - n_log:].exp_()
    out = {n: t.view(s) for (n, s, _), t in zip(floats, flat.split(sizes))}
    ints = [(n, s, d) for n, s, d in leaves if not d.is_floating_point]
    zeros = torch.zeros(sum(int(torch.Size(s).numel()) for _, s, _ in ints), dtype=torch.int64,
                        device=device)
    out.update({n: t.view(s) for (n, s, _), t in
                zip(ints, zeros.split([int(torch.Size(s).numel()) for _, s, _ in ints]))})
    return {n: out[n] for n, _, _ in leaves}
