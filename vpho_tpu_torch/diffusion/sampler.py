"""Probability-flow ODE sampler (counterpart of ``vpho_tpu/diffusion/sampler.py``).

Integrates the reverse probability-flow ODE from ``T0`` down to ``sde.eps`` on the uniform
grid ``linspace(T0, eps, num_steps)`` with DPM-Solver++(3M) (one score evaluation per grid
transition, third order), then applies the final reverse-diffusion Euler step.  The grid
coefficients are host floats, so the loop never waits on the device.

The start state ``x0`` is an argument: the caller draws it (``sde.prior_std(T0)`` times a
standard normal) with its own generator, or hands in the array another implementation drew.
"""
from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch

from .sde import SDE

ScoreFn = Callable[[torch.Tensor, float], torch.Tensor]   # (x (R, D), t) -> score (R, D)


def time_grid(sde: SDE, T0: float, num_steps: int, schedule: str = "uniform") -> List[float]:
    """Grid t_0 = T0 > ... > t_{n-1} = eps, each point rounded to float32."""
    if schedule != "uniform":
        raise NotImplementedError(f"time grid {schedule!r} is not ported yet")
    return [float(t) for t in np.linspace(T0, sde.eps, num_steps).astype(np.float32)]


def _score(score_fn: ScoreFn, x: torch.Tensor, t: float) -> torch.Tensor:
    return torch.nan_to_num(score_fn(x, t), nan=0.0, posinf=0.0, neginf=0.0)


def dpm3m(score_fn: ScoreFn, sde: SDE, x0: torch.Tensor, ts: List[float]) -> torch.Tensor:
    """DPM-Solver++(3M) in log-SNR time; the first two transitions run at order 1 and 2."""
    alp = [float(sde.marginal_prob(1.0, t)[0]) for t in ts]
    sig = [float(sde.marginal_prob(0.0, t)[1]) for t in ts]
    lam = [math.log(a) - math.log(s) for a, s in zip(alp, sig)]
    h = [lam[i + 1] - lam[i] for i in range(len(ts) - 1)]
    x = x0
    d_p1 = d_p2 = None
    for i in range(len(ts) - 1):
        score = _score(score_fn, x, ts[i])
        d = (x + (sig[i] ** 2) * score) / alp[i]
        phi1 = math.expm1(-h[i])
        phi2 = phi1 / h[i] + 1.0
        phi3 = phi2 / h[i] - 0.5
        base = (sig[i + 1] / sig[i]) * x - (alp[i + 1] * phi1) * d
        if i == 0:
            x = base
        elif i == 1:
            x = base + (alp[i + 1] * phi2) * ((d - d_p1) / (h[i - 1] / h[i]))
        else:
            r0, r1 = h[i - 1] / h[i], h[i - 2] / h[i]
            d1_0 = (d - d_p1) / r0
            d1_1 = (d_p1 - d_p2) / r1
            d1 = d1_0 + (r0 / (r0 + r1)) * (d1_0 - d1_1)
            d2 = (d1_0 - d1_1) / (r0 + r1)
            x = base + alp[i + 1] * (phi2 * d1 - phi3 * d2)
        d_p2, d_p1 = d_p1, d
    return x


def denoise_step(score_fn: ScoreFn, sde: SDE, x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Final reverse-diffusion predictor Euler step at t = eps."""
    drift_coeff, diffusion = sde.sde(sde.eps)
    score = _score(score_fn, x, sde.eps)
    drift = drift_coeff * x - (diffusion ** 2) * score
    return x + drift * ((1.0 - sde.eps) / num_steps)


def ode_sampler(score_fn: ScoreFn, x0: torch.Tensor, sde: SDE, T0: float, num_steps: int,
                method: str = "dpm3m", schedule: str = "uniform",
                denoise: bool = True) -> torch.Tensor:
    """Integrate from the start state ``x0`` (R, D); returns the final (R, D) sample."""
    if method != "dpm3m":
        raise NotImplementedError(f"ODE integrator {method!r} is not ported yet")
    x = dpm3m(score_fn, sde, x0, time_grid(sde, T0, num_steps, schedule))
    return denoise_step(score_fn, sde, x, num_steps) if denoise else x
