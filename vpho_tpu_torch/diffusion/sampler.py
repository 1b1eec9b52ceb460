"""Probability-flow ODE sampler (counterpart of ``vpho_tpu/diffusion/sampler.py``).

Integrates the reverse probability-flow ODE from ``T0`` down to ``sde.eps`` on a fixed grid
(``uniform``: ``linspace(T0, eps, num_steps)``; ``karras``: rho-spaced in sigma), then applies
the final reverse-diffusion Euler step.  Integrators and their score evaluations per grid
transition: ``euler`` 1, ``heun`` 2, ``rk4`` 4, ``dpm2m`` 1 (DPM-Solver++(2M)) and ``dpm3m`` 1
(DPM-Solver++(3M)); the denoise step adds one more.  The grid and every coefficient are host
floats, so the loop never waits on the device.

The start state ``x0`` is an argument: the caller draws it (``sde.prior_std(T0)`` times a
standard normal) with its own generator, or hands in the array another implementation drew.
"""
from __future__ import annotations

import math
from typing import Callable, Iterator, List

import numpy as np
import torch

from .sde import SDE

ScoreFn = Callable[[torch.Tensor, float], torch.Tensor]   # (x (R, D), t) -> score (R, D)

# score evaluations per grid transition
EVALS_PER_STEP = {"euler": 1, "heun": 2, "rk4": 4, "dpm2m": 1, "dpm3m": 1}


def time_grid(sde: SDE, T0: float, num_steps: int, schedule: str = "uniform",
              rho: float = 7.0) -> List[float]:
    """Grid t_0 = T0 > ... > t_{n-1} = eps, each point rounded to float32.  ``karras`` spaces
    sigma as (s_hi^(1/rho) + f (s_lo^(1/rho) - s_hi^(1/rho)))^rho and maps it back to t by
    interpolating the SDE's own sigma(t) on a dense grid."""
    if schedule == "uniform":
        ts = np.linspace(T0, sde.eps, num_steps)
    elif schedule == "karras":
        t_dense = np.linspace(sde.eps, T0, 1025).astype(np.float32).astype(np.float64)
        s_dense = np.array([float(sde.marginal_prob(0.0, float(t))[1]) for t in t_dense])
        s_lo, s_hi = s_dense[0], s_dense[-1]
        frac = np.linspace(0.0, 1.0, num_steps)
        inv = 1.0 / rho
        sig = (s_hi ** inv + frac * (s_lo ** inv - s_hi ** inv)) ** rho
        ts = np.interp(sig, s_dense, t_dense)
    else:
        raise NotImplementedError(schedule)
    return [float(t) for t in ts.astype(np.float32)]


def score_evals(method: str, num_steps: int, denoise: bool = True) -> int:
    """Score evaluations of one ``ode_sampler`` call."""
    return EVALS_PER_STEP[method] * (num_steps - 1) + int(denoise)


def _score(score_fn: ScoreFn, x: torch.Tensor, t: float) -> torch.Tensor:
    return torch.nan_to_num(score_fn(x, t), nan=0.0, posinf=0.0, neginf=0.0)


def _ode_rhs(score_fn: ScoreFn, sde: SDE, x: torch.Tensor, t: float) -> torch.Tensor:
    """dx/dt = f(x, t) - g(t)^2 score(x, t) / 2 (the drift coefficient is 0 for the VE SDE)."""
    drift_coeff, diffusion = sde.sde(t)
    return drift_coeff * x - (0.5 * diffusion ** 2) * _score(score_fn, x, t)


def _explicit(method: str):
    def run(score_fn: ScoreFn, sde: SDE, x: torch.Tensor, ts: List[float]) -> Iterator:
        for t0, t1 in zip(ts[:-1], ts[1:]):
            h = t1 - t0
            k1 = _ode_rhs(score_fn, sde, x, t0)
            if method == "euler":
                x = x + h * k1
            elif method == "heun":
                k2 = _ode_rhs(score_fn, sde, x + h * k1, t1)
                x = x + (0.5 * h) * (k1 + k2)
            else:                                                    # rk4
                tm = t0 + 0.5 * h
                k2 = _ode_rhs(score_fn, sde, x + (0.5 * h) * k1, tm)
                k3 = _ode_rhs(score_fn, sde, x + (0.5 * h) * k2, tm)
                k4 = _ode_rhs(score_fn, sde, x + h * k3, t1)
                x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            yield x
    return run


def _log_snr_grid(sde: SDE, ts: List[float]):
    alp = [float(sde.marginal_prob(1.0, t)[0]) for t in ts]
    sig = [float(sde.marginal_prob(0.0, t)[1]) for t in ts]
    lam = [math.log(a) - math.log(s) for a, s in zip(alp, sig)]
    return alp, sig, [lam[i + 1] - lam[i] for i in range(len(ts) - 1)]


def dpm2m(score_fn: ScoreFn, sde: SDE, x: torch.Tensor, ts: List[float]) -> Iterator:
    """DPM-Solver++(2M) in log-SNR time: the denoised prediction D is extrapolated through
    the previous step's D; the first transition runs at order 1."""
    alp, sig, h = _log_snr_grid(sde, ts)
    d_prev = None
    for i in range(len(ts) - 1):
        d = (x + (sig[i] ** 2) * _score(score_fn, x, ts[i])) / alp[i]
        if i == 0:
            d_use = d
        else:
            c = 0.5 / (h[i - 1] / h[i])
            d_use = (1.0 + c) * d - c * d_prev
        x = (sig[i + 1] / sig[i]) * x - (alp[i + 1] * math.expm1(-h[i])) * d_use
        d_prev = d
        yield x


def dpm3m(score_fn: ScoreFn, sde: SDE, x: torch.Tensor, ts: List[float]) -> Iterator:
    """DPM-Solver++(3M) in log-SNR time; the first two transitions run at order 1 and 2."""
    alp, sig, h = _log_snr_grid(sde, ts)
    d_p1 = d_p2 = None
    for i in range(len(ts) - 1):
        d = (x + (sig[i] ** 2) * _score(score_fn, x, ts[i])) / alp[i]
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
        yield x


INTEGRATORS = {"euler": _explicit("euler"), "heun": _explicit("heun"), "rk4": _explicit("rk4"),
               "dpm2m": dpm2m, "dpm3m": dpm3m}


def denoise_step(score_fn: ScoreFn, sde: SDE, x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Final reverse-diffusion predictor Euler step at t = eps."""
    drift_coeff, diffusion = sde.sde(sde.eps)
    score = _score(score_fn, x, sde.eps)
    drift = drift_coeff * x - (diffusion ** 2) * score
    return x + drift * ((1.0 - sde.eps) / num_steps)


def ode_sampler(score_fn: ScoreFn, x0: torch.Tensor, sde: SDE, T0: float, num_steps: int,
                method: str = "dpm3m", schedule: str = "uniform", denoise: bool = True,
                return_trajectory: bool = False):
    """Integrate from the start state ``x0`` (R, D).  Returns the final (R, D) sample, or with
    ``return_trajectory`` the pair ``(trajectory, final)``, where trajectory (R, num_steps, D)
    holds the state at each grid point (``x0`` first) before the denoise step."""
    if method not in INTEGRATORS:
        raise NotImplementedError(method)
    x, traj = x0, [x0]
    for x in INTEGRATORS[method](score_fn, sde, x0, time_grid(sde, T0, num_steps, schedule)):
        if return_trajectory:
            traj.append(x)
    if denoise:
        x = denoise_step(score_fn, sde, x, num_steps)
    return (torch.stack(traj, dim=1), x) if return_trajectory else x
