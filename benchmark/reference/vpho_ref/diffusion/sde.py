"""Score-SDE definitions (counterpart of ``vpho_tpu/diffusion/sde.py``).

Each SDE gives ``marginal_prob(x, t) -> (mean, std)``, ``sde(t) -> (drift_coeff,
diffusion_coeff)``, ``prior_std(T)`` and the integration window ``(eps, T)``.  ``t`` may be a
Python float (the sampler's grid coefficients) or a tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch


def _exp(x):
    return torch.exp(x) if isinstance(x, torch.Tensor) else math.exp(x)


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


@dataclasses.dataclass(frozen=True)
class SDE:
    name: str
    eps: float
    T: float
    marginal_prob: Callable[..., Tuple]
    sde: Callable[..., Tuple]
    prior_std: Callable[[float], float]


def init_sde(sde_mode: str = "ve") -> SDE:
    if sde_mode == "ve":
        sigma_min, sigma_max, eps, T = 0.01, 50.0, 1e-5, 1.0
        log_ratio = math.log(sigma_max) - math.log(sigma_min)

        def marginal_prob(x, t):
            return x, sigma_min * (sigma_max / sigma_min) ** t

        def sde_fn(t):
            sigma = sigma_min * (sigma_max / sigma_min) ** t
            return 0.0 * sigma, sigma * math.sqrt(2.0 * log_ratio)

        def prior_std(T0):
            return marginal_prob(None, T0)[1]

    elif sde_mode == "edm":
        sigma_max, eps = 80.0, 0.002
        T = sigma_max

        def marginal_prob(x, t):
            return x, t

        def sde_fn(t):
            return 0.0 * t, _sqrt(2.0 * t)

        def prior_std(T0):
            return sigma_max

    elif sde_mode in ("vp", "subvp"):
        beta_0, beta_1, eps, T = 0.1, 20.0, 1e-3, 1.0

        def marginal_prob(x, t):
            log_mean_coeff = -0.25 * t ** 2 * (beta_1 - beta_0) - 0.5 * t * beta_0
            mean = _exp(log_mean_coeff) * x if x is not None else None
            var_part = 1.0 - _exp(2.0 * log_mean_coeff)
            return mean, _sqrt(var_part) if sde_mode == "vp" else var_part

        def sde_fn(t):
            beta_t = beta_0 + t * (beta_1 - beta_0)
            if sde_mode == "vp":
                return -0.5 * beta_t, _sqrt(beta_t)
            discount = 1.0 - _exp(-2 * beta_0 * t - (beta_1 - beta_0) * t ** 2)
            return -0.5 * beta_t, _sqrt(beta_t * discount)

        def prior_std(T0):
            return 1.0

    else:
        raise NotImplementedError(f"unknown sde_mode: {sde_mode}")

    return SDE(name=sde_mode, eps=eps, T=T, marginal_prob=marginal_prob, sde=sde_fn,
               prior_std=prior_std)
