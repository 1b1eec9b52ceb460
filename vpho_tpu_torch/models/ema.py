"""Parameter EMA (counterpart of ``vpho_tpu/models/ema.py``; the trainer does not use it).

Functional: ``ema_init`` / ``ema_update`` act on ``{name: tensor}`` parameter dicts, and the
decay warms up as ``min(decay, (1 + n) / (10 + n))`` over the first updates.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]


class EMAState(NamedTuple):
    params: Params
    num_updates: int


def ema_init(params: Params) -> EMAState:
    return EMAState(params={k: v.detach().clone() for k, v in params.items()}, num_updates=0)


@torch.no_grad()
def ema_update(state: EMAState, new_params: Params, decay: float = 0.999) -> EMAState:
    n = state.num_updates + 1
    d = min(decay, (1.0 + n) / (10.0 + n))
    upd = {k: e * d + new_params[k].detach() * (1.0 - d) for k, e in state.params.items()}
    return EMAState(params=upd, num_updates=n)


def ema_swap(state: EMAState, params: Params) -> Tuple[Params, Params]:
    """(ema_params, backup): evaluate with the shadow weights, restore with the backup."""
    return state.params, params
