"""Convert a JAX-package training checkpoint (an orbax ``checkpoint/epoch_N.state`` directory)
into the PyTorch port's ``epoch_N.state`` file, so that ``vpho_tpu_torch`` resumes from it:

    python orbax_to_torch.py <run>/checkpoint/epoch_N.state <out>/epoch_N.state
    python -m vpho_tpu_torch.cli --mode train --checkpoint <out>/epoch_N.state ...

Run it where JAX and orbax are installed (the port itself imports neither).  The output is the
layout of ``vpho_tpu_torch.engine.trainer.Trainer.save_checkpoint``:

  * ``params``, ``batch_stats`` and ``buffers``: the Flax variables through the port's
    ``state_dict_from_jax`` (the reference's key names), split as the port's model splits them;
  * ``opt_state``: the optax chain's Adam moments and count and, under
    ``--gradient_accumulation_steps`` > 1, ``MultiSteps``' running mean of the gradients and its
    mini-step, in ``Optimizer.state_dict()``'s layout (the clip and the decay keep no state);
  * ``step``: the train-step calls so far.

The output's file name keeps ``epoch_N``, which the port reads as the epoch to resume at.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import numpy as np


def _find(tree: Any, keys) -> Optional[Dict[str, Any]]:
    """The first dict in ``tree`` (orbax restores optax's tuples as lists and its named tuples
    as dicts) that holds every key of ``keys``."""
    if isinstance(tree, dict):
        if set(keys) <= set(tree):
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        hit = _find(child, keys)
        if hit is not None:
            return hit
    return None


def convert(src: str, dst: str) -> Dict[str, Any]:
    """Read the orbax directory ``src`` and write the port's checkpoint file ``dst``; returns
    the payload written."""
    import orbax.checkpoint as ocp
    import torch

    from vpho_tpu_torch.models.vpho import ModelConfig, build_model
    from vpho_tpu_torch.utils.weights import state_dict_from_jax

    raw = ocp.StandardCheckpointer().restore(os.path.abspath(src))
    as_np = lambda tree: {k: as_np(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else np.asarray(tree)
    stats, buffers = as_np(raw["batch_stats"]), as_np(raw["buffers"])
    to_sd = lambda params: state_dict_from_jax({"params": as_np(params), "batch_stats": stats,
                                                "buffers": buffers})
    sd = to_sd(raw["params"])
    names = [k for k, _ in build_model(ModelConfig(), seed=0, device="cpu").named_parameters()]
    params = {k: sd[k] for k in names}
    split = {"params": params,
             "batch_stats": {k: v for k, v in sd.items() if k.endswith(
                 ("running_mean", "running_var", "num_batches_tracked"))},
             "buffers": {}}
    split["buffers"] = {k: v for k, v in sd.items()
                        if k not in params and k not in split["batch_stats"]}

    adam = _find(raw["opt_state"], ("count", "mu", "nu"))
    if adam is None:
        raise ValueError(f"{src}: no Adam state in the optimizer state")
    multi = _find(raw["opt_state"], ("mini_step", "acc_grads", "inner_opt_state"))
    pick = lambda tree: (lambda sd: {k: sd[k] for k in names})(to_sd(tree))
    opt = {"mu": pick(adam["mu"]), "nu": pick(adam["nu"]),
           "acc": None if multi is None else pick(multi["acc_grads"]),
           "count": int(adam["count"]),
           "mini_step": 0 if multi is None else int(multi["mini_step"])}
    payload = {**split, "opt_state": opt, "step": int(raw["step"])}
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    torch.save(payload, dst)
    return payload


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="the JAX package's orbax checkpoint/epoch_N.state directory")
    p.add_argument("dst", help="the port's epoch_N.state file to write")
    args = p.parse_args(argv)
    payload = convert(args.src, args.dst)
    print(f"wrote {args.dst}: {len(payload['params'])} params, step {payload['step']}, "
          f"optimizer count {payload['opt_state']['count']}")


if __name__ == "__main__":
    main()
