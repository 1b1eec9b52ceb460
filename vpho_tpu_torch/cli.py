"""Console entry point of the port (installed as ``vpho-torch``):

    python -m vpho_tpu_torch.cli --mode eval --eval_batch_size 64 --sample_num 100 ...

The flags are the JAX CLI's (``main.py``).  It runs on the GPU; to run on the CPU, call
``vpho_tpu_torch.engine.runner.run(cfg, device="cpu")`` from Python.
"""
from __future__ import annotations


def train_eval_main(argv=None):
    """Eval / infer dispatch: the port's ``main.py``."""
    from .configs.config import get_config
    from .engine.runner import run

    return run(get_config(argv))


if __name__ == "__main__":
    train_eval_main()
