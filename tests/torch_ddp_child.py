"""One rank of ``tests/test_torch_port_ddp.py``: a gloo process group over localhost, then one
train step and one eval of the port's ``Trainer`` on the rank's rows of the inputs that the
parent saved; the results go to ``<workdir>/rank<r>.pt``.  Imports no jax.

    python tests/torch_ddp_child.py <workdir> <port> <rank> <world>

The parent runs the same ``step_and_eval`` in its own process, with no process group, as the
one-rank reference.
"""
import builtins
import hashlib
import io
import os
import sys

import torch

from vpho_tpu_torch.configs.config import get_config
from vpho_tpu_torch.engine import trainer as TT
from vpho_tpu_torch.engine.runner import synthetic_stream
from vpho_tpu_torch.models.layers import DropoutMasks
from vpho_tpu_torch.parallel import mesh

ARGV = ["--repeat_num", "2", "--patch_size", "64", "--sample_num", "2", "--sampling_steps", "2",
        "--topk_hand", "1", "--topk_obj", "1", "--eval_batch_size", "5", "--viz_freq", "1"]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def step_and_eval(inputs, out_dir: str):
    """``evaluate`` and ``dump_predictions`` of one 5-frame synthetic batch, then one
    ``train_step`` on this rank's rows of ``inputs["batch"]`` (the global draws and dropout
    masks given).  Returns the optimizer's gradients (flat), this rank's losses, digests of the
    parameters and BN statistics after the step, the statistics themselves, the report and the
    run's directory."""
    torch.manual_seed(0)
    cfg = get_config(ARGV + ["--output_dir", out_dir])
    trainer = TT.Trainer(cfg, "cpu")
    trainer.init_state(steps_per_epoch=1)
    trainer.model.load_state_dict(inputs["init_sd"])
    out = trainer.evaluate(synthetic_stream(trainer.ctx, cfg, 1, 5, seed=9999,
                                            with_eval_keys=True))
    pkl = trainer.dump_predictions(out["collector_res"])
    batch = inputs["batch"]
    n = len(next(iter(batch.values()))) // mesh.world_size()
    lo = mesh.rank() * n
    local = {k: v[lo:lo + n] for k, v in batch.items()}
    seen = {}
    step = trainer.optimizer.step

    def recording(grads):
        seen["grads"] = torch.cat([g.reshape(-1) for g in grads]).clone()
        return step(grads)

    trainer.optimizer.step = recording
    losses = trainer.train_step(local, draws=inputs["draws"],
                                dropout=DropoutMasks(masks=inputs["masks"],
                                                     rows=mesh.batch_rows(n)))
    stats = TT._split_state(trainer.model)["batch_stats"]
    return {"grads": seen["grads"], "losses": {k: float(v) for k, v in losses.items()},
            "params_digest": _digest(p for p in trainer.optimizer.params),
            "stats_digest": _digest(stats.values()),
            "stats": {k: v.clone() for k, v in stats.items()},
            "report": out["report"], "rows": out["collector_res"], "save_dir": trainer.save_dir,
            "pkl": pkl}


def _refuse_writes_under(root: str):
    """Make every open for writing under ``root`` raise (a rank other than 0 writes nothing)."""
    real = builtins.open

    def guarded(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+") and isinstance(file, (str, os.PathLike)) and \
                os.path.abspath(file).startswith(os.path.abspath(root)):
            raise AssertionError(f"rank {mesh.rank()} wrote {file}")
        return real(file, mode, *args, **kwargs)

    builtins.open = io.open = guarded


def main(workdir: str, port: str, rank: str, world: str):
    torch.set_num_threads(1)
    mesh.init_distributed(torch.device("cpu"), init_method=f"tcp://localhost:{port}",
                          world=int(world), rank_=int(rank))
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out_dir = os.path.join(workdir, "ranks")
    if mesh.rank() != 0:
        _refuse_writes_under(out_dir)
    res = step_and_eval(inputs, out_dir)
    if mesh.rank() != 0:
        res.pop("grads")            # the parent compares rank 0's; the digests cover the rest
    mesh.sync_processes()
    mesh.shutdown()
    torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(*sys.argv[1:])
