"""train_step_ms: the mean of ``train_timing()``'s ``step_s`` over the window's steps (CUDA
events around each replayed step), in ms."""
from benchmark.harness import mean_ms


def read(record):
    t = record.get("train")
    return None if t is None else mean_ms(t["step_s"])
