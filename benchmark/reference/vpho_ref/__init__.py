"""A frozen, plain-PyTorch copy of the port's predict path, train step and metrics.

It is the benchmark's reference: ``benchmark/run.py`` computes what the timed path should have
produced with it and compares.  The modules are copies of ``vpho_tpu_torch``'s at the commit
that added the benchmark, with the hand-written kernels in their plain forms (``ops/bank_mlp.py``,
``ops/min_dist.py``), one process in place of the data-parallel mesh, and the metrics called
op by op rather than replayed as CUDA graphs.  It imports nothing of ``vpho_tpu_torch`` and
nothing of JAX, so a later change to the port does not move the yardstick.

``set_low_precision(True)`` turns on the control: every operand the bf16 policy rounds to
bfloat16 is rounded to float8 e4m3 (per-tensor scaled) instead, the next precision below.
"""
