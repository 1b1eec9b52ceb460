"""ode_ms: the mean of ``evaluate``'s ``ode_s`` over the window's batches after batch 0, in ms:
the predict graph's span from its ``trunk`` mark to its ``ode`` mark (the ODE over the S
hypotheses a frame, with the bank-MLP kernel, and their MANO FK).  A program without the key
reads nothing."""
from benchmark.harness import mean_ms


def read(record):
    t = record.get("timing")
    return None if t is None or "ode_s" not in t else mean_ms(t["ode_s"][1:])
