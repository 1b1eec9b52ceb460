"""trunk_ms: the mean of ``evaluate``'s ``trunk_s`` over the window's batches after batch 0, in
ms: the predict graph's span from its ``start`` mark to its ``trunk`` mark (ResNet-50 FPN x2,
the heads and the regression's MANO FK).  A program without the key reads nothing."""
from benchmark.harness import mean_ms


def read(record):
    t = record.get("timing")
    return None if t is None or "trunk_s" not in t else mean_ms(t["trunk_s"][1:])
