"""k3_roofline_pct: the metrics' nearest-point kernel's least time over an eval batch's 4
launches (two object testers, each the full mesh and the sampled points,
``roofline_k3.k3_least_s``, FP32 operations) times the batches in the traced window, over the
kernel's summed device time by name, in %."""
from benchmark import roofline_k3
from benchmark.tracing import kernel_seconds


def read(record):
    tr = record.get("trace")
    if tr is None:
        return None
    seconds, launches = kernel_seconds(tr, "metric_nn_kernel")
    if not launches or launches % 4:
        return None
    least = roofline_k3.k3_least_s(record["spec"].mix["batch_size"])
    return 100.0 * least * (launches // 4) / seconds
