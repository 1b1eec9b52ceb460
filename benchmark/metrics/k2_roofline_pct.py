"""k2_roofline_pct: the nearest-vertex kernel's least time over both of a batch's launches
(the object ranker's S candidates and the hand re-rank's topk_hand + 1, ``roofline.k2_least_s``,
FP32 operations) times the pairs in the traced window, over their summed device time, in %."""
from benchmark import roofline
from benchmark.tracing import kernel_seconds


def read(record):
    tr = record.get("trace")
    if tr is None:
        return None
    seconds, launches = kernel_seconds(tr, "min_dist_kernel")
    if not launches or launches % 2:
        return None
    spec = record["spec"]
    B, model = spec.mix["batch_size"], spec.config["model"]
    pair = roofline.k2_least_s(B, model["sample_num"]) \
        + roofline.k2_least_s(B, model["topk_hand"] + 1)
    return 100.0 * pair * (launches // 2) / seconds
