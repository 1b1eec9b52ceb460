"""mfu_pct.eval: the configuration's predict FLOPs a frame (counted once by
``benchmark/count_flops.py`` on the reference, the kernels by ``roofline``'s formulas) times
the window's frames over its seconds, against the bf16 peak, in %."""
from benchmark import roofline


def read(record):
    flops = record["spec"].config.get("flops", {}).get("predict_per_frame")
    if not flops or not record.get("window_s"):
        return None
    return 100.0 * flops * record["frames"] / record["window_s"] / roofline.PEAK_BF16_FLOPS
