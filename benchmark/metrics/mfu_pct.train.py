"""mfu_pct.train: the configuration's train-step FLOPs a frame (forward and backward, counted
once by ``benchmark/count_flops.py`` on the reference) times the window's frames over its
seconds, against the TF32 peak (the configuration file says why), in %."""
from benchmark import roofline


def read(record):
    flops = record["spec"].config.get("flops", {}).get("train_per_frame")
    t = record.get("train")
    if not flops or t is None or not t["seconds"]:
        return None
    frames = record["spec"].mix["batch_size"] * t["steps"]
    return 100.0 * flops * frames / t["seconds"] / roofline.PEAK_TF32_FLOPS
