"""k4_roofline_pct: the trunk's fused batch norm's least time over one predict replay's sites
(``roofline_k4.k4_least_s`` at the cell's batch, dtype and patch, bytes over the memory rate)
times the replays in the traced window, over the kernel's summed device time by name, in %.
Nothing to read where no kernel of that name ran (a program without K4)."""
from benchmark import roofline_k4
from benchmark.tracing import kernel_seconds


def read(record):
    tr = record.get("trace")
    if tr is None:
        return None
    seconds, launches = kernel_seconds(tr, "bn_act_kernel")
    model = record["spec"].config["model"]
    per_replay = len(roofline_k4.k4_sites(model["patch_size"], model["roi_size"]))
    if not launches or launches % per_replay:
        return None
    least = roofline_k4.k4_least_s(record["spec"].mix["batch_size"], model["compute_dtype"],
                                   model["patch_size"], model["roi_size"])
    return 100.0 * least * (launches // per_replay) / seconds
