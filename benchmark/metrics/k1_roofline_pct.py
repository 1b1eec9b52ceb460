"""k1_roofline_pct: the bank-MLP kernel's least time (``roofline.k1_least_s`` at the cell's B x
S rows, bf16 operations) times its launches in the traced window, over their summed device time
by kernel name, in %."""
from benchmark import roofline
from benchmark.tracing import kernel_seconds


def read(record):
    tr = record.get("trace")
    if tr is None:
        return None
    seconds, launches = kernel_seconds(tr, "bank_mlp_kernel")
    if not launches:
        return None
    spec = record["spec"]
    least = roofline.k1_least_s(spec.mix["batch_size"], spec.config["model"]["sample_num"])
    return 100.0 * least * launches / seconds
