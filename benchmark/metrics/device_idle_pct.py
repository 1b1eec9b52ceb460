"""device_idle_pct: 100 x (1 - the union of the device's kernel intervals over the traced
window's length), from ``torch.profiler`` over the traced steady batches or replayed steps."""


def read(record):
    tr = record.get("trace")
    if tr is None or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
