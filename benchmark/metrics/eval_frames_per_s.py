"""eval_frames_per_s: every frame of the window's batches over the window's time, the sum of
``evaluate``'s contiguous per-batch host intervals after batch 0 (stalls included).  Host clock."""


def read(record):
    if "frames" not in record or not record["window_s"]:
        return None
    return record["frames"] / record["window_s"]
