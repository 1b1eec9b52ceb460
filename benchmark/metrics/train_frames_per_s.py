"""train_frames_per_s: the batch size times the steps of the window's ``train_one_epoch`` call
over that call's seconds (``last_train``: from its start to a synchronise after its last
step).  Host clock."""


def read(record):
    t = record.get("train")
    if t is None or not t["seconds"]:
        return None
    return record["spec"].mix["batch_size"] * t["steps"] / t["seconds"]
