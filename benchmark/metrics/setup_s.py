"""setup_s: seconds from the process's start to the window's start (imports, the CUDA context,
the program's trainer and model, the seed's weights and pool, and the warm-up: an eval cell's
batch 0 with its captures, the training cell's checked steps with theirs).  Host clock."""


def read(record):
    return record["setup_s"]
