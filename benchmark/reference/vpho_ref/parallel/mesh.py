"""One process: the reference runs on one device, without a process group."""


def is_distributed() -> bool:
    return False
