"""Build and bind the hand-written CUDA kernels under ``vpho_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C function and is compiled by ``nvcc`` into
``build/vpho_tpu_torch/lib<name>_<hash>.so`` at the checkout's root, then loaded with
``ctypes``.  The hash covers the source and the flags, so an edited source rebuilds on its next
use.  Nothing is built when the module is imported: the first kernel launch builds what it
needs, and :func:`build_all` builds every source at once, one ``nvcc`` process each.  A build
holds a file lock on the build directory, so data-parallel ranks build each library once and
the others wait for it.  ptxas's
report of each kernel's registers, shared memory and spills is kept beside the library
(``.log``) and read back by :func:`ptxas_report`.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vpho_tpu_torch"
SOURCES = ("bank_mlp", "min_dist", "metric_nn", "bn_act")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME   # CUDA_HOME / CUDA_PATH, PATH, defaults

    if not CUDA_HOME or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


@contextlib.contextmanager
def build_lock(build_dir: Path = BUILD_DIR):
    """An exclusive lock on ``build_dir`` across processes, for as long as the block runs."""
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _start(name: str):
    """Start nvcc for ``name`` if its library is missing; returns (process, tmp, out) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
    out.with_suffix(".log").write_bytes(log)
    os.replace(tmp, out)


def ptxas_report(name: str) -> Dict[str, int]:
    """Registers, shared memory and spill bytes of ``csrc/<name>.cu``'s kernel (its largest
    entry), parsed from the ``-Xptxas -v`` log of its build."""
    log = library_path(name).with_suffix(".log").read_text(errors="replace")
    report = {"registers": 0, "smem_bytes": 0, "spill_bytes": 0}
    for key, pattern in (("registers", r"Used (\d+) registers"),
                         ("smem_bytes", r"(\d+) bytes smem"),
                         ("spill_bytes", r"(\d+) bytes spill (?:stores|loads)")):
        report[key] = max((int(v) for v in re.findall(pattern, log)), default=0)
    return report


def build_all() -> float:
    """Compile every missing kernel library in parallel; returns the wall seconds."""
    t0 = time.perf_counter()
    errors = []
    with build_lock():
        jobs = {name: _start(name) for name in SOURCES}
        for name, job in jobs.items():
            if job is None:
                continue
            try:
                _finish(name, job)
            except RuntimeError as exc:
                errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with build_lock():
            job = _start(name)
            if job is not None:
                _finish(name, job)
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")
