"""Build the CUDA kernel libraries at first use and load them with ctypes.

Each ``lshm_tpu_torch/csrc/<name>.cu`` is compiled by its own ``nvcc`` process into
``lshm_tpu_torch/_build/lib<name>-<digest>.so`` (all started together, so the build
takes as long as the slowest source), for ``sm_90a``, with a plain C interface: no
PyTorch headers, so a source builds in seconds.  The digest covers the sources and
the flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the first kernel call triggers the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("khm", "conv_head")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all() -> dict[str, float]:
    """Compile every source whose library is missing, one nvcc each, in parallel.
    Returns {name: seconds} for the sources it compiled."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    times, errors = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(name))   # atomic: a half-written .so is never loaded
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>`` (built first if needed)."""
    with _lock:
        if name not in _libs:
            build_all()
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
