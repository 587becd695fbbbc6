"""ctypes binding of the port's native host decoder, ``patchio.cpp``: the JAX package's
source, so that both compute the same floats.  One pass over the host's cores (OpenMP)
takes int8 visibilities times their per-(freq, pol) scales through channel selection,
zero padding, 50 %-stride patches (baseline-major) and the clamp, and sums what a
global z-normalisation needs.

The library is built at first use with the host's C++ compiler (``$CXX``, else
``g++``) and the JAX package's flags, ``-fopenmp`` and ``-march=native`` where the
compiler takes them, into ``lshm_tpu_torch/_build/libpatchio-<digest>.so``.  A
compiler without OpenMP (one whose installation lacks libgomp) builds the same source
serially: its loops are guarded by ``_OPENMP``, and ``build_info()`` says which build
was made.  The digest covers the source, the compiler, the flags and the target that
``-march=native`` names, so an edit or another host rebuilds; the output is written
through a temporary file and renamed, so processes that build at once never load a
half-written library.

``available()`` is False only where there is no compiler.  A compiler that fails, or a
library that does not load, raises with the compiler's output: a broken build never
hides behind the numpy path.  Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from lshm_tpu_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "patchio.cpp"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_libs: dict[str, tuple[ctypes.CDLL, list[str], Path]] = {}   # by compiler


def compiler() -> str | None:
    """The host's C++ compiler, ``$CXX`` or else ``g++``, as a path; None if it is not
    on the path."""
    return shutil.which(os.environ.get("CXX") or "g++")


def _links_openmp(cxx: str) -> bool:
    """Whether ``cxx`` builds a shared library with ``-fopenmp`` (its installation has
    the OpenMP runtime)."""
    out = _build.BUILD_DIR / f"openmp-probe.{os.getpid()}.so"
    try:
        probe = subprocess.run([cxx, "-fopenmp", "-shared", "-fPIC", "-x", "c++", "-",
                                "-o", str(out)], input="int lshm_probe() { return 0; }\n",
                               capture_output=True, text=True)
        return probe.returncode == 0
    finally:
        out.unlink(missing_ok=True)


def _flags(cxx: str) -> tuple[list[str], str]:
    """The build's flags, and the compiler's account of what ``-march=native`` means on
    this host (empty where it refuses the flag, which is then left out, as the JAX
    package's Makefile leaves it out)."""
    flags = [*FLAGS, *(["-fopenmp"] if _links_openmp(cxx) else [])]
    probe = subprocess.run([cxx, "-march=native", "-###", "-E", "-x", "c++", os.devnull],
                           capture_output=True, text=True)
    if probe.returncode != 0:
        return flags, ""
    return [*flags, "-march=native"], probe.stderr


def _declare(lib: ctypes.CDLL, openmp: bool) -> ctypes.CDLL:
    lib.decode_patchify.restype = ctypes.c_int
    lib.decode_patchify.argtypes = [
        ctypes.POINTER(ctypes.c_int8),                           # vis
        ctypes.POINTER(ctypes.c_float),                          # scales
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nb, ntime, nfreq, npol
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,              # pols, npols_sel
        ctypes.c_int, ctypes.c_float,                            # patch, clamp
        ctypes.POINTER(ctypes.c_float),                          # out
        ctypes.POINTER(ctypes.c_double),                         # stats[2]
    ]
    lib.normalize_inplace.restype = None
    lib.normalize_inplace.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                                      ctypes.c_double, ctypes.c_double]
    if openmp:
        lib.omp_get_max_threads.restype = ctypes.c_int  # the OpenMP runtime's it links
        lib.omp_get_max_threads.argtypes = []
    return lib


def _load() -> tuple[ctypes.CDLL, list[str], Path]:
    """(library, flags, path) of the decoder, built first if needed.  Raises
    RuntimeError without a compiler, or with the compiler's output when the build or
    the load fails."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("the native decoder needs a C++ compiler ($CXX or g++ on the "
                           "path); use_native=False decodes in numpy")
    with _lock:
        if cxx not in _libs:
            _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            flags, target_desc = _flags(cxx)
            desc = _build.digest([cxx, *flags, target_desc], [SOURCE])
            target = _build.BUILD_DIR / f"libpatchio-{desc}.so"
            if not target.exists():
                tmp, proc = _build.start_build([cxx, *flags, str(SOURCE)], target)
                out = _build.finish_build(tmp, proc, target)
                if out is not None:
                    raise RuntimeError(f"building the native decoder failed "
                                       f"({cxx} {' '.join(flags)}):\n{out}")
            try:
                lib = _declare(ctypes.CDLL(str(target)), "-fopenmp" in flags)
            except (OSError, AttributeError) as e:
                raise RuntimeError(f"the native decoder {target} does not load: {e}") from e
            _libs[cxx] = (lib, flags, target)
        return _libs[cxx]


def library() -> ctypes.CDLL:
    """The loaded decoder, built first if needed (see ``_load``)."""
    return _load()[0]


def build_info() -> dict:
    """The loaded decoder's compiler, flags, file and OpenMP threads (1 without
    OpenMP)."""
    lib, flags, path = _load()
    return {"compiler": compiler(), "flags": flags, "library": path.name,
            "openmp": "-fopenmp" in flags,
            "omp_threads": lib.omp_get_max_threads() if "-fopenmp" in flags else 1}


def available() -> bool:
    """Whether the native decoder can be built here: a C++ compiler is on the path."""
    return compiler() is not None


def decode_patchify(
    vis: np.ndarray,          # [nb, ntime, nfreq, npol, 2] int8
    scales: np.ndarray,       # [nb, nfreq, npol] float32
    pols: tuple[int, ...],
    patch: int,
    clamp: float,
    normalize: bool = True,
) -> tuple[np.ndarray, tuple[int, int]]:
    """Decode, pad, patchify and clamp in one pass, then z-normalise over all the
    patches when ``normalize``: ([nb * px * py, patch, patch, 2 * len(pols)] float32,
    (px, py)).  Channels 2i / 2i+1 are re / im of ``pols[i]``."""
    lib = library()
    vis = np.ascontiguousarray(vis, np.int8)
    scales = np.ascontiguousarray(scales, np.float32)
    if vis.ndim != 5 or vis.shape[-1] != 2:
        raise ValueError(f"vis must be [nb, ntime, nfreq, npol, 2], got {vis.shape}")
    nb, ntime, nfreq, npol, _ = vis.shape
    if scales.shape != (nb, nfreq, npol):
        raise ValueError(f"scales must be {(nb, nfreq, npol)}, got {scales.shape}")
    if not pols or min(pols) < 0 or max(pols) >= npol:
        raise ValueError(f"pols {pols} out of range for npol = {npol}")
    stride = patch // 2
    px = (max(ntime, patch) - patch) // stride + 1
    py = (max(nfreq, patch) - patch) // stride + 1
    out = np.empty((nb * px * py, patch, patch, 2 * len(pols)), np.float32)
    stats = np.zeros(2, np.float64)
    pols_arr = np.asarray(pols, np.int32)
    rc = lib.decode_patchify(
        vis.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nb, ntime, nfreq, npol,
        pols_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(pols),
        patch, ctypes.c_float(clamp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise ValueError(f"decode_patchify rejected nb={nb}, patch={patch}, pols={pols}")
    if normalize:
        lib.normalize_inplace(out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              ctypes.c_long(out.size), ctypes.c_double(float(stats[0])),
                              ctypes.c_double(float(stats[1])))
    return out, (px, py)
