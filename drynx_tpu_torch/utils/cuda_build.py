"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes `build/drynx_tpu_torch/lib<name>-<digest>.so`
at the root of the checkout, where the digest covers the source and every
header of `csrc/`, so an edited kernel is rebuilt and an unchanged one is
loaded as it is. The libraries expose plain C functions (no PyTorch
headers), so each builds in seconds. `-Xptxas -v` is always on, and its
report (registers, shared memory, spills per kernel) is kept beside the
library and returned by `ptxas_report`.

Nothing is built at import: the first wrapper that launches a kernel calls
`load`, and `build_all` compiles every source at once, one nvcc process per
source, for scripts that want the build out of the way up front.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "drynx_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C entry points of each source: name -> (pointer arguments, int arguments);
# every entry point takes its pointers, then its ints, then the stream.
ENTRY_POINTS = {
    "g1_ops": {
        "g1_fixed_base_mul": (3, 2),
        "g1_scalar_mul": (3, 2),
        "g1_point_reduce": (2, 2),
        "g1_point_add": (3, 1),
    },
    "fp_inv": {
        "fp_inv": (2, 1),
    },
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of drynx_tpu_torch "
                       "build only where the CUDA toolkit is installed")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _report_path(name: str) -> Path:
    return library_path(name).with_suffix(".ptxas.txt")


def _start_build(name: str):
    """Start nvcc for one source; returns (Popen, output path, tmp path)
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish_build(name: str, started) -> None:
    proc, out, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    _report_path(name).write_text(log)
    os.replace(tmp, out)


def build_all() -> dict[str, str]:
    """Build every source in parallel (one nvcc each); returns each
    source's ptxas report."""
    with _LOCK:
        started = {name: _start_build(name) for name in ENTRY_POINTS}
        for name, s in started.items():
            if s is not None:
                _finish_build(name, s)
    return {name: ptxas_report(name) for name in ENTRY_POINTS}


def ptxas_report(name: str) -> str:
    path = _report_path(name)
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if need be."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        started = _start_build(name)
        if started is not None:
            _finish_build(name, started)
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name, (n_ptrs, n_ints) in ENTRY_POINTS[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {rc}")


__all__ = ["build_all", "load", "check", "ptxas_report", "library_path",
           "nvcc_path", "BUILD_DIR"]
