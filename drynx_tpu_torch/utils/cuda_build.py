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
source, for scripts that want the build out of the way up front;
`build_copies` builds edited copies of sources the same way, for scripts
that time versions of a kernel side by side.

A kernel that cannot be built, loaded or launched raises `KernelError`. It
is a fault of the program, never a verdict on the data, so the verifiers'
exception containment lets it through.

Every counted launch records its rows (`launch_rows`, the one reading of a
wrapper's arguments) in the wrapper module's `LAUNCHES` and in
`LAUNCH_ROWS`, unless the launching thread is inside `uncounted`, as the
warm-up registry's launches are (`compilecache.precompile`). A library
that `load` builds or opens is a cold event
(`compilecache.stats.COLD_EVENTS`).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

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
    "g2_ops": {
        "g2_scalar_mul": (3, 1),
        "f2_inv": (2, 1),
    },
    "gt_ops": {
        "f12_mul": (3, 1),
        "f12_mulreduce8": (2, 1),
        "f12_inv": (2, 1),
        "f12_csqr": (2, 1),
        "f12_slotmul": (3, 2),
        "f12_wpow": (3, 3),
        "f12_pow": (3, 2),
    },
    "miller": {
        "miller": (3, 1),
    },
}


class KernelError(RuntimeError):
    """A CUDA kernel of the port failed to build, load or launch."""


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
    raise KernelError("nvcc not found: the CUDA kernels of drynx_tpu_torch "
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


def _start_build(src: Path, out: Path):
    """Start nvcc for one source; returns (Popen, output path, tmp path)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(src)]
    # the callers start nvcc under _LOCK by design: a library is built by
    # one thread, and every other thread that wants it waits for it
    proc = subprocess.Popen(  # drynx: noqa[blocking-call-under-lock]
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish_build(started, what: str) -> str:
    """Wait for nvcc; returns its ptxas report."""
    proc, out, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for {what} "
                          f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def _start_source(name: str):
    """Start building csrc/<name>.cu, or None when it is already built."""
    out = library_path(name)
    return None if out.exists() else _start_build(CSRC / f"{name}.cu", out)


def _finish_source(name: str, started) -> None:
    log = _finish_build(started, f"csrc/{name}.cu")
    _report_path(name).write_text(log)


def build_all() -> dict[str, str]:
    """Build every source in parallel (one nvcc each); returns each
    source's ptxas report."""
    with _LOCK:
        started = {name: _start_source(name) for name in ENTRY_POINTS}
        for name, s in started.items():
            if s is not None:
                _finish_source(name, s)
    return {name: ptxas_report(name) for name in ENTRY_POINTS}


def build_copies(copies) -> list[tuple[ctypes.CDLL, str]]:
    """Build edited copies of sources side by side, one nvcc each, all at
    once. `copies`: (name, text) pairs, text an edited csrc/<name>.cu.
    Returns, for each, its loaded library with the entry points bound as
    `load` binds them, and its ptxas report. For scripts that time
    versions of a kernel in one run; the package loads only csrc/."""
    out_dir = BUILD_DIR / "copies"
    out_dir.mkdir(parents=True, exist_ok=True)
    started = []
    for i, (name, text) in enumerate(copies):
        src = out_dir / f"{i}-{name}.cu"
        src.write_text(text)
        started.append((name, src, _start_build(src, src.with_suffix(".so"))))
    built = []
    for name, src, s in started:
        log = _finish_build(s, src.name)
        built.append((_bind(ctypes.CDLL(str(s[1])), name), log))
    return built


def build(name: str) -> None:
    """Build csrc/<name>.cu with nvcc unless its library is on disk; loads
    nothing (the toolkit is needed, not the card)."""
    with _LOCK:
        started = _start_source(name)
        if started is not None:
            _finish_source(name, started)


def ptxas_report(name: str) -> str:
    path = _report_path(name)
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if need be."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        from ..compilecache.stats import COLD_EVENTS

        COLD_EVENTS.note("library", name)
        started = _start_source(name)
        if started is not None:
            _finish_source(name, started)
        try:
            lib = ctypes.CDLL(str(library_path(name)))
        except OSError as e:
            raise KernelError(f"cannot load csrc/{name}.cu's library: {e}") \
                from e
        lib = _bind(lib, name)
        _LIBS[name] = lib
        return lib


def _bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Declare the C signatures of csrc/<name>.cu's entry points."""
    for fn_name, (n_ptrs, n_ints) in ENTRY_POINTS[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise KernelError(f"CUDA launch of {what} failed: cudaError {rc}")


def check_operands(*named):
    """Every (name, tensor) int32 and on one CPU or CUDA device; returns
    the device."""
    device = named[0][1].device
    for name, t in named:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 limbs, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no route for tensors on {device}")
    return device


def check_shape(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


_FAULTS = (KernelError, MemoryError, torch.cuda.OutOfMemoryError,
           getattr(torch, "AcceleratorError", KernelError))


def is_fault(exc: Exception, device=None) -> bool:
    """Whether an exception raised while decoding or verifying a payload is
    a fault of the program or the card, not of the payload: a kernel that
    failed to build or launch, memory that ran out, or a CUDA error. A
    kernel that faults while it runs surfaces at a later torch call, under
    any name, and leaves its error in the CUDA context, where a
    synchronize raises it again. `device`: the verifier's device, or None
    for the current one when CUDA is in use."""
    if isinstance(exc, _FAULTS) or "CUDA" in str(exc):
        return True
    if device is None and torch.cuda.is_initialized():
        device = torch.device("cuda", torch.cuda.current_device())
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return False


_COUNT_LOCK = threading.Lock()

# Rows of every counted launch, by kernel: {kernel: Counter({rows:
# launches})}, kept for runs that report their launches' shapes; a reduce
# records (R, N), its summands and columns
LAUNCH_ROWS: dict[str, collections.Counter] = collections.defaultdict(
    collections.Counter)


_LOCAL = threading.local()


def launch_rows(kernel: str, args):
    """The rows of a launch of `kernel`, read from its wrapper's positional
    arguments (or its launch inputs, which begin the same way): a reduce's
    (R, N), its summands and columns; the fixed-base ladder's scalars
    (after its table); every other kernel's first argument's rows."""
    if kernel == "point_reduce":
        return (int(args[0].shape[0]), int(args[0].shape[1]))
    return int(args[1 if kernel == "fixed_base_mul" else 0].shape[0])


def count(launches: dict, kernel: str, rows) -> None:
    """Add one launch of `kernel` on `rows` rows (an int, or a shape
    tuple) to a wrapper module's counts and to LAUNCH_ROWS, or to the
    sink of `uncounted` when this thread is inside one; proof threads
    launch beside the main thread, so the adds hold a lock."""
    sink = getattr(_LOCAL, "sink", None)
    with _COUNT_LOCK:
        if sink is not None:
            sink[(kernel, rows)] += 1
            return
        launches[kernel] += 1
        LAUNCH_ROWS[kernel][rows] += 1


@contextlib.contextmanager
def uncounted(sink: collections.Counter):
    """Inside the block, this thread's launches go to `sink`, as
    {(kernel, rows): launches}, and to no wrapper module's LAUNCHES nor to
    LAUNCH_ROWS; other threads count as before."""
    prev = getattr(_LOCAL, "sink", None)
    _LOCAL.sink = sink
    try:
        yield sink
    finally:
        _LOCAL.sink = prev


def counting() -> bool:
    """Whether this thread's launches are counted (not inside
    `uncounted`)."""
    return getattr(_LOCAL, "sink", None) is None


def reset_launch_rows() -> None:
    """Forget the launches' shapes recorded so far."""
    with _COUNT_LOCK:
        LAUNCH_ROWS.clear()


def launch(name: str, entry: str, out, inputs, ints) -> None:
    """Call entry point `entry` of csrc/<name>.cu on the current stream of
    `out`'s device: input pointers, the output pointer, the ints, the
    stream. Inputs are made contiguous (and 16-byte aligned, for the
    kernels' vector loads) and held until the call returns; raises if CUDA
    refused the launch."""
    lib = load(name)
    inputs = [t.contiguous() for t in inputs]
    inputs = [t.clone() if t.data_ptr() % 16 else t for t in inputs]
    # the runtime launches on the current device: make it the tensors' one
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        # the return code is the launch's CUDA status, never the data
        rc = getattr(lib, entry)(  # drynx: declassify[secret]
            *[t.data_ptr() for t in inputs], out.data_ptr(), *ints, stream)
    check(rc, entry)


__all__ = ["KernelError", "LAUNCH_ROWS", "build_all", "build_copies", "load",
           "build", "check", "check_operands", "count", "counting", "launch_rows",
           "uncounted", "reset_launch_rows", "is_fault",
           "check_shape", "launch", "ptxas_report", "library_path",
           "nvcc_path", "BUILD_DIR"]
