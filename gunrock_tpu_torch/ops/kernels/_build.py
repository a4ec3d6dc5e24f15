"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. A build
happens at first use and is keyed by a hash of the sources and flags, so a
fresh checkout builds everything on its first run and later runs load the
cached libraries from ``_build/`` (listed in ``.gitignore``). ``build()``
starts one ``nvcc`` per missing library, all at once.

Every wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel,
so a run can show that it went through the kernels.

The checked build (``use_checked(True)``, ``build(checked=True)``) compiles
the same sources with ``-DGR_CHECKED`` into libraries of their own names, so
both builds cache side by side. In it every index a kernel computes is
range-checked before use (``GR_IN_RANGE`` in ``csrc/common.cuh``); a bad
index is recorded instead of dereferenced, each launch synchronises, and
``check`` raises with the source line, the index and its limit. It stands
in for a memory checker and is for fault finding only.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("chunkplan", "semiring", "spmm", "bfs_push", "hits_fused",
           "sssp_push", "mst_min", "geo_step", "banded", "probes")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

CHECKED_FLAG = "-DGR_CHECKED"
RANGE_FAULT = 10001  # gr::kRangeFault: what a checked launch returns

LAUNCHES: collections.Counter = collections.Counter()

_libs: dict[tuple[str, bool], ctypes.CDLL] = {}
_lock = threading.Lock()
_checked = False


def use_checked(on: bool) -> None:
    """Make ``load`` hand out the checked (range-checking) libraries."""
    global _checked
    _checked = bool(on)


def reset_launches() -> None:
    LAUNCHES.clear()


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str, checked: bool = False) -> Path:
    digest = hashlib.sha256()
    for src in (CSRC / "common.cuh", CSRC / f"{name}.cu"):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = "-checked" if checked else ""
    return BUILD_DIR / f"lib{name}{tag}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES, checked: bool = False) -> float:
    """Compile every library of ``names`` that is not built yet (the
    range-checking variants when ``checked``), with one ``nvcc`` process
    each, all started together. Returns the seconds spent; raises
    RuntimeError with the compiler's output if a build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = (CHECKED_FLAG,) if checked else ()
    procs = []
    for name in names:
        out = library_path(name, checked)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, out, tmp, proc))
    failures = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise RuntimeError("\n".join(failures))
    return time.perf_counter() - t0


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library ``name`` (its checked variant after
    ``use_checked(True)``), built first if needed. ``signatures`` maps each
    exported function to its ctypes argtypes; every function returns a
    cudaError_t as int."""
    key = (name, _checked)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build((name,), checked=_checked)
            lib = ctypes.CDLL(str(library_path(name, _checked)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            if _checked:
                lib.gr_last_fault.argtypes = [ctypes.c_void_p]
                lib.gr_last_fault.restype = ctypes.c_int
            _libs[key] = lib
        return lib


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what the kernels take."""
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or t.device != device or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {dtype}{tuple(shape)} tensor on "
            f"{device}, got {t.dtype}{tuple(t.shape)} on {t.device}"
        )


def check(err: int, what: str) -> None:
    if err == RANGE_FAULT:
        # the checked library that met the fault holds its three words
        faults = []
        for (name, checked), lib in _libs.items():
            words = (ctypes.c_longlong * 3)()
            if checked and lib.gr_last_fault(words) == 0 and words[0]:
                faults.append(f"{name}.cu or common.cuh line {words[0]}: "
                              f"index {words[1]} outside [0, {words[2]})")
        raise RuntimeError(f"{what}: range check failed: {'; '.join(faults)}")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> int | None:
    """Device pointer of a tensor (None for a missing optional input)."""
    return None if t is None else t.data_ptr()


def stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device) -> int:
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count
