"""Native (C++) host IO hot paths, loaded through ctypes.

``fast_io.cpp`` holds an mmap Matrix Market parser and the stable counting
sort from COO to compressed rows. It is built at first use with the host
C++ compiler (``$CXX``, else ``c++`` or ``g++`` on ``PATH``) into
``gunrock_tpu_torch/_build/``, under a name keyed by a hash of the source,
the flags and the compiler's version, and loaded with ctypes. The library
is an accelerator, not a dependency: ``available()`` is False only when no
compiler is found, and the callers then take their numpy paths. A compiler
that fails, or a library that does not load, raises with the compiler's
output.

``CALLS[name]`` counts the calls that ran the native code (``parse_mtx``,
``coo_to_compressed``), so a run can show which path it took.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fast_io.cpp"
BUILD_DIR = SOURCE.parents[1] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

CALLS: collections.Counter = collections.Counter()

_lib = None
_lock = threading.Lock()


def compiler() -> list[str] | None:
    """The host C++ compiler's command: ``$CXX`` when set, else ``c++`` or
    ``g++`` on ``PATH``; None when there is none."""
    cxx = os.environ.get("CXX")
    if cxx:
        return shlex.split(cxx)
    found = shutil.which("c++") or shutil.which("g++")
    return [found] if found else None


def _run(cmd: list[str]) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as exc:
        raise RuntimeError(f"{' '.join(cmd)}: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout


def library_path(cxx: list[str]) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    digest.update(_run([*cxx, "--version"]).encode())
    return BUILD_DIR / f"libgunrock_io-{digest.hexdigest()[:16]}.so"


def _build(cxx: list[str]) -> Path:
    out = library_path(cxx)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            _run([*cxx, *FLAGS, str(SOURCE), "-o", str(tmp)])
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        finally:
            tmp.unlink(missing_ok=True)
    return out


def get_lib():
    """The loaded native library, built first if needed; None when there is
    no C++ compiler."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cxx = compiler()
        if cxx is None:
            return None
        path = _build(cxx)
        try:
            lib = ctypes.CDLL(str(path), use_errno=True)
        except OSError as exc:
            raise RuntimeError(f"cannot load {path}: {exc}") from exc
        lib.gr_mtx_parse.restype = ctypes.c_void_p
        lib.gr_mtx_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.gr_mtx_copy.argtypes = [ctypes.c_void_p] * 4
        lib.gr_mtx_free.argtypes = [ctypes.c_void_p]
        lib.gr_coo_to_compressed.restype = ctypes.c_int
        lib.gr_coo_to_compressed.argtypes = [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            *[ctypes.c_void_p] * 7,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def parse_mtx(path):
    """Native .mtx parse. Returns (n_rows, n_cols, rows, cols, vals,
    symmetric, pattern), the mirrors of a symmetric matrix's off-diagonal
    entries appended after its entries, or None when there is no compiler.
    Raises ValueError on a malformed file and OSError when the file cannot
    be read."""
    lib = get_lib()
    if lib is None:
        return None
    nr, nc, nnz = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    sym, pat = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(512)
    h = lib.gr_mtx_parse(
        os.fsencode(path), ctypes.byref(nr), ctypes.byref(nc),
        ctypes.byref(nnz), ctypes.byref(sym), ctypes.byref(pat), err, 512,
    )
    if not h:
        code = ctypes.get_errno()  # set only when the file cannot be read
        if code:
            raise OSError(code, os.strerror(code), str(path))
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    try:
        n = nnz.value
        rows = np.empty(n, dtype=np.int32)
        cols = np.empty(n, dtype=np.int32)
        vals = np.empty(n, dtype=np.float32)
        lib.gr_mtx_copy(h, rows.ctypes.data, cols.ctypes.data,
                        vals.ctypes.data)
    finally:
        lib.gr_mtx_free(h)
    CALLS["parse_mtx"] += 1
    return nr.value, nc.value, rows, cols, vals, bool(sym.value), bool(pat.value)


def coo_to_compressed(major, minor, values, n_major: int, n_minor: int):
    """Native stable counting sort by (major, minor), the order of
    ``np.lexsort((minor, major))``. Returns (offsets int64[n_major+1],
    minor_sorted int32, vals_sorted float32, perm int64), or None when there
    is no compiler. Raises ValueError for an index outside [0, n_major) or
    [0, n_minor)."""
    lib = get_lib()
    if lib is None:
        return None
    major = np.ascontiguousarray(major, dtype=np.int32)
    minor = np.ascontiguousarray(minor, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float32)
    nnz = major.shape[0]
    if minor.shape != (nnz,) or values.shape != (nnz,):
        raise ValueError(f"coo_to_compressed: major, minor and values differ "
                         f"in shape: {major.shape}, {minor.shape}, {values.shape}")
    offsets = np.empty(n_major + 1, dtype=np.int64)
    minor_out = np.empty(nnz, dtype=np.int32)
    vals_out = np.empty(nnz, dtype=np.float32)
    perm = np.empty(nnz, dtype=np.int64)
    rc = lib.gr_coo_to_compressed(
        nnz, n_major, n_minor, major.ctypes.data, minor.ctypes.data,
        values.ctypes.data, offsets.ctypes.data, minor_out.ctypes.data,
        vals_out.ctypes.data, perm.ctypes.data,
    )
    if rc == 1:
        raise ValueError(f"coo_to_compressed: an index lies outside "
                         f"[0, {n_major}) x [0, {n_minor})")
    if rc != 0:
        raise MemoryError("coo_to_compressed: out of memory")
    CALLS["coo_to_compressed"] += 1
    return offsets, minor_out, vals_out, perm
