"""Host-side sparse-matrix format containers and conversions.

Numpy copy of ``gunrock_tpu/formats/formats.py``: ``Coo``/``Csr``/``Csc``
containers, counting-sort conversions that keep every row segment sorted
by the minor index, and the binary CSR cache. From
``NATIVE_SORT_MIN_EDGES`` edges up the sort is the native counting sort
(``gunrock_tpu_torch/_native``) when a C++ compiler builds it, below that
or without one ``np.lexsort``: the same order either way (rows sorted by
(major, minor), stable for duplicates), and the same arrays bit for bit.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from gunrock_tpu_torch import _native

_BINARY_MAGIC = b"GTPUCSR1"  # same cache format as the JAX package


@dataclasses.dataclass
class Coo:
    """Coordinate format: parallel (row, col, val) arrays."""

    n_rows: int
    n_cols: int
    row_indices: np.ndarray  # int32[nnz]
    col_indices: np.ndarray  # int32[nnz]
    values: np.ndarray  # float32[nnz]

    @property
    def nnz(self) -> int:
        return int(self.row_indices.shape[0])


@dataclasses.dataclass
class Csr:
    """Compressed sparse row: offsets + column indices + values."""

    n_rows: int
    n_cols: int
    row_offsets: np.ndarray  # int32[n_rows+1]
    col_indices: np.ndarray  # int32[nnz]
    values: np.ndarray  # float32[nnz]

    @property
    def nnz(self) -> int:
        return int(self.col_indices.shape[0])

    def write_binary(self, path: str | Path) -> None:
        with open(Path(path), "wb") as f:
            f.write(_BINARY_MAGIC)
            np.asarray([self.n_rows, self.n_cols, self.nnz], np.int64).tofile(f)
            self.row_offsets.astype(np.int64).tofile(f)
            self.col_indices.astype(np.int32).tofile(f)
            self.values.astype(np.float32).tofile(f)

    @staticmethod
    def read_binary(path: str | Path) -> "Csr":
        path = Path(path)
        with open(path, "rb") as f:
            if f.read(len(_BINARY_MAGIC)) != _BINARY_MAGIC:
                raise ValueError(f"{path}: not a gunrock_tpu binary CSR file")
            n_rows, n_cols, nnz = np.fromfile(f, dtype=np.int64, count=3)
            row_offsets = np.fromfile(f, dtype=np.int64, count=int(n_rows) + 1)
            col_indices = np.fromfile(f, dtype=np.int32, count=int(nnz))
            values = np.fromfile(f, dtype=np.float32, count=int(nnz))
        return Csr(int(n_rows), int(n_cols), row_offsets.astype(np.int32),
                   col_indices, values)


@dataclasses.dataclass
class Csc:
    """Compressed sparse column: offsets + row indices + values."""

    n_rows: int
    n_cols: int
    col_offsets: np.ndarray  # int32[n_cols+1]
    row_indices: np.ndarray  # int32[nnz]
    values: np.ndarray  # float32[nnz]

    @property
    def nnz(self) -> int:
        return int(self.row_indices.shape[0])


NATIVE_SORT_MIN_EDGES = 1 << 16
_INT32_MAX = np.iinfo(np.int32).max


def _native_sort(major, minor, values, n_major: int):
    """The native counting sort's result in the numpy path's dtypes; None
    without a compiler or where an index lies outside what it sorts (the
    numpy path then gives its own result or error)."""
    if not major.size:
        return None
    n_minor = int(minor.max()) + 1
    if not (0 <= int(major.min()) and int(major.max()) < n_major <= _INT32_MAX
            and 0 <= int(minor.min()) and n_minor <= _INT32_MAX):
        return None
    out = _native.coo_to_compressed(major, minor, values, n_major, n_minor)
    if out is None:
        return None
    offsets, minor_out, vals_out, perm = out
    if values.dtype != np.float32:
        vals_out = values[perm]
    dtype = np.int32 if offsets[-1] <= _INT32_MAX else np.int64
    return offsets.astype(dtype), minor_out, vals_out, perm


def _counting_sort_to_compressed(major, minor, values, n_major: int):
    """Sort edges by (major, minor) and build offsets.

    Returns (offsets int32[n_major+1], minor_sorted, values_sorted, perm)
    where ``perm`` maps sorted position -> original edge index."""
    if major.shape[0] >= NATIVE_SORT_MIN_EDGES:
        out = _native_sort(major, minor, values, n_major)
        if out is not None:
            return out
    perm = np.lexsort((minor, major))  # stable; last key is primary
    counts = np.bincount(major[perm], minlength=n_major)
    offsets = np.concatenate(
        [np.zeros(1, dtype=np.int64), np.cumsum(counts, dtype=np.int64)]
    )
    dtype = np.int32 if offsets[-1] <= np.iinfo(np.int32).max else np.int64
    return (
        offsets.astype(dtype),
        minor[perm].astype(np.int32),
        values[perm],
        perm.astype(np.int64),
    )


def coo_to_csr(coo: Coo) -> Csr:
    """COO -> CSR with rows sorted by column."""
    offsets, cols, vals, _ = _counting_sort_to_compressed(
        coo.row_indices, coo.col_indices, coo.values, coo.n_rows
    )
    return Csr(coo.n_rows, coo.n_cols, offsets.astype(np.int32), cols, vals)


def offsets_to_indices(offsets: np.ndarray) -> np.ndarray:
    """Expand offsets into per-entry segment ids: ``[0,2,5] -> [0,0,1,1,1]``."""
    nnz = int(offsets[-1])
    n = offsets.shape[0] - 1
    return np.repeat(
        np.arange(n, dtype=np.int32), np.diff(offsets).astype(np.int64)
    )[:nnz]


def coo_to_csc(coo: Coo) -> Csc:
    """COO -> CSC with columns sorted by row."""
    offsets, rows, vals, _ = _counting_sort_to_compressed(
        coo.col_indices, coo.row_indices, coo.values, coo.n_cols
    )
    return Csc(coo.n_rows, coo.n_cols, offsets.astype(np.int32), rows, vals)


def indices_to_offsets(indices: np.ndarray, n_segments: int) -> np.ndarray:
    """Sorted segment ids -> offsets: ``[0,0,1,1,1] -> [0,2,5]``."""
    counts = np.bincount(indices, minlength=n_segments)
    return np.concatenate(
        [np.zeros(1, dtype=np.int64), np.cumsum(counts)]
    ).astype(np.int32)


def csr_to_coo(csr: Csr) -> Coo:
    return Coo(
        n_rows=csr.n_rows,
        n_cols=csr.n_cols,
        row_indices=offsets_to_indices(csr.row_offsets),
        col_indices=csr.col_indices,
        values=csr.values,
    )


def csr_to_csc(csr: Csr):
    """CSR -> CSC. Returns (csc, edge_perm) where ``edge_perm[k]`` is the CSR
    edge index stored at CSC position ``k``."""
    rows = offsets_to_indices(csr.row_offsets)
    offsets, row_idx, vals, perm = _counting_sort_to_compressed(
        csr.col_indices, rows, csr.values, csr.n_cols
    )
    csc = Csc(csr.n_rows, csr.n_cols, offsets.astype(np.int32), row_idx, vals)
    return csc, perm.astype(np.int32)
