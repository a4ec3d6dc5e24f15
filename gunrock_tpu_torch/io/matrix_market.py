"""Matrix Market (.mtx) loader.

Copy of ``gunrock_tpu/io/matrix_market.py``: parse the banner, convert
1-based to 0-based indices, give pattern matrices unit weights, and
duplicate off-diagonal entries of symmetric matrices, appending the
mirrors after the entries. A plain file goes through the native parser
(``gunrock_tpu_torch/_native``) when a C++ compiler builds it; a ``.gz``
file, or any file without a compiler, through numpy. Both paths return the
same properties and COO arrays, bit for bit, on every file either accepts,
and both raise ``MatrixMarketError`` on a malformed one.
"""

from __future__ import annotations

import gzip
import warnings
from pathlib import Path

import numpy as np

from gunrock_tpu_torch.formats import Coo
from gunrock_tpu_torch.graph.properties import GraphProperties


class MatrixMarketError(ValueError):
    pass


def _load_native(path):
    """Parse through the native library; None when there is no compiler
    to build it."""
    from gunrock_tpu_torch import _native

    try:
        parsed = _native.parse_mtx(path)
    except ValueError as e:
        raise MatrixMarketError(str(e)) from e
    if parsed is None:
        return None
    n_rows, n_cols, rows, cols, vals, symmetric, pattern = parsed
    properties = GraphProperties(
        directed=not symmetric,
        weighted=not pattern,
        symmetric=symmetric,
    )
    return properties, Coo(n_rows, n_cols, rows, cols, vals)


def _open(path: Path):
    # latin-1 decodes every byte, as the native parser reads them
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt", encoding="latin-1")
    return open(path, "r", encoding="latin-1")


def _size_line(path: Path, line: str) -> tuple[int, int, int]:
    dims = line.split()
    if len(dims) != 3 or not all(d.isascii() and d.isdigit() for d in dims):
        raise MatrixMarketError(
            f"{path}: the size line must hold three non-negative integers, "
            f"got {line!r}")
    sizes = tuple(int(d) for d in dims)
    if max(sizes) > np.iinfo(np.int64).max:
        raise MatrixMarketError(f"{path}: a size above 2^63 - 1")
    return sizes


def load_matrix_market(path: str | Path):
    """Parse a .mtx file. Returns ``(properties, coo)``."""
    path = Path(path)
    if not str(path).endswith(".gz"):
        native = _load_native(path)
        if native is not None:
            return native
    with _open(path) as f:
        banner = f.readline()
        if not banner.startswith("%%MatrixMarket"):
            raise MatrixMarketError(f"{path}: missing MatrixMarket banner")
        parts = banner.strip().split()
        if len(parts) < 5 or parts[1].lower() != "matrix":
            raise MatrixMarketError(f"{path}: unsupported banner: {banner!r}")
        storage = parts[2].lower()  # coordinate | array
        field = parts[3].lower()  # real | integer | pattern | complex
        symmetry = parts[4].lower()  # general | symmetric | skew-symmetric | hermitian
        if storage != "coordinate":
            raise MatrixMarketError(
                f"{path}: only coordinate (sparse) matrices are supported"
            )
        if field == "complex":
            raise MatrixMarketError(f"{path}: complex matrices not supported")
        if field not in ("real", "integer", "pattern"):
            raise MatrixMarketError(f"{path}: unsupported field {field!r}")
        if symmetry not in ("general", "symmetric", "skew-symmetric",
                            "hermitian"):
            raise MatrixMarketError(f"{path}: unsupported symmetry {symmetry!r}")

        # comments and blank lines (as scipy skips them), then the size line
        line = f.readline()
        while line.startswith("%") or (line and not line.strip()):
            line = f.readline()
        n_rows, n_cols, nnz = _size_line(path, line)
        try:
            with warnings.catch_warnings():  # the count is checked below
                warnings.simplefilter("ignore", UserWarning)
                data = np.loadtxt(f, dtype=np.float64, ndmin=2, max_rows=nnz)
        except ValueError as e:
            raise MatrixMarketError(f"{path}: {e}") from e

    if data.shape[0] != nnz:
        raise MatrixMarketError(
            f"{path}: expected {nnz} entries, found {data.shape[0]}"
        )
    if nnz == 0:
        rows = np.zeros(0, dtype=np.int32)
        cols = np.zeros(0, dtype=np.int32)
        vals = np.zeros(0, dtype=np.float32)
    else:
        if data.shape[1] < 2:
            raise MatrixMarketError(f"{path}: an entry needs a row and a column")
        index = data[:, :2]
        if not (np.isfinite(index).all() and (np.abs(index) < 2.0**63).all()):
            raise MatrixMarketError(
                f"{path}: an index must be a finite number below 2^63")
        rows = (data[:, 0].astype(np.int64) - 1).astype(np.int32)
        cols = (data[:, 1].astype(np.int64) - 1).astype(np.int32)
        if field == "pattern" or data.shape[1] < 3:
            vals = np.ones(nnz, dtype=np.float32)
        else:
            vals = data[:, 2].astype(np.float32)

    # skew-symmetric is treated as general/directed, with no mirroring
    properties = GraphProperties(
        directed=(symmetry in ("general", "skew-symmetric")),
        weighted=(field != "pattern"),
        symmetric=(symmetry in ("symmetric", "hermitian")),
    )
    if properties.symmetric and rows.size:
        off_diag = rows != cols
        rows, cols, vals = (
            np.concatenate([rows, cols[off_diag]]),
            np.concatenate([cols, rows[off_diag]]),
            np.concatenate([vals, vals[off_diag]]),
        )
    return properties, Coo(n_rows, n_cols, rows, cols, vals)
