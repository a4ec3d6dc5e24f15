"""Matrix Market (.mtx) loader.

Numpy copy of the pure-Python path of ``gunrock_tpu/io/matrix_market.py``
(the JAX package's native C++ parser is not ported yet): parse the banner,
convert 1-based to 0-based indices, give pattern matrices unit weights,
and duplicate off-diagonal entries of symmetric matrices.
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

from gunrock_tpu_torch.formats import Coo
from gunrock_tpu_torch.graph.properties import GraphProperties


class MatrixMarketError(ValueError):
    pass


def _open(path: Path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def load_matrix_market(path: str | Path):
    """Parse a .mtx file. Returns ``(properties, coo)``."""
    path = Path(path)
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

        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        dims = line.split()
        n_rows, n_cols, nnz = int(dims[0]), int(dims[1]), int(dims[2])
        data = np.loadtxt(f, dtype=np.float64, ndmin=2, max_rows=nnz)

    if data.size == 0:
        rows = np.zeros(0, dtype=np.int32)
        cols = np.zeros(0, dtype=np.int32)
        vals = np.zeros(0, dtype=np.float32)
    else:
        if data.shape[0] != nnz:
            raise MatrixMarketError(
                f"{path}: expected {nnz} entries, found {data.shape[0]}"
            )
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
