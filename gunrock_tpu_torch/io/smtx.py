""".smtx sparse-matrix loader (numpy copy of ``gunrock_tpu/io/smtx.py``).

Role of reference include/gunrock/io/smtx.hxx:57-200: CSR written as text,
a ``M K NNZ`` header line (optionally comma-separated), then one line of
row offsets and one line of column indices. Values are drawn uniform
random from ``seed``, as the reference synthesizes them; the draw is the
JAX package's, so both give the same values.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from gunrock_tpu_torch.formats import Csr


def load_smtx(path: str | Path, first_line_csv: bool = False,
              seed: int = 0) -> Csr:
    path = Path(path)
    with open(path, "r") as f:
        lines = []
        for raw in f:
            if raw.startswith("%") or not raw.strip():
                continue
            lines.append(raw.strip())
            if len(lines) == 3:
                break
    if len(lines) < 3:
        raise ValueError(f"{path}: truncated .smtx file")

    header = lines[0]
    if first_line_csv or "," in header:
        header = header.replace(",", " ")
    n_rows, n_cols, nnz = (int(x) for x in header.split()[:3])
    row_offsets = np.array(lines[1].split(), dtype=np.int64)
    col_indices = np.array(lines[2].split(), dtype=np.int64)
    if row_offsets.shape[0] != n_rows + 1 or col_indices.shape[0] != nnz:
        raise ValueError(f"{path}: inconsistent .smtx dimensions")

    values = np.random.default_rng(seed).random(nnz, dtype=np.float32)
    return Csr(
        n_rows=n_rows,
        n_cols=n_cols,
        row_offsets=row_offsets.astype(np.int32),
        col_indices=col_indices.astype(np.int32),
        values=values,
    )
