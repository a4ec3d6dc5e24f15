"""In-tree sample graphs for tests and smoke runs (port of
``gunrock_tpu/io/sample.py``).

``csr()`` is the reference's hard-coded 4x4 sample matrix (reference
``io/sample.hxx:22-94``):

    r/c  0 1 2 3
    0 [ 0 0 0 0 ]
    1 [ 5 8 0 0 ]
    2 [ 0 0 3 0 ]
    3 [ 0 6 0 0 ]

``small_connected_graph()`` is a 7-vertex directed weighted graph with
known structure, for exact expected outputs.
"""

from __future__ import annotations

import numpy as np

from gunrock_tpu_torch.device import DEFAULT
from gunrock_tpu_torch.formats import Coo, Csr
from gunrock_tpu_torch.graph import Graph, GraphProperties, build_graph


def csr() -> Csr:
    """The reference 4x4 sample CSR (sample.hxx:22-94)."""
    return Csr(
        n_rows=4,
        n_cols=4,
        row_offsets=np.asarray([0, 0, 2, 3, 4], dtype=np.int32),
        col_indices=np.asarray([0, 1, 2, 1], dtype=np.int32),
        values=np.asarray([5.0, 8.0, 3.0, 6.0], dtype=np.float32),
    )


def graph(device=DEFAULT) -> Graph:
    return build_graph(csr(), GraphProperties(directed=True, weighted=True),
                       device=device)


def small_connected_graph(weighted: bool = True, device=DEFAULT) -> Graph:
    """A 7-vertex directed weighted graph (the style of reference
    ``unittests/algorithms/tc.cuh:20-61``)."""
    edges = [
        (0, 1, 2.0),
        (0, 2, 4.0),
        (1, 2, 1.0),
        (1, 3, 7.0),
        (2, 4, 3.0),
        (3, 5, 1.0),
        (4, 3, 2.0),
        (4, 5, 5.0),
        (5, 6, 1.0),
        (6, 0, 9.0),
    ]
    src = np.asarray([e[0] for e in edges], dtype=np.int32)
    dst = np.asarray([e[1] for e in edges], dtype=np.int32)
    w = np.asarray([e[2] for e in edges], dtype=np.float32)
    coo = Coo(n_rows=7, n_cols=7, row_indices=src, col_indices=dst, values=w)
    return build_graph(
        coo, GraphProperties(directed=True, weighted=weighted, symmetric=False),
        device=device)
