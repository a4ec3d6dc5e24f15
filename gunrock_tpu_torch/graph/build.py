"""Graph construction: host formats -> device-resident multi-view Graph.

Counterpart of ``gunrock_tpu/graph/build.py``: both CSR and CSC views (plus
the expanded COO segment-id arrays) are computed on the host once with
numpy and moved to ``device`` as torch tensors. A build is the span
``graph.build`` (``utils/profiler.py``), with its vertices and slots.
"""

from __future__ import annotations

import numpy as np

from gunrock_tpu_torch.device import DEFAULT, resolve
from gunrock_tpu_torch.formats import Coo, Csc, Csr, coo_to_csr, csr_to_csc
from gunrock_tpu_torch.formats.formats import offsets_to_indices
from gunrock_tpu_torch.graph.graph import Graph
from gunrock_tpu_torch.graph.properties import GraphProperties
from gunrock_tpu_torch.utils.profiler import annotate


def build_graph_from_arrays(
    n_vertices: int,
    row_offsets: np.ndarray,
    col_indices: np.ndarray,
    values: np.ndarray | None = None,
    properties: GraphProperties | None = None,
    device=DEFAULT,
) -> Graph:
    """Build a Graph on ``device`` from raw CSR arrays (sorted or unsorted
    rows)."""
    nnz = int(col_indices.shape[0])
    if values is None:
        values = np.ones(nnz, dtype=np.float32)
    csr = Csr(
        n_rows=n_vertices,
        n_cols=n_vertices,
        row_offsets=np.asarray(row_offsets, dtype=np.int32),
        col_indices=np.asarray(col_indices, dtype=np.int32),
        values=np.asarray(values, dtype=np.float32),
    )
    return build_graph(csr, properties=properties, device=device)


def build_graph(
    fmt: Csr | Coo | Csc,
    properties: GraphProperties | None = None,
    device=DEFAULT,
) -> Graph:
    """Build a Graph on ``device`` from any host format. Rows are re-sorted
    by destination so the CSR view supports binary search."""
    dev = resolve(device)  # fail before any host work when there is no card
    if properties is None:
        properties = GraphProperties()
    with annotate("graph.build") as span:
        graph = _graph_from(fmt, properties, dev)
        span.set(vertices=graph.n_vertices, slots=graph.n_edges)
    return graph


def _graph_from(fmt, properties: GraphProperties, dev) -> Graph:
    """The graph of ``fmt`` on ``dev``: the body of :func:`build_graph`."""
    if isinstance(fmt, Coo):
        csr = coo_to_csr(fmt)
    elif isinstance(fmt, Csc):
        # a CSC of G is the CSR of G^T; rebuild through COO to get G's CSR
        csr = coo_to_csr(Coo(fmt.n_rows, fmt.n_cols, fmt.row_indices,
                             offsets_to_indices(fmt.col_offsets), fmt.values))
    elif isinstance(fmt, Csr):
        csr = coo_to_csr(Coo(fmt.n_rows, fmt.n_cols,
                             offsets_to_indices(fmt.row_offsets),
                             fmt.col_indices, fmt.values))
    else:
        raise TypeError(f"cannot build a graph from {type(fmt)!r}")

    n = max(csr.n_rows, csr.n_cols)
    row_offsets = csr.row_offsets
    if csr.n_rows != n:
        # square up: pad offsets for trailing empty rows
        pad = np.full(n - csr.n_rows, row_offsets[-1], dtype=row_offsets.dtype)
        row_offsets = np.concatenate([row_offsets, pad])
    row_offsets = row_offsets.astype(np.int32)
    col_indices = csr.col_indices.astype(np.int32)
    values = csr.values.astype(np.float32)
    edge_src = offsets_to_indices(row_offsets)

    arrays = {
        "row_offsets": row_offsets,
        "col_indices": col_indices,
        "values": values,
        "edge_src": edge_src,
    }
    if properties.symmetric:
        # the transpose of a symmetric edge set has the same structure, so
        # the CSC view aliases the CSR storage (one device tensor each)
        arrays.update(
            csc_offsets=row_offsets,
            csc_rows=col_indices,
            csc_dst=edge_src,
            csc_values=values,
            csc_edge_perm=np.arange(col_indices.shape[0], dtype=np.int32),
        )
    else:
        csc, perm = csr_to_csc(
            Csr(n, n, row_offsets, col_indices, values)
        )
        arrays.update(
            csc_offsets=csc.col_offsets,
            csc_rows=csc.row_indices,
            csc_dst=offsets_to_indices(csc.col_offsets),
            csc_values=csc.values,
            csc_edge_perm=perm,
        )
    return Graph.from_arrays(arrays, n, properties, dev)
