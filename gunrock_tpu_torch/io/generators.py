"""Synthetic graph generators (numpy copy of part of
``gunrock_tpu/io/generators.py``).

``rmat_coo``/``rmat_graph`` and ``grid2d_coo``/``grid2d_graph`` draw the
same numbers in the same order as the JAX package, so a seed gives a
bit-identical graph in both packages.
"""

from __future__ import annotations

import numpy as np

from gunrock_tpu_torch.device import DEFAULT, resolve
from gunrock_tpu_torch.formats import Coo, coo_to_csr
from gunrock_tpu_torch.graph import Graph, build_graph
from gunrock_tpu_torch.graph.properties import GraphProperties


def _dedup_coo(rows, cols, n, remove_self_loops=True):
    """Sort by (row, col), drop duplicate edges (and self loops)."""
    keep = rows != cols if remove_self_loops else np.ones_like(rows, bool)
    rows, cols = rows[keep], cols[keep]
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    if rows.size:
        uniq = np.concatenate(
            ([True], (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1]))
        )
        rows, cols = rows[uniq], cols[uniq]
    return rows.astype(np.int32), cols.astype(np.int32)


def _symmetric_weights(rows, cols, seed: int) -> np.ndarray:
    """Per-edge weights equal for (u,v) and (v,u): a hash of the unordered
    pair, so a symmetric graph's CSC view can alias its CSR."""
    a = np.minimum(rows, cols).astype(np.uint64)
    b = np.maximum(rows, cols).astype(np.uint64)
    key = a * np.uint64(2654435761) ^ (b + np.uint64(0x9E3779B9)) ^ np.uint64(seed)
    key = (key ^ (key >> np.uint64(16))) * np.uint64(0x45D9F3B)
    key = (key ^ (key >> np.uint64(16))) * np.uint64(0x45D9F3B)
    key = key ^ (key >> np.uint64(16))
    return (key % np.uint64(1_000_000)).astype(np.float32) / 1e6 + 0.1


def rmat_coo(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    weighted: bool = True,
    undirected: bool = False,
) -> Coo:
    """R-MAT edge list with Graph500 defaults (a,b,c,d)=(.57,.19,.19,.05):
    ``2**scale`` vertices, ``edge_factor * 2**scale`` sampled edges before
    dedup, vertex ids randomly permuted."""
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        # quadrant probabilities: a=(0,0) b=(0,1) c=(1,0) d=(1,1)
        row_bit = r >= a + b
        col_bit = (r >= a) & (r < a + b) | (r >= a + b + c)
        rows |= row_bit.astype(np.int64) << bit
        cols |= col_bit.astype(np.int64) << bit
    perm = rng.permutation(n)
    rows, cols = perm[rows], perm[cols]
    if undirected:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    rows, cols = _dedup_coo(rows, cols, n)
    if not weighted:
        values = np.ones(rows.size, dtype=np.float32)
    elif undirected:
        values = _symmetric_weights(rows, cols, seed)
    else:
        values = rng.random(rows.size).astype(np.float32) + 0.1
    return Coo(n_rows=n, n_cols=n, row_indices=rows, col_indices=cols, values=values)


def grid2d_coo(side: int, weighted: bool = False, seed: int = 0) -> Coo:
    """Undirected 2-D lattice (road-network stand-in): side*side vertices."""
    n = side * side
    idx = np.arange(n).reshape(side, side)
    rows = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    cols = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    rows, cols = _dedup_coo(rows, cols, n)
    values = (
        _symmetric_weights(rows, cols, seed)
        if weighted
        else np.ones(rows.size, dtype=np.float32)
    )
    return Coo(n_rows=n, n_cols=n, row_indices=rows, col_indices=cols, values=values)


def rmat_graph(scale: int, edge_factor: int = 16, seed: int = 0,
               device=DEFAULT, **kw) -> Graph:
    device = resolve(device)  # fail before generating when there is no card
    coo = rmat_coo(scale, edge_factor, seed=seed, **kw)
    props = GraphProperties(
        directed=not kw.get("undirected", False),
        weighted=kw.get("weighted", True),
        symmetric=kw.get("undirected", False),
    )
    return build_graph(coo_to_csr(coo), props, device)


def grid2d_graph(side: int, weighted: bool = False, seed: int = 0,
                 device=DEFAULT) -> Graph:
    return build_graph(
        coo_to_csr(grid2d_coo(side, weighted=weighted, seed=seed)),
        GraphProperties(directed=False, weighted=weighted, symmetric=True),
        device,
    )
