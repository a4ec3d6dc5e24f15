"""Synthetic graph generators (numpy copy of
``gunrock_tpu/io/generators.py``).

The families stand in for the reference's downloaded datasets: R-MAT
(power law), uniform random (Erdos-Renyi), the 2-D grid and the Delaunay
mesh (road-like, long diameter), the stochastic block model (communities)
and the directed bipartite graph (web/citation). Every generator draws the
same numbers in the same order as the JAX package's, so a seed gives a
bit-identical COO in both packages. The ``*_graph`` forms build on
``device``.
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


def uniform_random_coo(
    n: int, avg_degree: int = 8, seed: int = 0, weighted: bool = True
) -> Coo:
    """Erdos-Renyi-style G(n, m) with m ~= n * avg_degree."""
    rng = np.random.default_rng(seed)
    m = n * avg_degree
    rows = rng.integers(0, n, m, dtype=np.int64)
    cols = rng.integers(0, n, m, dtype=np.int64)
    rows, cols = _dedup_coo(rows, cols, n)
    values = (
        (rng.random(rows.size).astype(np.float32) + 0.1)
        if weighted
        else np.ones(rows.size, dtype=np.float32)
    )
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


def uniform_graph(n: int, avg_degree: int = 8, seed: int = 0, weighted=True,
                  device=DEFAULT) -> Graph:
    device = resolve(device)
    coo = uniform_random_coo(n, avg_degree, seed=seed, weighted=weighted)
    return build_graph(
        coo_to_csr(coo), GraphProperties(directed=True, weighted=weighted),
        device,
    )


def delaunay_coo(n_points: int, seed: int = 0, weighted: bool = True) -> Coo:
    """Delaunay triangulation of random 2-D points (the reference's
    delaunay_n* family: planar mesh, degree ~6, long diameter)."""
    from scipy.spatial import Delaunay

    pts = np.random.default_rng(seed).random((n_points, 2))
    s = Delaunay(pts).simplices
    rows = np.concatenate([s[:, 0], s[:, 1], s[:, 2]])
    cols = np.concatenate([s[:, 1], s[:, 2], s[:, 0]])
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    rows, cols = _dedup_coo(rows, cols, n_points)
    values = (
        _symmetric_weights(rows, cols, seed)
        if weighted
        else np.ones(rows.size, dtype=np.float32)
    )
    return Coo(n_rows=n_points, n_cols=n_points, row_indices=rows,
               col_indices=cols, values=values)


def sbm_coo(
    n: int,
    n_blocks: int = 8,
    avg_degree: int = 16,
    mixing: float = 0.1,
    seed: int = 0,
    weighted: bool = True,
) -> Coo:
    """Stochastic-block-model community graph: ``mixing`` is the fraction
    of edge endpoints that cross community boundaries; communities are
    contiguous id ranges."""
    rng = np.random.default_rng(seed)
    m = n * avg_degree // 2
    block = rng.integers(0, n_blocks, n, dtype=np.int64)
    order = np.argsort(block, kind="stable")
    vid_of = np.empty(n, np.int64)
    vid_of[order] = np.arange(n)
    members = [np.where(block == b)[0] for b in range(n_blocks)]
    # an empty block cannot host endpoints: its draws go to block 0 (never
    # empty after this fallback)
    if members[0].size == 0:
        members[0] = np.asarray([0], np.int64)
    occupied = np.asarray(
        [b if members[b].size else 0 for b in range(n_blocks)], np.int64
    )
    src_b = occupied[rng.integers(0, n_blocks, m, dtype=np.int64)]
    cross = rng.random(m) < mixing
    dst_b = np.where(
        cross, occupied[rng.integers(0, n_blocks, m, dtype=np.int64)], src_b
    )
    rows = np.empty(m, np.int64)
    cols = np.empty(m, np.int64)
    for b in range(n_blocks):
        sm = src_b == b
        if sm.any():
            rows[sm] = members[b][rng.integers(0, len(members[b]), int(sm.sum()))]
        dm = dst_b == b
        if dm.any():
            cols[dm] = members[b][rng.integers(0, len(members[b]), int(dm.sum()))]
    rows, cols = vid_of[rows], vid_of[cols]
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    rows, cols = _dedup_coo(rows, cols, n)
    values = (
        _symmetric_weights(rows, cols, seed)
        if weighted
        else np.ones(rows.size, dtype=np.float32)
    )
    return Coo(n_rows=n, n_cols=n, row_indices=rows, col_indices=cols,
               values=values)


def bipartite_coo(
    n_left: int,
    n_right: int,
    avg_degree: int = 8,
    seed: int = 0,
    weighted: bool = True,
) -> Coo:
    """Directed bipartite graph on n_left + n_right vertices (left ids
    first): every edge goes left -> right."""
    rng = np.random.default_rng(seed)
    n = n_left + n_right
    m = n_left * avg_degree
    rows = rng.integers(0, n_left, m, dtype=np.int64)
    cols = n_left + rng.integers(0, n_right, m, dtype=np.int64)
    rows, cols = _dedup_coo(rows, cols, n)
    values = (
        (rng.random(rows.size).astype(np.float32) + 0.1)
        if weighted
        else np.ones(rows.size, dtype=np.float32)
    )
    return Coo(n_rows=n, n_cols=n, row_indices=rows, col_indices=cols,
               values=values)


def delaunay_graph(n_points: int, seed: int = 0, weighted: bool = True,
                   device=DEFAULT) -> Graph:
    device = resolve(device)
    coo = delaunay_coo(n_points, seed=seed, weighted=weighted)
    return build_graph(
        coo_to_csr(coo),
        GraphProperties(directed=False, weighted=weighted, symmetric=True),
        device,
    )


def sbm_graph(n: int, n_blocks: int = 8, avg_degree: int = 16,
              mixing: float = 0.1, seed: int = 0, weighted: bool = True,
              device=DEFAULT) -> Graph:
    device = resolve(device)
    coo = sbm_coo(n, n_blocks, avg_degree, mixing, seed=seed, weighted=weighted)
    return build_graph(
        coo_to_csr(coo),
        GraphProperties(directed=False, weighted=weighted, symmetric=True),
        device,
    )


def bipartite_graph(n_left: int, n_right: int, avg_degree: int = 8,
                    seed: int = 0, weighted: bool = True,
                    device=DEFAULT) -> Graph:
    device = resolve(device)
    coo = bipartite_coo(n_left, n_right, avg_degree, seed=seed,
                        weighted=weighted)
    return build_graph(
        coo_to_csr(coo), GraphProperties(directed=True, weighted=weighted),
        device,
    )


def generate_points(n: int, seed: int = 0, box: float = 1.0) -> np.ndarray:
    """Uniform 2-D points (reference io/points.hxx ``generate``)."""
    rng = np.random.default_rng(seed)
    return (rng.random((n, 2)) * box).astype(np.float32)
