"""Serial CPU references for ``--validate`` (the BFS, SSSP, PageRank, SpMV
and HITS oracles of ``gunrock_tpu/examples/cpu_reference.py``), on the
graph's host arrays."""

from __future__ import annotations

import numpy as np

from gunrock_tpu_torch.utils.limits import UNREACHED


def _to_scipy(graph):
    import scipy.sparse as sp

    h = graph.host
    return sp.csr_matrix(
        (h["values"], h["col_indices"], h["row_offsets"]),
        shape=(graph.n_vertices, graph.n_vertices),
    )


def bfs(graph, source: int) -> np.ndarray:
    """Hop distances; int32 max where unreachable. Level by level in numpy:
    gather the frontier's out-edges, keep the unvisited targets."""
    offs = graph.host["row_offsets"].astype(np.int64)
    cols = graph.host["col_indices"]
    dist = np.full(graph.n_vertices, UNREACHED, dtype=np.int32)
    dist[source] = 0
    front = np.asarray([source], dtype=np.int64)
    level = 0
    while front.size:
        starts, degs = offs[front], offs[front + 1] - offs[front]
        first = np.cumsum(degs) - degs
        edges = np.repeat(starts - first, degs) + np.arange(degs.sum())
        nbrs = np.unique(cols[edges])
        front = nbrs[dist[nbrs] == UNREACHED]
        level += 1
        dist[front] = level
    return dist


def sssp(graph, source: int) -> np.ndarray:
    """Dijkstra distances; +inf where unreachable."""
    from scipy.sparse.csgraph import dijkstra

    return dijkstra(_to_scipy(graph), indices=source).astype(np.float32)


def pr(graph, alpha: float = 0.85, tol: float = 1e-6,
       max_iter: int = 10_000) -> np.ndarray:
    """Weighted power iteration in float64 with the reference's dangling
    handling."""
    A = _to_scipy(graph).astype(np.float64)
    V = graph.n_vertices
    out_wsum = np.asarray(A.sum(axis=1)).ravel()
    iweights = np.where(out_wsum != 0,
                        alpha / np.where(out_wsum == 0, 1, out_wsum), 0.0)
    p = np.full(V, 1.0 / V)
    for _ in range(max_iter):
        plast = p.copy()
        dsum = np.sum(np.where(iweights == 0.0, alpha * plast, 0.0))
        base = (1.0 - alpha + dsum) / V
        p = base + A.T @ (plast * iweights)
        if np.max(np.abs(p - plast)) < tol:
            break
    return p.astype(np.float32)


def spmv(graph, x: np.ndarray) -> np.ndarray:
    """y = A.x, accumulated in float64 (the JAX package's oracle sums in
    float32)."""
    A = _to_scipy(graph).astype(np.float64)
    return (A @ np.asarray(x, np.float64)).astype(np.float32)


def hits(graph, iterations: int):
    """(auth, hub) after ``iterations`` float64 HITS iterations."""
    A = (_to_scipy(graph) != 0).astype(np.float64)
    V = graph.n_vertices
    auth = np.ones(V)
    hub = np.ones(V)
    for _ in range(iterations):
        hub_n = A @ auth
        auth_n = A.T @ hub
        auth = auth_n / (np.linalg.norm(auth_n) or 1.0)
        hub = hub_n / (np.linalg.norm(hub_n) or 1.0)
    return auth.astype(np.float32), hub.astype(np.float32)
