"""Serial CPU references for ``--validate`` (the BFS, SSSP, PageRank,
SpMV, HITS, PPR, k-core, coloring and MST oracles of
``gunrock_tpu/examples/cpu_reference.py``), on the graph's host arrays."""

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


def ppr(graph, seed: int, alpha: float = 0.15, epsilon: float = 1e-6,
        max_iterations: int | None = None) -> np.ndarray:
    """Andersen-style frontier-synchronous PPR push, the numpy mirror of
    ``algorithms/ppr.ppr_kernel``, in float32 so that knife-edge threshold
    crossings match the device loop. Each wave gathers the frontier's
    out-edges only; their sums per destination are taken in float64."""
    offs = graph.host["row_offsets"].astype(np.int64)
    cols = graph.host["col_indices"]
    V = graph.n_vertices
    deg = np.diff(offs).astype(np.float32)
    c1 = np.float32(2 * alpha / (1 + alpha))
    c2 = np.float32((1 - alpha) / (1 + alpha))
    p = np.zeros(V, np.float32)
    r = np.zeros(V, np.float32)
    r[seed] = 1.0
    front = np.zeros(V, bool)
    front[seed] = True
    thresh = (deg * np.float32(epsilon)).astype(np.float32)
    max_it = (2 * V) if max_iterations is None else max_iterations
    it = 0
    while front.any() and it < max_it:
        p = np.where(front, p + c1 * r, p)
        rp = np.where(front, np.float32(0.0), r)
        f = np.flatnonzero(front)
        degs = offs[f + 1] - offs[f]
        first = np.cumsum(degs) - degs
        edges = np.repeat(offs[f] - first, degs) + np.arange(degs.sum())
        push = np.repeat((c2 * r[f] / np.maximum(deg[f], 1.0)).astype(
            np.float32), degs)
        upd = np.bincount(cols[edges], weights=push, minlength=V).astype(
            np.float32)
        new_rp = (rp + upd).astype(np.float32)
        front = (rp < thresh) & (new_rp >= thresh)
        r = new_rp
        it += 1
    return p


def kcore(graph) -> np.ndarray:
    """Core numbers by peeling from k=1 (reference semantics: isolated
    vertices get 1), wave by wave: at each k every alive vertex of residual
    degree <= k peels, until none does. Self loops are excluded from the
    degrees, as in ``algorithms/kcore.py``."""
    offs = graph.host["row_offsets"].astype(np.int64)
    cols = graph.host["col_indices"]
    V = graph.n_vertices
    src = np.repeat(np.arange(V), np.diff(offs))
    deg = np.diff(offs) - np.bincount(src[src == cols], minlength=V)
    cores = np.zeros(V, dtype=np.int32)
    alive = np.ones(V, dtype=bool)
    k = 1
    while alive.any():
        peel = np.flatnonzero(alive & (deg <= k))
        if not peel.size:
            k = max(k + 1, int(deg[alive].min()))
            continue
        cores[peel] = k
        alive[peel] = False
        degs = offs[peel + 1] - offs[peel]
        first = np.cumsum(degs) - degs
        edges = np.repeat(offs[peel] - first, degs) + np.arange(degs.sum())
        deg -= np.bincount(cols[edges], minlength=V)
    return cores


def color_is_valid(graph, colors: np.ndarray) -> bool:
    """Every vertex is colored and no edge (self loops aside) joins two
    vertices of one color."""
    src, dst = graph.host["edge_src"], graph.host["col_indices"]
    off_diag = src != dst
    return bool((colors >= 0).all()
                and (colors[src[off_diag]] != colors[dst[off_diag]]).all())


def mst_weight(graph) -> float:
    """Weight of a minimum spanning forest by scipy (which reads an
    asymmetric matrix as undirected, taking the smaller of two weights)."""
    from scipy.sparse.csgraph import minimum_spanning_tree

    return float(minimum_spanning_tree(_to_scipy(graph)).sum())
