"""CPU references for ``--validate`` (the oracles of
``gunrock_tpu/examples/cpu_reference.py``), on the graph's host arrays,
vectorized so that they can check an R-MAT scale 18 graph."""

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


def _out_edges(offs, vertices):
    """Edge ids of the out-edges of ``vertices``, and how many each has."""
    degs = offs[vertices + 1] - offs[vertices]
    first = np.cumsum(degs) - degs
    return np.repeat(offs[vertices] - first, degs) + np.arange(degs.sum()), degs


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
        nbrs = np.unique(cols[_out_edges(offs, front)[0]])
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
        edges, degs = _out_edges(offs, f)
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
        deg -= np.bincount(cols[_out_edges(offs, peel)[0]], minlength=V)
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


def bc(graph, source: int) -> np.ndarray:
    """Single-source Brandes dependencies, 0.5-scaled (bc.hxx parity), in
    float64 level by level: path counts forward, dependencies backward
    over the edges from each level to the next."""
    offs = graph.host["row_offsets"].astype(np.int64)
    cols = graph.host["col_indices"]
    V = graph.n_vertices
    sigma = np.zeros(V)
    dist = np.full(V, -1, np.int64)
    sigma[source] = 1.0
    dist[source] = 0
    levels = [np.asarray([source], dtype=np.int64)]
    while levels[-1].size:
        front = levels[-1]
        edges, degs = _out_edges(offs, front)
        nbrs = cols[edges]
        new = np.unique(nbrs[dist[nbrs] < 0])
        dist[new] = len(levels)
        onward = dist[nbrs] == len(levels)
        sigma += np.bincount(nbrs[onward],
                             weights=np.repeat(sigma[front], degs)[onward],
                             minlength=V)
        levels.append(new)
    delta = np.zeros(V)
    for d in range(len(levels) - 2, 0, -1):
        front = levels[d]
        edges, degs = _out_edges(offs, front)
        src, dst = np.repeat(front, degs), cols[edges]
        down = dist[dst] == d + 1
        src, dst = src[down], dst[down]
        delta += np.bincount(
            src, weights=sigma[src] / sigma[dst] * (1 + delta[dst]),
            minlength=V)
    delta[source] = 0.0
    return (0.5 * delta).astype(np.float32)


def spgemm(graph_a, graph_b):
    """C = A . B as a scipy CSR with sorted rows (never densified)."""
    C = (_to_scipy(graph_a) @ _to_scipy(graph_b)).tocsr()
    C.sort_indices()
    return C


def spgemm_errors(got, want, rtol: float = 1e-3, atol: float = 1e-4) -> int:
    """The number of entries of the sparse matrices ``got`` and ``want``
    that differ by more than ``atol + rtol * |want|`` (an entry missing
    from one of them counts as 0 there)."""
    excess = abs(got - want) - rtol * abs(want)
    return int((excess.data > atol).sum())


def tc(graph, block_rows: int = 8192) -> np.ndarray:
    """Per-vertex triangle membership counts of the undirected simple
    graph. With L the adjacency of the DAG that points every edge from its
    lower to its higher (degree, id) endpoint, each triangle u -> v -> w,
    u -> w is one entry of (L . L) o L at (u, w), which counts it for u
    (row sums) and w (column sums), and one of (L^T . L) o L at (v, w),
    which counts it for v (row sums). Both products run in row blocks."""
    A = (_to_scipy(graph) != 0).astype(np.int64).tocsr()
    A.setdiag(0)
    A.eliminate_zeros()
    A = A.maximum(A.T).tocoo()
    V = graph.n_vertices
    deg = np.bincount(A.row, minlength=V)
    lower = (deg[A.row] < deg[A.col]) | ((deg[A.row] == deg[A.col])
                                         & (A.row < A.col))
    import scipy.sparse as sp

    L = sp.csr_matrix((np.ones(int(lower.sum()), np.int64),
                       (A.row[lower], A.col[lower])), shape=(V, V))
    Lt = L.T.tocsr()
    counts = np.zeros(V, np.int64)
    for r0 in range(0, V, block_rows):
        rows = slice(r0, min(r0 + block_rows, V))
        ends = (L[rows] @ L).multiply(L[rows])
        counts[rows] += np.asarray(ends.sum(axis=1)).ravel()
        counts += np.asarray(ends.sum(axis=0)).ravel()
        mids = (Lt[rows] @ L).multiply(L[rows])
        counts[rows] += np.asarray(mids.sum(axis=1)).ravel()
    return counts.astype(np.int32)


def _midpoint(lat1, lon1, lat2, lon2):
    """Spherical midpoint in degrees, float64 (reference geo.hxx:71-98)."""
    lat1, lon1, lat2, lon2 = (np.radians(np.asarray(a, np.float64))
                              for a in (lat1, lon1, lat2, lon2))
    bx = np.cos(lat2) * np.cos(lon2 - lon1)
    by = np.cos(lat2) * np.sin(lon2 - lon1)
    mlat = np.arctan2(np.sin(lat1) + np.sin(lat2),
                      np.sqrt((np.cos(lat1) + bx) ** 2 + by ** 2))
    mlon = lon1 + np.arctan2(by, np.cos(lat1) + bx)
    return np.degrees(mlat), np.degrees(mlon)


def geo_invariants(graph, lat0, lon0, out_lat, out_lon,
                   atol: float = 1e-2) -> int:
    """Geolocation invariants (the reference geo example ships no CPU
    oracle; these are the closed forms of geo.hxx's 1- and 2-neighbor
    cases plus label preservation). Returns the number of violations:

    1. originally-labeled vertices keep their coordinates,
    2. predicted coordinates lie in valid (lat, lon) ranges,
    3. an unlabeled vertex whose ONLY originally-labeled neighbor is v
       ends at v's coordinates (assigned at iteration 1, stable after),
    4. exactly two originally-labeled neighbors -> their spherical
       midpoint, longitudes compared modulo 360.
    """
    offs = graph.host["row_offsets"].astype(np.int64)
    cols = graph.host["col_indices"]
    V = graph.n_vertices
    lat0 = np.asarray(lat0, np.float32)
    lon0 = np.asarray(lon0, np.float32)
    out_lat = np.asarray(out_lat, np.float32)
    out_lon = np.asarray(out_lon, np.float32)
    labeled0 = ~np.isnan(lat0)
    errors = int((labeled0 & (~np.isclose(out_lat, lat0, atol=atol)
                              | ~np.isclose(out_lon, lon0, atol=atol))).sum())
    ok = ~np.isnan(out_lat)
    errors += int((ok & ((out_lat < -90 - atol) | (out_lat > 90 + atol)
                         | (out_lon < -180 - atol)
                         | (out_lon > 180 + atol))).sum())
    srcs = np.repeat(np.arange(V), np.diff(offs))
    nb_lab = labeled0[cols]
    nlab = np.bincount(srcs, weights=nb_lab, minlength=V)
    # first and last labeled neighbor per source, in edge order
    at = np.flatnonzero(nb_lab)
    first = np.full(V, -1, np.int64)
    first[srcs[at[::-1]]] = cols[at[::-1]]
    last = np.full(V, -1, np.int64)
    last[srcs[at]] = cols[at]
    one = ~labeled0 & (nlab == 1)
    errors += int((~np.isclose(out_lat[one], lat0[first[one]], atol=atol)
                   | ~np.isclose(out_lon[one], lon0[first[one]],
                                 atol=atol)).sum())
    two = ~labeled0 & (nlab == 2)
    mla, mlo = _midpoint(lat0[first[two]], lon0[first[two]],
                         lat0[last[two]], lon0[last[two]])
    dlon = np.mod(out_lon[two] - mlo + 180.0, 360.0) - 180.0
    errors += int((~np.isclose(out_lat[two], mla, atol=atol)
                   | ~(np.abs(dlon) <= atol)).sum())
    return errors
