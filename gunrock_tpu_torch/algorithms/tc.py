"""Triangle counting: per-vertex triangle membership + total.

Port of ``gunrock_tpu/algorithms/tc.py`` (role of reference
``algorithms/tc.hxx``: per edge (u, v) with v > u a sorted two-pointer
intersection of adjacency lists, incrementing every intersection
vertex's counter, tc.hxx:78-101; the total is the sum of the per-vertex
counters, 3x the number of distinct triangles).

As in the JAX package the graph is oriented into a DAG by degree order
(u -> v iff (deg(u), u) < (deg(v), v)), which bounds every DAG out-degree
by O(sqrt(E)) and makes each triangle discoverable exactly once as a wedge
u -> {v, w} with v -> w. Two methods:

- ``sortjoin`` (default): the wedges of a slab are enumerated on the
  device in rank space (:func:`build_dag_ranked`), their adjacency values
  gathered by the banded kernel (``ops/kernels/banded.py``), and joined
  against the DAG edges with one sort of the concatenated keys: a run of
  equal (a, b) keys that starts with the (unique) edge closes each wedge
  in it. A graph whose wedges fit ``max_wedges`` is one slab, one sort;
  per-corner counts add across slabs otherwise.
- ``probe``: for each DAG edge (u, v), N+(u) padded to the max DAG degree
  and each element binary-searched in N+(v), in chunks of edges.

What differs from the JAX package: wedge offsets are int64 (its two int32
limbs exist because its device has no int64); the join sorts one int64
key ``a * M + (b * 2 + is_wedge)`` and reads each run's first element
through a prefix max of the run starts; the per-corner counts are one
``bincount``; and the one-sort case enumerates its wedges on the device
like a slab, not on the host (:func:`build_wedges_ranked` stays as the
host enumeration the tests hold the device one against).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gunrock_tpu_torch.algorithms.spgemm import _piecewise_constant, _piecewise_expand
from gunrock_tpu_torch.device import DEFAULT
from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.configs import Options
from gunrock_tpu_torch.ops.kernels.banded import banded_gather, pad_table
from gunrock_tpu_torch.utils.timer import timed

BLOCK_T = 2048  # wedges per banded-gather block
MAX_SPAN_ROWS = 200  # windows past this take the flat gather instead


@dataclasses.dataclass
class Param:
    reduce_all_triangles: bool = True


@dataclasses.dataclass
class Result:
    vertex_triangles_count: torch.Tensor  # int32[V]: triangles containing v
    total_triangles_count: int  # sum of the above == 3 * n_triangles
    n_triangles: int
    elapsed_ms: float


def _symmetrized_edges(graph: Graph):
    """(src, cols, deg) of the underlying undirected simple graph:
    triangles live there; directed inputs are symmetrized and deduped
    (self-loops are dropped by the orientation either way)."""
    offsets = graph.host["row_offsets"]
    cols = graph.host["col_indices"]
    src = graph.host["edge_src"]
    if not graph.properties.symmetric:
        import scipy.sparse as sp

        V = graph.n_vertices
        A = sp.csr_matrix(
            (np.ones(src.shape[0], np.int8), (src, cols)), shape=(V, V)
        )
        A = A.maximum(A.T).tocoo()
        src = A.row.astype(np.int64)
        cols = A.col.astype(np.int64)
        deg = np.bincount(src, minlength=V).astype(np.int64)
    else:
        deg = np.diff(offsets)
    return src, cols, deg


def build_dag(graph: Graph):
    """Degree-ordered DAG orientation (host side, numpy).

    Returns (offsets int32[V+1], adj int32[E_dag], edge_u, edge_v, deg)
    where ``adj`` rows are ascending (inherited from CSR column order),
    (edge_u, edge_v) enumerate DAG edges in CSR order, and ``deg`` is the
    symmetrized simple-graph degree the orientation ranked by."""
    src, cols, deg = _symmetrized_edges(graph)
    # rank(u) < rank(v) iff (deg[u], u) < (deg[v], v)
    keep = (deg[src] < deg[cols]) | ((deg[src] == deg[cols]) & (src < cols))
    edge_u = src[keep].astype(np.int32)
    edge_v = cols[keep].astype(np.int32)
    dag_offsets = np.zeros(graph.n_vertices + 1, dtype=np.int32)
    np.cumsum(np.bincount(edge_u, minlength=graph.n_vertices),
              out=dag_offsets[1:])
    return dag_offsets, edge_v.copy(), edge_u, edge_v, np.asarray(deg, np.int64)


def build_dag_ranked(graph: Graph):
    """Degree-rank-relabeled DAG (host, numpy).

    Vertices are renamed to their rank under ascending (degree, id), so
    the degree orientation becomes plain id order (u -> v iff u < v) and
    every wedge {x, y} drawn from a sorted adjacency row is already
    oriented: y sits later in the row than x, hence y > x.

    The wedge-bearing compaction ``wadj`` concatenates only rows with DAG
    degree >= 2 (rows of degree <= 1 spawn no wedges and are never
    referenced by one). Consecutive wedge-bearing edges are then at most
    2 apart in wadj (the only wedge-free kept edges are each row's last),
    which bounds the adjacency positions referenced by T consecutive
    wedges to a window of 2T + max_deg: the contract of the banded gather.

    Returns dict: rank int32[V] (orig id -> rank id), eu/ev int32[E_dag]
    (ALL dag edges, CSR order: the join's edge stream), wadj int32[Ew]
    (x value of each wedge-bearing edge AND the y gather table), weu
    int32[Ew] (apex), woff int64[Ew+1] (wedge offsets; base_j = j+1),
    max_deg (max DAG out-degree), n_wedges."""
    import scipy.sparse as sp

    src, cols, deg = _symmetrized_edges(graph)
    V = graph.n_vertices
    order = np.lexsort((np.arange(V), deg))
    rank = np.empty(V, np.int64)
    rank[order] = np.arange(V)
    ru = rank[src]
    rv = rank[cols]
    keep = ru < rv
    A = sp.csr_matrix(
        (np.ones(int(keep.sum()), np.int8), (ru[keep], rv[keep])),
        shape=(V, V),
    )
    A.sort_indices()
    dag_offsets = A.indptr.astype(np.int64)
    dag_adj = A.indices.astype(np.int32)
    dag_deg = np.diff(dag_offsets)
    eu = np.repeat(np.arange(V, dtype=np.int32), dag_deg)
    keep_rows = dag_deg >= 2
    row_sel = keep_rows[eu]
    wadj = dag_adj[row_sel].astype(np.int32)
    weu = eu[row_sel].astype(np.int32)
    wdeg = dag_deg[keep_rows]
    woff = np.zeros(wadj.size + 1, np.int64)
    if wadj.size:
        # wedges of wadj-edge j: the entries after it in its row
        row_start = np.repeat(np.cumsum(wdeg) - wdeg, wdeg)
        cnt = np.repeat(wdeg, wdeg) - (np.arange(wadj.size) - row_start) - 1
        np.cumsum(cnt, out=woff[1:])
    return {
        "rank": rank.astype(np.int32),
        "eu": eu,
        "ev": dag_adj,
        "wadj": wadj,
        "weu": weu,
        "woff": woff,
        "max_deg": int(dag_deg.max()) if dag_deg.size else 0,
        "n_wedges": int(woff[-1]),
    }


def build_wedges_ranked(wadj, weu, woff, t0: int = 0, t1: int | None = None):
    """Host wedge enumeration in rank space: wedge t of wadj-edge j has
    x = wadj[j], y = wadj[j + 1 + within] with y > x by construction.
    Returns (wv, ww, wu) int32 of the wedges [t0, t1)."""
    total = int(woff[-1])
    if t1 is None:
        t1 = total
    t = np.arange(t0, min(t1, total), dtype=np.int64)
    a_id = np.searchsorted(woff, t, side="right") - 1
    within = t - woff[a_id]
    wv = wadj[a_id]
    ww = wadj[a_id + 1 + within]
    wu = weu[a_id]
    return wv.astype(np.int32), ww.astype(np.int32), wu.astype(np.int32)


def build_wedges(dag_offsets, dag_adj, edge_u, edge_v, rank_deg,
                 t0: int = 0, t1: int | None = None):
    """Host wedge enumeration (numpy) over :func:`build_dag`'s arrays:
    every triangle appears exactly once as a wedge {x, y} from some u with
    x, y in N+(u), emitted ORIENTED by the DAG's (degree, id) rank so the
    pair matches the stored direction of its closing edge. Returns (wv,
    ww, wu) int32 of the wedges [t0, t1)."""
    dag_deg = np.diff(dag_offsets).astype(np.int64)
    r = np.arange(edge_u.size, dtype=np.int64) - dag_offsets[edge_u]
    cnt = dag_deg[edge_u] - r - 1
    woff = np.zeros(edge_u.size + 1, np.int64)
    np.cumsum(cnt, out=woff[1:])
    total = int(woff[-1])
    if t1 is None:
        t1 = total
    t = np.arange(t0, min(t1, total), dtype=np.int64)
    a_id = np.searchsorted(woff, t, side="right") - 1
    within = t - woff[a_id]
    wu = edge_u[a_id]
    x = edge_v[a_id].astype(np.int64)
    y = dag_adj[dag_offsets[wu] + r[a_id] + 1 + within].astype(np.int64)
    # orient by (deg, id) rank: the build_dag orientation rule
    x_first = (rank_deg[x] < rank_deg[y]) | (
        (rank_deg[x] == rank_deg[y]) & (x < y)
    )
    wv = np.where(x_first, x, y)
    ww = np.where(x_first, y, x)
    return wv.astype(np.int32), ww.astype(np.int32), wu.astype(np.int32)


def _search_steps(max_len: int) -> int:
    return max(1, int(np.ceil(np.log2(max(max_len, 2)))) + 1)


def probe_chunk(max_dag_degree: int) -> int:
    """DAG edges a chunk of the binary-search kernel takes: its [chunk, D]
    work arrays bounded to ~2^22 lanes, the chunk kept in [128, 2^15]."""
    return int(max(128, min((1 << 22) // max(max_dag_degree, 1), 1 << 15)))


def tc_kernel(graph_n_vertices: int, dag_offsets, dag_adj, edge_u, edge_v,
              max_dag_degree: int, chunk: int):
    """Batched wedge-check TC over DAG edges, ``chunk`` edges at a time:
    gather N+(u) padded to the max DAG degree, lower-bound each element in
    N+(v), add every found triangle to its three corners. Returns
    int32[V]."""
    V = graph_n_vertices
    dev = dag_offsets.device
    D = max(int(max_dag_degree), 1)
    steps = _search_steps(D)
    offs = dag_offsets.long()
    adj = dag_adj.long()
    last = max(adj.numel() - 1, 0)
    counts = torch.zeros(V, dtype=torch.int64, device=dev)
    j = torch.arange(D, device=dev)[None, :]
    for e0 in range(0, edge_u.numel() if adj.numel() else 0, chunk):
        u = edge_u[e0: e0 + chunk].long()
        v = edge_v[e0: e0 + chunk].long()
        base = offs[u]
        valid_y = j < (offs[u + 1] - base)[:, None]
        y = adj[torch.where(valid_y, base[:, None] + j, 0)]  # [B, D]
        lo = offs[v][:, None].expand_as(y)
        hi0 = offs[v + 1][:, None]
        hi = hi0.expand_as(y)
        for _ in range(steps):
            active = lo < hi
            mid = (lo + hi) // 2
            go_right = adj[torch.clamp(mid, max=last)] < y
            lo, hi = (torch.where(active & go_right, mid + 1, lo),
                      torch.where(active & ~go_right, mid, hi))
        found = valid_y & (lo < hi0) & (adj[torch.clamp(lo, max=last)] == y)
        per_edge = found.sum(dim=1)  # triangles closed at edge (u, v)
        counts.index_add_(0, y[found], torch.ones_like(y[found]))
        counts.index_add_(0, u, per_edge)
        counts.index_add_(0, v, per_edge)
    return counts.int()


def _join(V: int, eu, ev, wv, ww):
    """The sort-merge join of wedges (wv, ww) against DAG edges (eu, ev):
    one sort of the concatenated keys, edges first within a run of equal
    (a, b). Returns (match, a, b, perm): whether each sorted entry is a
    wedge whose run starts with an edge, its keys, and the sort's
    permutation. ``wv`` may be V (an unused slot, which no edge matches)."""
    m = 2 * V + 2
    key = torch.cat([eu.long() * m + ev.long() * 2,
                     wv.long() * m + ww.long() * 2 + 1])
    key, perm = torch.sort(key)
    pair = key >> 1  # (a, b) without the edge/wedge bit
    is_wedge = (key & 1).bool()
    start = torch.ones_like(is_wedge)
    start[1:] = pair[1:] != pair[:-1]
    at = torch.arange(key.numel(), device=key.device)
    first = torch.cummax(torch.where(start, at, 0), 0).values
    match = is_wedge & ~is_wedge[first]
    return match, key // m, (key % m) >> 1, perm


def tc_kernel_sortjoin(V: int, eu, ev, wv, ww, wu):
    """Sort-merge join TC: per-vertex counts int32[V] of the triangles
    that the wedges (wv, ww) with apex wu close against the DAG edges (eu,
    ev). Role of reference csr.hxx:116-173 ``get_intersection_count``."""
    match, a, b, perm = _join(V, eu, ev, wv, ww)
    E = eu.numel()
    apex = wu.long()[torch.clamp(perm[match] - E, min=0)]
    return torch.bincount(torch.cat([a[match], b[match], apex]),
                          minlength=V)[:V].int()


def tc_total_sortjoin(eu, ev, wv, ww, wu=None):
    """Total-only sort-join TC: the number of closed wedges (distinct
    triangles), as a tensor."""
    del wu
    # the key packing needs a bound on the second key only
    bound = max(int(ev.max()) if ev.numel() else 0,
                int(ww.max()) if ww.numel() else 0) + 1
    return _join(bound, eu, ev, wv, ww)[0].sum()


def _slab_wedges_ranked(wx, weu, woff, cnt, w0: int, n_valid: int, wtab2, *,
                        V: int, B: int, T: int, span_rows: int,
                        use_banded: bool):
    """Device wedge enumeration for slab [w0, w0 + B) in rank space
    (:func:`build_dag_ranked`): the x and apex streams are piecewise
    constant over the wedge axis and the adjacency positions piecewise
    arithmetic, so all three are cumulative sums. The one per-wedge
    gather, the adjacency values y, goes through the banded kernel; each
    block's window starts at the block's least position, and the wadj
    compaction keeps every window within 2T + max_deg. Slots past
    ``n_valid`` read a sink window and come back with wv == V. Returns
    (wv, ww, wu)."""
    Ew = wx.numel()
    off = torch.clamp(woff - w0, 0, B)[:-1]
    skip = torch.minimum(torch.clamp(w0 - woff[:-1], min=0), cnt)
    base = torch.arange(Ew, device=wx.device) + 1 + skip
    x_s, adj_pos = _piecewise_expand(wx, base, off, B)
    u_s = _piecewise_constant(weu, off, B)
    valid = torch.arange(B, device=wx.device) < n_valid
    if use_banded:
        y_s = banded_gather(
            wtab2, *banded_inputs(adj_pos, valid, wtab2.shape[0], span_rows,
                                  T), span_rows=span_rows, block_t=T)
    else:
        y_s = wx[torch.clamp(adj_pos, 0, Ew - 1)]
    return torch.where(valid, x_s, V), y_s, u_s


def banded_inputs(adj_pos, valid, n_rows_pad: int, span_rows: int, T: int):
    """(idx int32[B], block_lo int32[B // T]) for the banded gather of a
    slab's adjacency positions: unused slots point into a sink window at
    the table's padded end, and each block's window starts at the row of
    its least position."""
    sink = (n_rows_pad - span_rows) * 128
    idx = torch.where(valid, adj_pos, sink)
    block_lo = torch.clamp(idx.view(-1, T).min(dim=1).values // 128, 0,
                           n_rows_pad - span_rows)
    return idx.int(), block_lo.int()


def _tc_slab_counts(eu, ev, wx, weu, woff, cnt, w0, n_valid, wtab2, *, V, B,
                    T, span_rows, use_banded):
    """One slab: wedge enumeration + sort-join + per-vertex counts."""
    wv, ww, wu = _slab_wedges_ranked(
        wx, weu, woff, cnt, w0, n_valid, wtab2, V=V, B=B, T=T,
        span_rows=span_rows, use_banded=use_banded)
    return tc_kernel_sortjoin(V, eu, ev, wv, ww, wu)


def span_rows_for(max_deg: int, block_t: int = BLOCK_T) -> int:
    """Rows of 128 that the window of one banded-gather block spans."""
    return -(-(2 * block_t + max_deg + 2) // 128) + 1


def _cached(graph: Graph, key, make):
    if key not in graph.layouts:
        graph.layouts[key] = make()
    return graph.layouts[key]


def ranked_dag(graph: Graph) -> dict:
    """:func:`build_dag_ranked` of ``graph``, cached on it."""
    return _cached(graph, ("tc_dag_rank",), lambda: build_dag_ranked(graph))


def _run_sortjoin(graph: Graph, rk: dict, max_wedges: int):
    V, dev = graph.n_vertices, graph.device
    T = BLOCK_T
    n_wedges = rk["n_wedges"]
    B = -(-min(max_wedges, n_wedges) // T) * T
    span_rows = span_rows_for(rk["max_deg"], T)
    # a window too big for the kernel's contract takes the flat gather
    use_banded = span_rows <= MAX_SPAN_ROWS

    def to_dev():
        woff = rk["woff"]
        return tuple(torch.from_numpy(a).to(dev) for a in (
            rk["eu"], rk["ev"], rk["wadj"], rk["weu"], woff, np.diff(woff),
            pad_table(rk["wadj"], span_rows), rk["rank"].astype(np.int64)))

    eu, ev, wx, weu, woff, cnt, wtab2, rank = _cached(
        graph, ("tc_rank_slab_dev", span_rows), to_dev)

    def fn():
        counts = torch.zeros(V, dtype=torch.int32, device=dev)
        for w0 in range(0, n_wedges, B):
            counts += _tc_slab_counts(
                eu, ev, wx, weu, woff, cnt, w0, min(n_wedges - w0, B), wtab2,
                V=V, B=B, T=T, span_rows=span_rows, use_banded=use_banded)
        return counts[rank]

    return fn


def _run_probe(graph: Graph):
    V, dev = graph.n_vertices, graph.device
    dag_offsets, dag_adj, edge_u, edge_v, _ = _cached(
        graph, ("tc_dag",), lambda: build_dag(graph))
    D = int(np.diff(dag_offsets).max()) if dag_adj.size else 1
    args = _cached(graph, ("tc_dag_dev",), lambda: tuple(
        torch.from_numpy(a).to(dev)
        for a in (dag_offsets, dag_adj, edge_u, edge_v)))
    return lambda: tc_kernel(V, *args, D, probe_chunk(D))


def run(
    graph: Graph,
    reduce_all_triangles: bool = True,
    options: Options | None = None,
    warmup: bool = True,
    method: str = "sortjoin",
    max_wedges: int = 400_000_000,
    device=DEFAULT,
) -> Result:
    """Role of reference ``tc::run`` (tc.hxx:143-170) on ``device``.

    ``method='sortjoin'`` (default) runs the device sort-merge join, in
    slabs of at most ``max_wedges`` wedges (one slab, one sort, when they
    all fit); ``'probe'`` runs the batched binary-search kernel. A graph
    without wedges has no triangles and takes the probe path."""
    del options
    graph = graph.to(device)
    if method not in ("sortjoin", "probe"):
        raise ValueError(f"unknown TC method {method!r}")
    fn = None
    if method == "sortjoin":
        rk = ranked_dag(graph)
        if rk["n_wedges"] > 0:
            fn = _run_sortjoin(graph, rk, max(int(max_wedges), 1))
    if fn is None:
        fn = _run_probe(graph)
    counts, elapsed_ms = timed(graph.device, fn, warmup)
    total = int(counts.sum(dtype=torch.int64)) if reduce_all_triangles else 0
    return Result(
        vertex_triangles_count=counts,
        total_triangles_count=total,
        n_triangles=total // 3,
        elapsed_ms=elapsed_ms,
    )
