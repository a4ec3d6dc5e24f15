"""Vertex-sharded graph algorithms, one process (rank) per shard.

Port of ``gunrock_tpu/parallel/sharded.py`` by contract:

- Vertex state is sharded: with ``Vs = ceil(V / n)``, shard d owns the ids
  ``[d*Vs, (d+1)*Vs)`` and holds ``[Vs]`` entries (ids past V are padding,
  never valid).
- Edges are held twice, grouped by the owner of the reduction key:
  ``d_*`` by owner(dst), sorted by (dst, src), so that a forward advance
  reduces locally with a sorted segment reduction; ``s_*`` by owner(src),
  sorted by (src, dst), for by-source reductions.
- The only V-sized traffic is the boundary exchange of the x operand: one
  ``all_gather`` of the ``[Vs]`` shards, or an ``all_to_all`` halo
  exchange over host-computed routing tables, whichever
  :func:`partition_sharded` picks (halo when the largest per-pair boundary
  H is below Vs), plus O(1) scalar collectives for convergence.

Where the port departs from the JAX layer:

- JAX runs one SPMD program (``shard_map`` + ``lax.while_loop``) in one
  process; here each rank runs its own Python loop, with one scalar
  all-reduce and one host read a round, as the port's single-device loops
  read one value a round.
- A rank holds only its own shard, and ranks need no common shape: a
  shard's edges are not padded to the largest shard's count (so there are
  no ``d_valid``/``s_valid`` masks), and a shard's kernel layout has its
  own chunk count. The meta fields keep JAX's numbers (``ed_per_shard`` is
  the largest shard's count, which also numbers MST's global edge ids as
  JAX does).
- A float segment sum adds each segment on its own, in a fixed order
  (``torch.segment_reduce`` over the row splits), where JAX takes the
  cumsum difference (a scatter serialises on the TPU): the f32 prefix of a
  shard carries an ulp of the shard's total into every row, which at
  R-MAT 18 is larger than most ranks of PageRank. (JAX itself takes the
  scatter for BC and geo, whose operands span many orders of magnitude.)
- Each algorithm returns the full, trimmed ``[V]`` result on every rank,
  as JAX returns a global array.
- ``color`` takes its priorities as ``perm=`` or draws them from a seeded
  ``torch.Generator`` (as ``algorithms/color.make_priorities``), not from
  JAX's PRNG.

The kernel path: with ``layouts=`` (:func:`build_sharded_layouts`, one
bucketed layout per rank over that shard's edges with global rows), bfs and
sssp run the frontier-sparse semiring pull (B1, whose chunks B2 plans) and
pagerank, spmv and hits the dense one (B3) on each rank's own edges.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.graph.properties import GraphProperties
from gunrock_tpu_torch.ops.segment import seg_sum_sorted, segment_reduce
from gunrock_tpu_torch.parallel import collectives as C
from gunrock_tpu_torch.utils.limits import reduce_identity

UNREACHED = 2**31 - 1
_BIG = 3.0e38  # f32-safe infinity stand-in

__all__ = [
    "ShardedGraph", "ShardedLayouts", "UNREACHED", "bc", "bfs",
    "build_sharded_layouts", "collective_bytes_detail",
    "collective_bytes_per_exchange", "color", "color_greedy", "geo", "hits",
    "kcore", "mesh_axes", "mst", "pagerank", "partition_sharded", "ppr",
    "spgemm_count", "spmv", "sssp", "tc_ring",
]


def mesh_axes(mesh):
    """The vertex-shard axis spec of ``mesh``: its one axis name on a flat
    mesh, the ordered tuple of names on a (host, chip) mesh, whose shard
    ids run host-major."""
    names = tuple(mesh.axis_names)
    return names if len(names) > 1 else names[0]


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """One rank's shard of the vertex-sharded graph (``shard``), its
    arrays on that rank's device. ``host`` keeps their numpy copies."""

    # dst-owner-grouped edges of this shard, sorted by (dst, src)
    d_src: torch.Tensor  # int32[Ed] global source ids
    d_dst_local: torch.Tensor  # int32[Ed] dst - shard * Vs
    d_val: torch.Tensor  # f32[Ed]
    d_src_pos: torch.Tensor  # int32[Ed] index into the halo recv buffer
    # src-owner-grouped edges, sorted by (src, dst)
    s_dst: torch.Tensor  # int32[Es] global destination ids
    s_src_local: torch.Tensor  # int32[Es]
    s_val: torch.Tensor  # f32[Es]
    s_dst_pos: torch.Tensor  # int32[Es]
    # halo send tables: the local vertex ids this shard sends to each peer
    d_send_idx: torch.Tensor  # int32[n, Hd]
    d_send_valid: torch.Tensor  # bool[n, Hd]
    s_send_idx: torch.Tensor  # int32[n, Hs]
    s_send_valid: torch.Tensor  # bool[n, Hs]
    # CSR row splits of the grouped edges: sums as cumsum differences
    d_row_splits: torch.Tensor  # int32[Vs + 1]
    s_row_splits: torch.Tensor  # int32[Vs + 1]

    n_vertices: int
    n_shards: int
    v_per_shard: int
    ed_per_shard: int  # the largest shard's dst-grouped edge count
    es_per_shard: int
    d_halo: int  # H of the dst-grouped (gather-at-src) exchange
    s_halo: int  # H of the src-grouped (gather-at-dst) exchange
    use_halo: bool
    properties: GraphProperties
    shard: int
    host: dict = dataclasses.field(repr=False)

    @property
    def device(self) -> torch.device:
        return self.d_row_splits.device


_FIELDS = ("d_src", "d_dst_local", "d_val", "d_src_pos", "s_dst",
           "s_src_local", "s_val", "s_dst_pos", "d_send_idx", "d_send_valid",
           "s_send_idx", "s_send_valid", "d_row_splits", "s_row_splits")


def _group_edges(key: np.ndarray, other: np.ndarray, val: np.ndarray,
                 n: int, Vs: int):
    """Group edges by owner(key), sorted by (key, other) within a shard.
    Returns (key - owner base, other, val, starts): shard d's edges are
    ``[starts[d], starts[d+1])``."""
    # owners ascend with the key: one stable sort of (key, other) groups
    order = np.argsort(key * (int(other.max(initial=0)) + 1) + other,
                       kind="stable")
    key, other, val = key[order], other[order], val[order]
    owner = key // Vs
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(owner, minlength=n), out=starts[1:])
    return ((key - owner * Vs).astype(np.int32), other.astype(np.int32),
            val.astype(np.float32), starts)


def _halo_tables(other: np.ndarray, starts: np.ndarray, n: int, Vs: int,
                 shard: int):
    """Host routing of the boundary exchange for ``shard``: shard d's edges
    read x[other]; owner(other) = e sends those values, the ascending
    distinct ids of list (e, d). Returns (send_idx [n, H]: what ``shard``
    sends to each peer, send_valid, pos: the recv index of each of
    ``shard``'s edges, H: the longest list of any pair)."""
    uniq = [np.unique(other[starts[d]:starts[d + 1]]) for d in range(n)]
    # list (e, d) is the run of uniq[d] owned by e: ids ascend, so owners do
    bounds = [np.searchsorted(u, np.arange(n + 1) * Vs) for u in uniq]
    H = max(1, max(int(np.diff(b).max(initial=0)) for b in bounds))
    send_idx = np.zeros((n, H), np.int32)
    send_valid = np.zeros((n, H), bool)
    for d in range(n):
        lo, hi = bounds[d][shard], bounds[d][shard + 1]
        send_idx[d, : hi - lo] = uniq[d][lo:hi] - shard * Vs
        send_valid[d, : hi - lo] = True
    oth = other[starts[shard]:starts[shard + 1]].astype(np.int64)
    own = oth // Vs
    at = np.searchsorted(uniq[shard], oth) - bounds[shard][own]
    return send_idx, send_valid, (own * H + at).astype(np.int32), H


def partition_sharded(graph: Graph, n_shards: int, mesh=None,
                      axis_name: str = "edges", use_halo: bool | None = None,
                      *, shard: int | None = None) -> ShardedGraph:
    """This rank's shard of the vertex-sharded partition, built on the host
    from the graph's host arrays and placed on the mesh's device (shard
    ``mesh.rank``; without a mesh, ``shard`` (default 0) on the graph's
    device). ``use_halo=None`` picks the exchange: the all_to_all halo when
    the largest per-pair boundary H is below the shard width Vs (sparse
    cuts), else one all_gather. ``axis_name`` is JAX's mesh axis; the
    port's collectives run over all ranks, so it names nothing here."""
    if shard is None:
        shard = mesh.rank if mesh is not None else 0
    device = mesh.device if mesh is not None else graph.device
    V = graph.n_vertices
    n = n_shards
    Vs = -(-max(V, 1) // n)
    h = graph.host
    src = h["edge_src"].astype(np.int64)
    dst = h["col_indices"].astype(np.int64)
    val = h["values"]

    d_dst_l, d_src, d_val, d_starts = _group_edges(dst, src, val, n, Vs)
    s_src_l, s_dst, s_val, s_starts = _group_edges(src, dst, val, n, Vs)
    d_send, d_sendv, d_pos, Hd = _halo_tables(d_src, d_starts, n, Vs, shard)
    s_send, s_sendv, s_pos, Hs = _halo_tables(s_dst, s_starts, n, Vs, shard)
    if use_halo is None:
        use_halo = max(Hd, Hs) < Vs

    def own(a, starts):
        return a[starts[shard]:starts[shard + 1]]

    def row_splits(key_local, starts):
        out = np.zeros(Vs + 1, np.int32)
        np.cumsum(np.bincount(own(key_local, starts), minlength=Vs),
                  out=out[1:])
        return out

    host = {
        "d_src": own(d_src, d_starts), "d_dst_local": own(d_dst_l, d_starts),
        "d_val": own(d_val, d_starts), "d_src_pos": d_pos,
        "s_dst": own(s_dst, s_starts), "s_src_local": own(s_src_l, s_starts),
        "s_val": own(s_val, s_starts), "s_dst_pos": s_pos,
        "d_send_idx": d_send, "d_send_valid": d_sendv,
        "s_send_idx": s_send, "s_send_valid": s_sendv,
        "d_row_splits": row_splits(d_dst_l, d_starts),
        "s_row_splits": row_splits(s_src_l, s_starts),
    }
    # copies, not views, so that the other shards' arrays can go
    host = {k: np.array(a) for k, a in host.items()}
    return ShardedGraph(
        **{k: torch.from_numpy(host[k]).to(device) for k in _FIELDS},
        n_vertices=V, n_shards=n, v_per_shard=Vs,
        ed_per_shard=max(1, int(np.diff(d_starts).max())),
        es_per_shard=max(1, int(np.diff(s_starts).max())),
        d_halo=Hd, s_halo=Hs, use_halo=bool(use_halo),
        properties=graph.properties, shard=shard, host=host)


def collective_bytes_per_exchange(sg: ShardedGraph) -> int:
    """Bytes one boundary exchange of an f32 operand moves per shard."""
    n = sg.n_shards
    if sg.use_halo:
        return 4 * n * max(sg.d_halo, sg.s_halo)
    return 4 * n * sg.v_per_shard


def collective_bytes_detail(sg: ShardedGraph, n_hosts: int = 1) -> dict:
    """Per-exchange bytes split by tier for a (host, chip) mesh: the
    cross-host (``dcn``) stage moves each shard's cross-host blocks once as
    per-host aggregates, the within-host (``ici``) stage the rest."""
    n = sg.n_shards
    chips = max(1, n // max(n_hosts, 1))
    if sg.use_halo:
        H = max(sg.d_halo, sg.s_halo)
        total = 4 * n * H
        dcn = 4 * (n - chips) * H if n_hosts > 1 else 0
    else:
        total = 4 * n * sg.v_per_shard
        dcn = 4 * (n_hosts - 1) * chips * sg.v_per_shard if n_hosts > 1 else 0
    return {"total": total, "dcn": dcn, "ici": total - dcn,
            "dcn_messages_per_device": max(n_hosts - 1, 0)}


# ---------------------------------------------------------------------------
# in-shard helpers


def _gather(sg: ShardedGraph, x_local, mesh, side: str):
    """The boundary exchange: per-edge values of x (``[Vs, ...]``) at the
    non-owned endpoint. ``side='d'`` serves the dst-grouped edges (x read
    at src), ``side='s'`` the src-grouped edges (x read at dst)."""
    if side == "d":
        pos, send_idx, send_valid, eidx = (sg.d_src_pos, sg.d_send_idx,
                                           sg.d_send_valid, sg.d_src)
    else:
        pos, send_idx, send_valid, eidx = (sg.s_dst_pos, sg.s_send_idx,
                                           sg.s_send_valid, sg.s_dst)
    if sg.use_halo:
        valid = send_valid.view(send_valid.shape + (1,) * (x_local.dim() - 1))
        send = torch.where(valid, x_local[send_idx.long()],
                           torch.zeros((), dtype=x_local.dtype,
                                       device=x_local.device))
        recv = C.all_to_all(send, mesh)
        return recv.reshape((-1,) + tuple(x_local.shape[1:]))[pos.long()]
    return C.all_gather(x_local, mesh)[eidx.long()]


def _gather_sides(sg: ShardedGraph, x_local, mesh, sides: str) -> dict:
    """:func:`_gather` of one x for each side in ``sides`` ("d", "s" or
    "ds"): in all_gather mode one all_gather serves both sides."""
    if sg.use_halo or len(sides) == 1:
        return {side: _gather(sg, x_local, mesh, side) for side in sides}
    full = C.all_gather(x_local, mesh)
    return {"d": full[sg.d_src.long()], "s": full[sg.s_dst.long()]}


def _vvalid(sg: ShardedGraph):
    """(mask of the shard's real vertices, their global ids)."""
    ids = sg.shard * sg.v_per_shard + torch.arange(
        sg.v_per_shard, dtype=torch.int32, device=sg.device)
    return ids < sg.n_vertices, ids


def _local_reduce(sg: ShardedGraph, edge_vals, active, reduce: str,
                  side: str = "d"):
    """Sorted segmented reduction of per-edge values into the shard's
    vertices, no collective (the key is owner-local). ``active=None``:
    every edge. A float sum adds each segment on its own, in a fixed order
    (``torch.segment_reduce`` over the row splits); an integer sum is the
    cumsum difference, exact."""
    seg = sg.d_dst_local if side == "d" else sg.s_src_local
    if edge_vals.dtype == torch.bool:
        edge_vals = edge_vals.to(torch.int32)
    masked = edge_vals if active is None else torch.where(
        active, edge_vals, reduce_identity(edge_vals.dtype, reduce,
                                           edge_vals.device))
    if reduce == "sum":
        splits = sg.d_row_splits if side == "d" else sg.s_row_splits
        if masked.dtype.is_floating_point:
            return torch.segment_reduce(masked, "sum", offsets=splits.long())
        return seg_sum_sorted(masked, splits)
    return segment_reduce(masked, seg, sg.v_per_shard, reduce)


def _own_rows(full: torch.Tensor, shard: int, Vs: int, fill) -> torch.Tensor:
    """Shard ``shard``'s ``[Vs]`` rows of a ``[V]`` vector, ``fill`` past
    V."""
    lo = shard * Vs
    out = torch.full((Vs,), fill, dtype=full.dtype, device=full.device)
    k = max(0, min(full.numel() - lo, Vs))
    out[:k] = full[lo:lo + k]
    return out


def _vector(x, device) -> torch.Tensor:
    """A caller's f32 [V] vector (numpy or torch) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def _full(local: torch.Tensor, V: int, mesh) -> torch.Tensor:
    """The global ``[V]`` result from every shard's ``[Vs]`` piece."""
    return C.all_gather(local, mesh)[:V]


# ---------------------------------------------------------------------------
# the kernel path: one bucketed layout per rank


@dataclasses.dataclass(frozen=True)
class ShardedLayouts:
    """This rank's bucketed layout over its own shard's edges, rows global:
    the layout covers every row block of [V] but holds only the shard's
    edges (the other blocks are unoccupied), and the advance keeps the
    shard's own [Vs] rows. Each rank has its own chunk count."""

    layout: object  # ops.kernels.layout.BucketedEdges
    v_per_shard: int
    shard: int

    @property
    def n_vertices(self) -> int:
        return self.layout.n_vertices


def build_sharded_layouts(graph: Graph, n_shards: int, side: str = "d",
                          window: int | None = None, chunk: int | None = None,
                          pad_value: float = 0.0, unit: bool = False,
                          mesh=None, shard: int | None = None) -> ShardedLayouts:
    """Host-side: this rank's layout over its shard's owner-grouped edges
    (``side='d'``: rows = dst, cols = src, the pull of bfs/sssp/pagerank;
    ``side='s'``: rows = src, cols = dst, the push of spmv and HITS's hub
    pass) at W/C = ``window``/``chunk`` (default 2048/256). ``pad_value``
    fills padding slots (the semiring's edge identity; min_plus layouts
    take inf). ``unit``: every value 1."""
    from gunrock_tpu_torch.ops.kernels.layout import (CHUNK, WINDOW,
                                                      build_bucketed_layout)

    if shard is None:
        shard = mesh.rank if mesh is not None else 0
    device = mesh.device if mesh is not None else graph.device
    V = graph.n_vertices
    Vs = -(-max(V, 1) // n_shards)
    h = graph.host
    src = h["edge_src"].astype(np.int64)
    dst = h["col_indices"].astype(np.int64)
    val = np.ones(graph.n_edges, np.float32) if unit else h["values"]
    rows, cols = (dst, src) if side == "d" else (src, dst)
    m = rows // Vs == shard
    layout = build_bucketed_layout(
        rows[m], cols[m], val[m], V, window=window or WINDOW,
        chunk=chunk or CHUNK, pad_value=pad_value, device=device)
    return ShardedLayouts(layout=layout, v_per_shard=Vs, shard=shard)


def _kernel_advance_local(L: ShardedLayouts, x_local, mesh, semiring: str,
                          active_local=None, pad_fill: float = 0.0):
    """all_gather x (f32[Vs] per shard), run the semiring pull over this
    rank's layout (B3; with ``active_local``, a bool[Vs] frontier gathered
    too, the frontier-sparse B1 whose chunks B2 plans) and return the
    shard's own [Vs] rows, ``pad_fill`` past V."""
    from gunrock_tpu_torch.ops.kernels.semiring import (
        bucketed_semiring_spmv, bucketed_semiring_spmv_sparse)

    V = L.n_vertices
    x_full = C.all_gather(x_local, mesh)[:V]
    if active_local is None:
        y = bucketed_semiring_spmv(L.layout, x_full, semiring)
    else:
        a_full = C.all_gather(active_local, mesh)[:V]
        y = bucketed_semiring_spmv_sparse(L.layout, x_full, a_full, semiring)
    return _own_rows(y, L.shard, L.v_per_shard, pad_fill)


def _any(x: torch.Tensor, mesh) -> bool:
    """Whether any shard's ``x`` has a True: one all-reduce, one read."""
    return C.pmax(int(bool(x.any())), mesh) > 0


# ---------------------------------------------------------------------------
# algorithms


def bfs(sg: ShardedGraph, src: int, mesh, max_iterations: int | None = None,
        layouts: ShardedLayouts | None = None):
    """Distributed BFS. Returns (distances int32[V], depth). ``layouts``
    (side='d'): each shard's frontier advance runs the frontier-sparse
    semiring pull (max_times) instead of the gather and segment max."""
    V = sg.n_vertices
    max_it = V if max_iterations is None else max_iterations
    vvalid, ids = _vvalid(sg)
    unreached = torch.tensor(UNREACHED, dtype=torch.int32, device=sg.device)
    d = torch.where(ids == src, torch.zeros_like(ids), unreached)
    f = ids == src
    it = 0
    while it < max_it and _any(f, mesh):
        if layouts is not None:
            y = _kernel_advance_local(layouts, f.float(), mesh, "max_times",
                                      active_local=f)
            reached = y > 0.0
        else:
            # any frontier in-neighbour: an exact integer count (JAX takes
            # the segment max of the same 0/1 values)
            reached = _local_reduce(sg, _gather(sg, f, mesh, "d"), None,
                                    "sum") > 0
        new = reached & (d == UNREACHED) & vvalid
        d = torch.where(new, it + 1, d)
        f = new
        it += 1
    return _full(d, V, mesh), it


def sssp(sg: ShardedGraph, src: int, mesh, max_iterations: int | None = None,
         layouts: ShardedLayouts | None = None):
    """Distributed frontier Bellman-Ford. Returns (distances f32[V], depth).
    ``layouts``: a side='d' min_plus layout (``pad_value=inf``)."""
    V = sg.n_vertices
    max_it = V if max_iterations is None else max_iterations
    vvalid, ids = _vvalid(sg)
    d = torch.where(ids == src, 0.0, torch.inf)
    f = ids == src
    it = 0
    while it < max_it and _any(f, mesh):
        x = torch.where(f, torch.clamp(d, max=_BIG), _BIG)
        if layouts is not None:
            relaxed = _kernel_advance_local(layouts, x, mesh, "min_plus",
                                            active_local=f,
                                            pad_fill=float("inf"))
        else:
            cand = torch.clamp(_gather(sg, x, mesh, "d") + sg.d_val, max=_BIG)
            relaxed = _local_reduce(sg, cand, cand < _BIG, "min")
        improved = (relaxed < d) & vvalid
        d = torch.where(improved, relaxed, d)
        f = improved
        it += 1
    return _full(d, V, mesh), it


def pagerank(sg: ShardedGraph, mesh, alpha: float = 0.85, tol: float = 1e-6,
             max_iterations: int = 10_000,
             layouts: ShardedLayouts | None = None):
    """Distributed weighted PageRank (reference pr.hxx semantics). Returns
    (p f32[V], iterations). ``layouts``: a side='d' plus_times layout (the
    dense pass)."""
    V = sg.n_vertices
    vvalid, _ = _vvalid(sg)
    wsum = _local_reduce(sg, sg.s_val, None, "sum", "s")
    iweights = torch.where(wsum != 0.0, alpha / wsum, 0.0)
    p = torch.where(vvalid, 1.0 / V, 0.0)
    dangling = (iweights == 0.0) & vvalid
    tol32 = float(np.float32(tol))  # JAX compares in f32
    err, it = float("inf"), 0
    while err >= tol32 and it < max_iterations:
        plast = p
        dsum = C.psum(torch.where(dangling, alpha * plast, 0.0).sum(), mesh)
        base = (1.0 - alpha + dsum) / V
        spread = plast * iweights
        if layouts is not None:
            local = _kernel_advance_local(layouts, spread, mesh, "plus_times")
        else:
            local = _local_reduce(
                sg, _gather(sg, spread, mesh, "d") * sg.d_val, None, "sum")
        p = torch.where(vvalid, base + local, 0.0)
        err = C.pmax(float((p - plast).abs().max()), mesh)
        it += 1
    return _full(p, V, mesh), it


def spmv(sg: ShardedGraph, x, mesh, layouts: ShardedLayouts | None = None):
    """Distributed y = A.x (y[src] = sum w * x[dst]). Returns y f32[V].
    ``layouts``: a side='s' plus_times layout."""
    x_local = _own_rows(_vector(x, sg.device), sg.shard, sg.v_per_shard, 0.0)
    if layouts is not None:
        y = _kernel_advance_local(layouts, x_local, mesh, "plus_times")
    else:
        y = _local_reduce(sg, sg.s_val * _gather(sg, x_local, mesh, "s"),
                          None, "sum", "s")
    return _full(y, sg.n_vertices, mesh)


def kcore(sg: ShardedGraph, mesh):
    """Distributed k-core (k-jump peel on in-degrees: undirected graphs).
    Returns (k_cores int32[V], degeneracy)."""
    vvalid, _ = _vvalid(sg)
    base = sg.shard * sg.v_per_shard
    # self loops are left out of the peel degrees (algorithms/kcore.py)
    not_loop = sg.d_src != sg.d_dst_local + base
    deg = _local_reduce(sg, not_loop, None, "sum")
    BIGD = 2**30
    k, deleted, cores = 1, ~vvalid, torch.zeros_like(deg)
    while _any(~deleted, mesh):
        # the fused k-jump: k rises to the least alive residual degree
        min_rem = C.pmin(int(torch.where(deleted, BIGD, deg).min()), mesh)
        k = max(k, min_rem)
        peel = ~deleted & (deg <= k)
        cores = torch.where(peel, k, cores)
        deleted = deleted | peel
        deg = deg - _local_reduce(sg, _gather(sg, peel, mesh, "d"), None,
                                  "sum")
    degen = C.pmax(int(cores.max()), mesh)
    return _full(cores, sg.n_vertices, mesh), degen


def hits(sg: ShardedGraph, mesh, max_iterations: int = 50,
         layouts: tuple | None = None):
    """Distributed HITS. Returns (auth f32[V], hub f32[V], iterations).
    ``layouts``: (side='s', side='d') unit-weight plus_times layouts, both
    update passes through the dense semiring pull."""
    vvalid, _ = _vvalid(sg)
    auth = vvalid.float()
    hub = vvalid.float()

    def l2(x):
        s = C.psum((x * x).sum(), mesh)
        return torch.where(s > 0, x / torch.sqrt(s), x)

    done, it = False, 0
    while not done and it < max_iterations:
        if layouts is not None:
            hub_n = l2(_kernel_advance_local(layouts[0], auth, mesh,
                                             "plus_times"))
            auth_n = l2(_kernel_advance_local(layouts[1], hub, mesh,
                                              "plus_times"))
        else:
            hub_n = l2(_local_reduce(sg, _gather(sg, auth, mesh, "s"), None,
                                     "sum", "s"))
            auth_n = l2(_local_reduce(sg, _gather(sg, hub, mesh, "d"), None,
                                      "sum"))
        # each all() global before the OR: the single-device stop rule
        fix = C.pmin(torch.stack([(auth_n == auth).all(),
                                  (hub_n == hub).all()]).int(), mesh)
        done = bool(fix.any())
        auth, hub = auth_n, hub_n
        it += 1
    V = sg.n_vertices
    return _full(auth, V, mesh), _full(hub, V, mesh), it


def color(sg: ShardedGraph, mesh, seed: int = 0,
          max_iterations: int | None = None, perm=None):
    """Distributed Luby/Jones-Plassmann coloring (two colors a round over
    the neighbours' max and min uncolored priorities). Priorities are the
    permutation ``perm`` of [0, V), or one drawn from
    ``torch.Generator().manual_seed(seed)``. Returns (colors, rounds)."""
    V, Vs = sg.n_vertices, sg.v_per_shard
    max_it = V if max_iterations is None else max_iterations
    if perm is None:
        perm = torch.randperm(V, generator=torch.Generator().manual_seed(
            int(seed)))
    perm = torch.as_tensor(np.asarray(perm)).to(sg.device, torch.int32)
    vvalid, _ = _vvalid(sg)
    # int32 priorities in [1, V], 0 the identity
    randf = _own_rows(perm, sg.shard, Vs, 0) + 1
    big = V + 2
    base = sg.shard * Vs
    # self loops do not count (color.hxx:126-130); a directed graph also
    # scans its in-edges, so the coloring is proper on the undirected graph
    rel_s = sg.s_dst != sg.s_src_local + base
    rel_d = sg.d_src != sg.d_dst_local + base
    both_sides = not sg.properties.symmetric

    def nbr_scan(x):
        """Per column of x ([Vs, 2]), the max over undirected neighbours
        (0: no neighbour); both columns in one exchange."""
        rel = {"s": rel_s, "d": rel_d}
        m = None
        for side, g in _gather_sides(sg, x, mesh,
                                     "sd" if both_sides else "s").items():
            r = torch.stack([_local_reduce(sg, g[:, j].contiguous(),
                                           rel[side], "max", side)
                             for j in (0, 1)])
            m = r if m is None else torch.maximum(m, r)
        return torch.clamp(m, min=0)

    colors = torch.where(vvalid, -1, 0).to(torch.int32)
    it = 0
    while it < max_it and _any(colors == -1, mesh):
        unc = colors == -1
        # the uncolored neighbours' largest priority and (through big - p)
        # smallest, in one scan
        nbr_max, inv_max = nbr_scan(torch.stack(
            [torch.where(unc, randf, 0), torch.where(unc, big - randf, 0)],
            dim=1))
        nbr_min = big - inv_max
        colormax = unc & (randf > nbr_max)
        colormin = unc & (inv_max > 0) & (randf < nbr_min) & ~colormax
        colors = torch.where(colormax, it * 2, colors)
        colors = torch.where(colormin, it * 2 + 1, colors)
        it += 1
    return _full(colors, V, mesh), it


def color_greedy(sg: ShardedGraph, mesh, K: int = 32,
                 max_iterations: int | None = None,
                 phase_spread: bool = True):
    """Distributed speculative windowed-mex greedy coloring
    (``algorithms/color.color_kernel_greedy`` semantics: rank init, the mex
    over per-window counts of the outranking neighbours' colors, conflicts
    re-mexed at once, K-wide phases spread by rank % K). Priorities are the
    global vertex ids. colors[Vs] and cnt[Vs, K] live on their owner; a
    round exchanges the colors once (twice on a directed graph) and
    all-reduces two flags. Returns (colors, rounds)."""
    V, Vs = sg.n_vertices, sg.v_per_shard
    max_it = 4 * V if max_iterations is None else max_iterations
    vvalid, _ = _vvalid(sg)
    base0 = sg.shard * Vs
    lanes_k = torch.arange(K, dtype=torch.int32, device=sg.device)[None, :]
    d_seg, s_seg = sg.d_dst_local.long(), sg.s_src_local.long()
    # outranking = a strictly smaller global id (self loops drop out)
    d_rel = (sg.d_src < sg.d_dst_local + base0).int()
    both = not sg.properties.symmetric
    rank = torch.zeros(Vs, dtype=torch.int32, device=sg.device)
    rank.index_add_(0, d_seg, d_rel)
    if both:
        s_rel = (sg.s_dst < sg.s_src_local + base0).int()
        rank.index_add_(0, s_seg, s_rel)

    def build_cnt(colors, base):
        """cnt[v, k]: v's outranking neighbours of color base + k."""
        cnt = torch.zeros(Vs * K, dtype=torch.int32, device=sg.device)
        far_by = _gather_sides(sg, colors, mesh, "ds" if both else "d")
        for side, far in far_by.items():
            seg, rel = (d_seg, d_rel) if side == "d" else (s_seg, s_rel)
            inw = (far >= base) & (far < base + K)
            cnt.index_add_(0, seg * K + torch.clamp(far - base, 0, K - 1),
                           rel * inw)
        return cnt.view(Vs, K)

    colors = torch.clamp(rank, max=K - 1)  # padding: rank 0, color 0
    base, changed, it = 0, True, 0
    while changed and it < max_it:
        cnt = build_cnt(colors, base)
        unc = vvalid & (colors == -1)
        inwin = vvalid & (colors >= base) & (colors < base + K)
        koff = torch.clamp(colors - base, 0, K - 1)
        cnt_own = (cnt * ((koff[:, None] == lanes_k) & inwin[:, None])).sum(1)
        conflict = inwin & (cnt_own > 0)
        free = cnt == 0
        mex = torch.where(free.any(1), free.int().argmax(1), K)
        take = (unc | conflict) & (mex < K)
        new_colors = torch.where(conflict, -1, colors)
        new_colors = torch.where(take, base + mex, new_colors).int()
        unc2 = vvalid & (new_colors == -1)
        flags = C.pmax(torch.stack([(new_colors != colors).any(),
                                    unc2.any()]).int(), mesh)
        any_changed, any_unc = (bool(f) for f in flags.tolist())
        stall = not any_changed and any_unc
        if stall:
            base += K
            if phase_spread:
                new_colors = torch.where(unc2, base + rank % K, new_colors)
        # the JAX loop's test, changed | any uncolored: with no change and
        # no stall nothing is left uncolored
        changed = any_changed or stall
        colors = new_colors
        it += 1
    return _full(colors, V, mesh), it


def ppr(sg: ShardedGraph, seed: int, mesh, alpha: float = 0.15,
        epsilon: float = 1e-6, max_iterations: int | None = None):
    """Distributed push-style personalized PageRank
    (``algorithms/ppr.py`` semantics). Returns (p f32[V], iterations)."""
    V = sg.n_vertices
    max_it = 2 * V if max_iterations is None else max_iterations
    vvalid, ids = _vvalid(sg)
    deg = _local_reduce(sg, torch.ones_like(sg.s_val), None, "sum", "s")
    p = torch.zeros_like(deg)
    r = torch.where(ids == seed, 1.0, 0.0)
    rp = r
    front = ids == seed
    c1 = 2.0 * alpha / (1.0 + alpha)
    c2 = (1.0 - alpha) / (1.0 + alpha)
    thresh = deg * epsilon
    it = 0
    while it < max_it and _any(front, mesh):
        # absorb the frontier's residual, then push along its out-edges
        p = torch.where(front, p + c1 * r, p)
        rp = torch.where(front, 0.0, rp)
        pv = torch.where(front, c2 * r / torch.clamp(deg, min=1.0), 0.0)
        new_rp = rp + _local_reduce(sg, _gather(sg, pv, mesh, "d"), None,
                                    "sum")
        front = (rp < thresh) & (new_rp >= thresh) & vvalid
        r = rp = new_rp
        it += 1
    return _full(p, V, mesh), it


def bc(sg: ShardedGraph, src: int, mesh):
    """Distributed Brandes betweenness from one source
    (``algorithms/bc.py`` semantics: 0.5-scaled, the source excluded).
    Returns bc_values f32[V]."""
    V = sg.n_vertices
    vvalid, ids = _vvalid(sg)
    labels = torch.where(ids == src, 0, -1).to(torch.int32)
    sigma = torch.where(ids == src, 1.0, 0.0)
    f = ids == src
    depth = 0
    while depth < V and _any(f, mesh):
        fs = _gather(sg, torch.where(f, sigma, 0.0), mesh, "d")
        active = fs > 0.0
        reached = _local_reduce(sg, active, None, "sum") > 0
        new = reached & (labels == -1) & vvalid
        labels = torch.where(new, depth + 1, labels)
        sigma = torch.where(new, _local_reduce(sg, fs, active, "sum"), sigma)
        f = new
        depth += 1
    sigma_safe = torch.where(sigma > 0, sigma, 1.0)
    # labels at the dst end of the src-grouped edges: fixed after forward
    lab_at_dst = _gather(sg, labels.float(), mesh, "s")
    delta = torch.zeros_like(sigma)
    for d in range(depth - 1, 0, -1):
        q = torch.where(labels == d + 1, (1.0 + delta) / sigma_safe, 0.0)
        on_level = lab_at_dst == float(d + 1)
        add = _local_reduce(sg, _gather(sg, q, mesh, "s"), on_level, "sum",
                            "s")
        delta = torch.where((labels == d) & vvalid,
                            delta + sigma_safe * add, delta)
    return _full(torch.where(ids == src, 0.0, 0.5 * delta), V, mesh)


def geo(sg: ShardedGraph, latitude, longitude, mesh,
        total_iterations: int = 3, spatial_iterations: int = 1000):
    """Distributed geolocation (``algorithms/geo.py`` semantics, neighbour
    scans over out-edges). Positions are sharded; an outer iteration
    exchanges (lat, lon) once and runs the Weiszfeld steps shard-locally.
    Returns (lat f32[V], lon f32[V])."""
    from gunrock_tpu_torch.algorithms.geo import haversine, midpoint

    V, Vs = sg.n_vertices, sg.v_per_shard
    dev = sg.device
    lat = _own_rows(_vector(latitude, dev), sg.shard, Vs, float("nan"))
    lon = _own_rows(_vector(longitude, dev), sg.shard, Vs, float("nan"))
    vvalid, _ = _vvalid(sg)
    seg = sg.s_src_local.long()
    E = seg.numel()
    eid = torch.arange(E, dtype=torch.int32, device=dev)

    def seg_sum(v):
        return _local_reduce(sg, v, None, "sum", "s")

    def scatter(init, vals, reduce):
        out = torch.full((Vs,), init, dtype=vals.dtype, device=dev)
        return out.scatter_reduce_(0, seg, vals, reduce=reduce,
                                   include_self=True)

    eps_w = 1e-3
    for _ in range(total_iterations):
        nlat = _gather(sg, lat, mesh, "s")
        nlon = _gather(sg, lon, mesh, "s")
        nb_ok = ~torch.isnan(nlat)
        n_valid = seg_sum(nb_ok.int())
        unl = torch.isnan(lat) & vvalid
        fe = torch.clamp(scatter(E, torch.where(nb_ok, eid, E), "amin"),
                         max=max(E - 1, 0)).long()
        le = torch.clamp(scatter(-1, torch.where(nb_ok, eid, -1), "amax"),
                         min=0).long()
        if E:
            n1_lat, n1_lon, n2_lat, n2_lon = nlat[fe], nlon[fe], nlat[le], \
                nlon[le]
        else:
            n1_lat = n1_lon = n2_lat = n2_lon = torch.full_like(lat, torch.nan)
        mid_lat, mid_lon = midpoint(n1_lat, n1_lon, n2_lat, n2_lon)
        zlat = torch.where(nb_ok, nlat, 0.0)
        zlon = torch.where(nb_ok, nlon, 0.0)
        denom = torch.clamp(n_valid.float(), min=1.0)
        y_lat, y_lon = seg_sum(zlat) / denom, seg_sum(zlon) / denom
        # Weiszfeld under the haversine, as algorithms/geo.py's step (the
        # zero-distance correction, per-vertex done masks); shard-local
        out_lat, out_lon = y_lat, y_lon
        done = torch.zeros(Vs, dtype=torch.bool, device=dev)
        for _ in range(spatial_iterations):
            d = haversine(nlat, nlon, y_lat[seg], y_lon[seg])
            nz = nb_ok & (d != 0)
            dinv = torch.where(nz, 1.0 / torch.clamp(d, min=1e-30), 0.0)
            nonzeros = seg_sum(nz.int())
            dinvs = seg_sum(dinv)
            dsafe = torch.clamp(dinvs, min=1e-30)
            t_lat = seg_sum(dinv * zlat) / dsafe
            t_lon = seg_sum(dinv * zlon) / dsafe
            num_zeros = n_valid - nonzeros
            all_zero = num_zeros == n_valid
            r = torch.sqrt(((t_lat - y_lat) * dinvs) ** 2
                           + ((t_lon - y_lon) * dinvs) ** 2)
            rinv = torch.where(r == 0, 0.0,
                               num_zeros.float() / torch.clamp(r, min=1e-30))
            keep, move = torch.clamp(1 - rinv, min=0.0), torch.clamp(
                rinv, max=1.0)
            y1_lat = torch.where(num_zeros == 0, t_lat,
                                 keep * t_lat + move * y_lat)
            y1_lon = torch.where(num_zeros == 0, t_lon,
                                 keep * t_lon + move * y_lon)
            step = torch.sqrt((y_lat - y1_lat) ** 2 + (y_lon - y1_lon) ** 2)
            newly = ~done & (all_zero | (step < eps_w))
            out_lat = torch.where(newly, torch.where(all_zero, y_lat, y1_lat),
                                  out_lat)
            out_lon = torch.where(newly, torch.where(all_zero, y_lon, y1_lon),
                                  out_lon)
            done = done | newly
            y_lat = torch.where(done, y_lat, y1_lat)
            y_lon = torch.where(done, y_lon, y1_lon)
        med_lat = torch.where(done, out_lat, y_lat)
        med_lon = torch.where(done, out_lon, y_lon)
        one, two, many = unl & (n_valid == 1), unl & (n_valid == 2), \
            unl & (n_valid > 2)
        new_lat = torch.where(one, n1_lat, torch.where(
            two, mid_lat, torch.where(many, med_lat, lat)))
        new_lon = torch.where(one, n1_lon, torch.where(
            two, mid_lon, torch.where(many, med_lon, lon)))
        # the date-line wrap of the single-device kernel
        lon = torch.where(torch.isnan(new_lon), new_lon,
                          torch.remainder(new_lon + 180.0, 360.0) - 180.0)
        lat = new_lat
    return _full(lat, V, mesh), _full(lon, V, mesh)


def mst(sg: ShardedGraph, mesh, max_rounds: int | None = None):
    """Distributed Boruvka MST weight. Edges are sharded; the component
    labels are a replicated O(V) array (the union-find frontier is global
    by nature), and each round takes three ``pmin`` selections of it.
    Returns (total_weight, n_rounds)."""
    Vs, n = sg.v_per_shard, sg.n_shards
    max_r = 64 if max_rounds is None else max_rounds
    V_pad = n * Vs
    dev = sg.device
    e_src = sg.d_src.long()
    e_dst = sg.d_dst_local.long() + sg.shard * Vs
    e_w = sg.d_val
    e_valid = e_src != e_dst
    # global edge ids as JAX numbers them, so that ties pick the same edge
    eid = sg.shard * sg.ed_per_shard + torch.arange(
        e_src.numel(), dtype=torch.int64, device=dev)
    iota = torch.arange(V_pad, dtype=torch.int64, device=dev)
    SENT = 2**30

    def scatter_min(vals, keys, mask, init):
        out = torch.full((V_pad,), init, dtype=vals.dtype, device=dev)
        return out.scatter_reduce_(
            0, torch.where(mask, keys, 0),
            torch.where(mask, vals, torch.full_like(vals, init)),
            reduce="amin", include_self=True)

    n_jumps = max(1, (V_pad - 1).bit_length())
    comp = iota.clone()
    total = torch.zeros((), dtype=torch.float32, device=dev)
    r, done = 0, False
    while not done and r < max_r:
        cs, cd = comp[e_src], comp[e_dst]
        cross = e_valid & (cs != cd)
        w = torch.where(cross, e_w, _BIG)
        # 1: each component's least cut weight, over both endpoints
        wmin = C.pmin(torch.minimum(scatter_min(w, cs, cross, _BIG),
                                    scatter_min(w, cd, cross, _BIG)), mesh)
        # 2: among the least-weight edges the smallest global edge id
        em_s = cross & (w <= wmin[cs])
        em_d = cross & (w <= wmin[cd])
        sel = C.pmin(torch.minimum(scatter_min(eid, cs, em_s, SENT),
                                   scatter_min(eid, cd, em_d, SENT)), mesh)
        has_edge = sel < SENT
        # 3: the winner's other endpoint
        win_s = em_s & (eid == sel[cs])
        win_d = em_d & (eid == sel[cd])
        other = C.pmin(torch.minimum(scatter_min(e_dst, cs, win_s, SENT),
                                     scatter_min(e_src, cd, win_d, SENT)),
                       mesh)
        target = torch.where(has_edge, comp[torch.clamp(other, 0, V_pad - 1)],
                             iota)
        # mirror pairs (a <-> b chose the same edge) count it once
        mirror = has_edge & (target[torch.clamp(target, 0, V_pad - 1)] == iota)
        root = comp == iota
        count_me = has_edge & (~mirror | (iota < target)) & root
        total = total + torch.where(count_me, wmin, 0.0).sum()
        parent = torch.where(root & has_edge, target, iota)
        parent = torch.where(mirror & (iota < target), iota, parent)
        # pointer doubling: ceil(log2 V) steps flatten any merge chain
        for _ in range(n_jumps):
            parent = parent[parent]
        comp = parent[comp]
        done = not bool(has_edge.any())
        r += 1
    return float(total), r


def spgemm_count(sg_a: ShardedGraph, graph_b: Graph, mesh,
                 block_products: int = 8_000_000):
    """Distributed C = A.B structure analysis: A's rows are sharded (the
    src-grouped edges are the row partition), B is replicated; each rank
    runs the expand-sort-contract count over its rows in row-aligned blocks
    of about ``block_products`` products. C's rows are disjoint, so nnz
    and the value checksum add up with one ``psum`` each. Returns (nnz,
    checksum)."""
    from gunrock_tpu_torch.algorithms.spgemm import (_expand, _plan_blocks,
                                                     _sort_runs)

    B = graph_b.to(sg_a.device)
    h = sg_a.host
    deg_b = np.diff(B.host["row_offsets"]).astype(np.int64)
    exp = np.zeros(h["s_dst"].size + 1, np.int64)
    np.cumsum(deg_b[h["s_dst"]], out=exp[1:])
    splits = h["s_row_splits"]
    nnz = torch.zeros((), dtype=torch.int64, device=B.device)
    csum = torch.zeros((), dtype=torch.float64, device=B.device)
    for r0, r1 in _plan_blocks(exp[splits], block_products):
        e0, e1 = int(splits[r0]), int(splits[r1])
        off = exp[e0:e1 + 1] - exp[e0]
        if not off[-1]:
            continue
        i, j, v = _expand(sg_a.s_src_local[e0:e1], sg_a.s_dst[e0:e1],
                          sg_a.s_val[e0:e1], B.row_offsets, B.col_indices,
                          B.values, torch.as_tensor(off, device=B.device),
                          int(off[-1]))
        nnz += _sort_runs(i, j, B.n_vertices)[3].sum()
        csum += v.sum().double()
    return int(C.psum(nnz, mesh)), float(C.psum(csum, mesh))


def tc_ring(graph: Graph, mesh):
    """Distributed triangle counting over a sharded DAG adjacency.

    The degree-ordered DAG is row-sharded by vertex owner and its edges
    (u, v) bucketed by (owner(u), owner(v)). Each rank expands the wedges
    of its own rows and binary-searches them in a second adjacency shard
    that rotates around the ring (``ppermute``); after n steps every
    bucket has met its target shard. A rank holds two shards (2E/n) and
    searches its edges in the single-device kernel's chunks
    (``tc.probe_chunk``). Returns (counts int32[V], total)."""
    from gunrock_tpu_torch.algorithms.tc import (_search_steps, build_dag,
                                                 probe_chunk)

    V = graph.n_vertices
    n, d = mesh.size, mesh.rank
    dev = mesh.device
    Vs = -(-max(V, 1) // n)
    dag_offsets, dag_adj, edge_u, edge_v, _ = build_dag(graph)
    dag_offsets = dag_offsets.astype(np.int64)
    D = max(int(np.diff(dag_offsets).max(initial=0)), 1)
    steps = _search_steps(D)

    # this rank's adjacency shard, rebased, padded to the largest shard
    starts = np.minimum(np.arange(n + 1) * Vs, V)
    sizes = np.diff(dag_offsets[starts])
    A = max(int(sizes.max()), 1)
    lo, hi = int(dag_offsets[starts[d]]), int(dag_offsets[starts[d + 1]])
    adj = np.zeros(A, np.int32)
    adj[: hi - lo] = dag_adj[lo:hi]
    offs = np.full(Vs + 1, hi - lo, np.int64)
    o = dag_offsets[starts[d]:starts[d + 1] + 1] - lo
    offs[: o.size] = o
    my_adj = torch.from_numpy(adj).to(dev)
    my_offs = torch.from_numpy(offs).to(dev)

    # this rank's DAG edges, by the ring step that meets their target
    mine = edge_u // Vs == d
    eu, ev = edge_u[mine].astype(np.int64), edge_v[mine].astype(np.int64)
    ring = (ev // Vs - d) % n
    chunk = probe_chunk(D)
    j = torch.arange(D, dtype=torch.int64, device=dev)[None, :]
    perm = [(i, (i - 1) % n) for i in range(n)]  # shards move backward
    counts = torch.zeros(V, dtype=torch.int64, device=dev)
    rot_adj, rot_offs = my_adj, my_offs
    for r in range(n):
        sel = ring == r
        u_all = torch.from_numpy(eu[sel]).to(dev)
        v_all = torch.from_numpy(ev[sel]).to(dev)
        last = rot_adj.numel() - 1
        for c0 in range(0, u_all.numel(), chunk):
            u, v = u_all[c0:c0 + chunk], v_all[c0:c0 + chunk]
            ul, vl = u - d * Vs, v - ((d + r) % n) * Vs
            base = my_offs[ul]
            valid_y = j < (my_offs[ul + 1] - base)[:, None]
            y = my_adj[torch.where(valid_y, base[:, None] + j, 0)].long()
            lo_ = rot_offs[vl][:, None].expand_as(y)
            hi0 = rot_offs[vl + 1][:, None]
            hi_ = hi0.expand_as(y)
            for _ in range(steps):
                active = lo_ < hi_
                mid = (lo_ + hi_) // 2
                right = rot_adj[torch.clamp(mid, max=last)] < y
                lo_, hi_ = (torch.where(active & right, mid + 1, lo_),
                            torch.where(active & ~right, mid, hi_))
            found = valid_y & (lo_ < hi0) & (
                rot_adj[torch.clamp(lo_, max=last)] == y)
            per_edge = found.sum(1)
            counts.index_add_(0, y[found], torch.ones_like(y[found]))
            counts.index_add_(0, u, per_edge)
            counts.index_add_(0, v, per_edge)
        if r < n - 1:
            rot_adj = C.ppermute(rot_adj, mesh, perm)
            rot_offs = C.ppermute(rot_offs, mesh, perm)
    counts = C.psum(counts, mesh).int()
    return counts, int(counts.sum())

