"""Minimum spanning tree/forest (parallel Boruvka).

Port of ``gunrock_tpu/algorithms/mst.py`` (role of reference
``algorithms/mst.hxx``). Per round every component picks its least cut
edge (least weight, ties by edge id), the picks are added unless two
components picked the same edge, each component hooks onto the other
end's root, and pointer jumping flattens the root chains. Disconnected
inputs give a minimum spanning forest (``require_connected=True`` raises
instead, as the reference does).

Both symmetric and directed inputs run over the canonical undirected edge
list: one copy per unordered pair with the minimum weight over its
directed copies, self loops dropped. The canonical edges are totally
ordered by (weight, canonical id); an edge's place in that order is its
*rank*, so a component's choice is one int32 min of ranks.

Strategies of :func:`run`:

- ``pallas`` (the JAX package's name; what ``auto`` takes): the per-round
  edge sweep is the min-cut kernel of ``ops/kernels/mst_min.py`` over a
  layout of the doubled canonical edge set. Ranks and roots are int32
  from the kernel to the end, with the one sentinel 2**30 for "no cut
  edge", so the path is exact for any edge count below 2**30 (the JAX
  package rides f32 and is held to 2**24).
- ``contract``: rounds over an explicit edge list that is relabeled to
  component ids and compacted (``ops/sort.lex_sort``) every round.
- ``loop``: rounds over the fixed canonical edge list with (weight, id)
  scatter-mins, the reference's formulation.

Each round reads its number of added edges back to the host once, and each
pointer-jumping pass one flag; ``Result.rounds`` and ``Result.jump_passes``
count them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gunrock_tpu_torch.device import DEFAULT
from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.configs import Options
from gunrock_tpu_torch.ops.kernels.layout import (
    CHUNK,
    WINDOW,
    build_bucketed_layout,
)
from gunrock_tpu_torch.ops.kernels.mst_min import NO_CUT, bucketed_min_rank_cut
from gunrock_tpu_torch.ops.sort import lex_sort
from gunrock_tpu_torch.utils.timer import timed

_WMAX = float(np.finfo(np.float32).max)


@dataclasses.dataclass
class Param:
    require_connected: bool = False


@dataclasses.dataclass
class Result:
    mst_weight: float
    mst_edges: torch.Tensor  # bool[E] over CSR edge ids (chosen edges)
    n_components: int
    elapsed_ms: float
    rounds: int = 0  # Boruvka rounds (one host read each)
    jump_passes: int = 0  # pointer-jumping passes (one host read each)


def _cached(graph: Graph, key: tuple, build):
    if key not in graph.layouts:
        graph.layouts[key] = build()
    return graph.layouts[key]


def _canonical_edges(graph: Graph):
    """CSR -> canonical undirected edge list on the host (cached): numpy
    (lo, hi, weight, CSR edge id of the kept copy), each unordered pair
    once with the minimum weight over its directed copies (scipy's
    ``minimum_spanning_tree`` reads an asymmetric matrix the same way),
    self loops dropped."""
    def build():
        h = graph.host
        s = h["edge_src"].astype(np.int64)
        d = h["col_indices"].astype(np.int64)
        lo, hi = np.minimum(s, d), np.maximum(s, d)
        keep_idx = np.flatnonzero(lo != hi)
        lo, hi, w = lo[keep_idx], hi[keep_idx], h["values"][keep_idx]
        key = lo * graph.n_vertices + hi
        order = np.lexsort((w, key))
        key_s = key[order]
        first = np.ones(len(key_s), bool)
        first[1:] = key_s[1:] != key_s[:-1]
        key_u = key_s[first]
        return ((key_u // graph.n_vertices).astype(np.int32),
                (key_u % graph.n_vertices).astype(np.int32),
                w[order][first].astype(np.float32),
                keep_idx[order[first]].astype(np.int32))

    return _cached(graph, ("mst_canonical",), build)


def _rank_tables_np(graph: Graph):
    """The canonical edges in (weight, canonical id) order, as
    rank-indexed numpy tables (cached): rank r's edge has endpoints
    ``s_of[r] < d_of[r]``, weight ``w_of[r]`` and CSR id ``eid_of[r]``."""
    def build():
        cs, cd, cw, orig = _canonical_edges(graph)
        order = np.lexsort((np.arange(cw.size), cw))
        return cs[order], cd[order], cw[order], orig[order]

    return _cached(graph, ("mst_ranked_np",), build)


def _rank_tables(graph: Graph):
    """Device copies of :func:`_rank_tables_np` (cached)."""
    return _cached(graph, ("mst_ranked",), lambda: tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(graph.device)
        for a in _rank_tables_np(graph)))


def _mst_rank_layout(graph: Graph, window: int = WINDOW, chunk: int = CHUNK):
    """(layout, ranks) of the min-cut pass (cached): the bucketed layout of
    the doubled canonical edge set, so that every undirected edge is seen
    from both endpoints' rows, and the int32 rank of every slot (``NO_CUT``
    on padding), written through the layout build's own slot permutation.
    The JAX package carries the ranks in the layout's f32 values (exact
    only below 2**24); here the values are 0 and the kernel does not read
    them."""
    def build():
        s, d, _, _ = _rank_tables_np(graph)
        r = np.arange(s.size, dtype=np.int32)
        lay, slots = build_bucketed_layout(
            np.concatenate([s, d]), np.concatenate([d, s]),
            np.zeros(2 * s.size, np.float32), graph.n_vertices, window=window,
            chunk=chunk, device=graph.device, return_slots=True)
        ranks = np.full(lay.n_chunks * lay.chunk, NO_CUT, dtype=np.int32)
        ranks[slots] = np.concatenate([r, r])
        return lay, torch.from_numpy(ranks).to(graph.device)

    return _cached(graph, ("mst_rank_layout", window, chunk), build)


def _pointer_jump(roots: torch.Tensor):
    """Flatten root chains: r <- r[r] until nothing changes (mst.hxx:
    211-224), one host read per pass. Returns (roots, passes)."""
    passes = 0
    while True:
        r2 = roots[roots.long()]
        passes += 1
        if not bool((r2 != roots).any()):
            return roots, passes
        roots = r2


def _choose_and_hook(minr, roots, comp, s_of, d_of, w_of, eid_of, in_mst):
    """From each component's least cut rank ``minr`` (``NO_CUT`` if none):
    add the chosen edges (of a mutual pair the lo endpoint's component adds
    it), mark them in ``in_mst`` (whose last entry is a spare that takes
    the writes of components that add nothing) and hook the components.
    Returns (new component map before jumping, weight added, number
    added)."""
    has = minr < NO_CUT
    e = torch.where(has, minr, 0).long()
    ru = roots[s_of[e].long()]  # root of the chosen edge's lo endpoint
    rv = roots[d_of[e].long()]
    from_lo = ru == comp
    target = torch.where(from_lo, rv, ru)
    add = has & (from_lo | (minr[target.long()] != minr))
    in_mst[torch.where(add, eid_of[e], in_mst.numel() - 1).long()] = True
    weight = torch.where(add, w_of[e], 0.0).sum()
    return torch.where(add, target, comp), weight, add.sum()


def _mst_pallas(layout, ranks, s_of, d_of, w_of, eid_of, V: int, e_csr: int):
    """Boruvka with the min-cut kernel as the per-round edge sweep. Per
    round: the kernel's per-row least cut rank, one scatter-min into the
    component slots, rank-table lookups for the chosen edges, mutual-pair
    dedup, hook and pointer jumping. Returns (weight f32 tensor, in_mst
    bool[e_csr], n_components, rounds, jump passes)."""
    dev = ranks.device
    comp = torch.arange(V, dtype=torch.int32, device=dev)
    roots = comp.clone()
    in_mst = torch.zeros(e_csr + 1, dtype=torch.bool, device=dev)
    w_acc = torch.zeros((), dtype=torch.float32, device=dev)
    rounds = jumps = 0
    while s_of.numel():
        minrow = bucketed_min_rank_cut(layout, ranks, roots)
        minr = torch.full((V,), NO_CUT, dtype=torch.int32,
                          device=dev).scatter_reduce_(
            0, roots.long(), minrow, reduce="amin", include_self=True)
        new_roots, weight, n_added = _choose_and_hook(
            minr, roots, comp, s_of, d_of, w_of, eid_of, in_mst)
        rounds += 1
        if int(n_added) == 0:  # the round's host read
            break
        w_acc = w_acc + weight
        new_roots, passes = _pointer_jump(new_roots)
        jumps += passes
        roots = new_roots[roots.long()]
    n_comp = int((roots == comp).sum())
    return w_acc, in_mst[:e_csr], n_comp, rounds, jumps


def _mst_class_loop(s, d, r, roots, in_mst, s_of, d_of, w_of, eid_of, V: int):
    """Contracting Boruvka rounds over an explicit edge list. ``(s, d)``
    are the edges' current component endpoints and ``r`` their global
    ranks. Per round: component min-rank by one int32 scatter-min per
    side, the choice and hook of :func:`_choose_and_hook`, then the edges
    are relabeled to the new component ids and the dead ones (both ends in
    one component) are sorted behind the live ones (``lex_sort``, stable)
    and cut off, so a round costs its live edges. (The JAX package pads
    the list to a ladder of power-of-4 size classes, one compiled
    executable each; eager tensors need no ladder.) Returns (weight,
    rounds, jump passes); ``roots`` and ``in_mst`` (bool[E_csr + 1], see
    :func:`_choose_and_hook`) are updated in place."""
    dev = roots.device
    comp = torch.arange(V, dtype=torch.int32, device=dev)
    w_acc = torch.zeros((), dtype=torch.float32, device=dev)
    rounds = jumps = 0
    while s.numel():
        rs, rd = roots[s.long()], roots[d.long()]
        cand = torch.where(rs != rd, r, NO_CUT)
        minr = torch.full((V,), NO_CUT, dtype=torch.int32, device=dev)
        minr.scatter_reduce_(0, rs.long(), cand, reduce="amin",
                             include_self=True)
        minr.scatter_reduce_(0, rd.long(), cand, reduce="amin",
                             include_self=True)
        new_roots, weight, n_added = _choose_and_hook(
            minr, roots, comp, s_of, d_of, w_of, eid_of, in_mst)
        rounds += 1
        if int(n_added) == 0:  # the round's host read
            break
        w_acc = w_acc + weight
        new_roots, passes = _pointer_jump(new_roots)
        jumps += passes
        roots.copy_(new_roots[roots.long()])
        # relabel to the new component ids; dead edges behind the live ones
        s2, d2 = roots[rs.long()], roots[rd.long()]
        alive = s2 != d2
        _, s, d, r = lex_sort(((~alive).to(torch.int32), s2, d2, r),
                              num_keys=1)
        m = int(alive.sum())
        s, d, r = s[:m], d[:m], r[:m]
    return w_acc, rounds, jumps


def _mst_contract(graph: Graph):
    """The ``contract`` strategy: :func:`_mst_class_loop` from the ranked
    canonical edge list. Returns (weight, in_mst bool[E_csr], n_components,
    rounds, jump passes)."""
    V = graph.n_vertices
    dev = graph.device
    s_of, d_of, w_of, eid_of = _rank_tables(graph)
    roots = torch.arange(V, dtype=torch.int32, device=dev)
    in_mst = torch.zeros(graph.n_edges + 1, dtype=torch.bool, device=dev)
    r = torch.arange(s_of.numel(), dtype=torch.int32, device=dev)
    w_acc, rounds, jumps = _mst_class_loop(
        s_of, d_of, r, roots, in_mst, s_of, d_of, w_of, eid_of, V)
    n_comp = int((roots == torch.arange(V, dtype=torch.int32,
                                        device=dev)).sum())
    return w_acc, in_mst[:-1], n_comp, rounds, jumps


def mst_kernel(graph: Graph, max_rounds: int | None = None):
    """Pure Boruvka over SYMMETRIC (two-copy) edge storage: the ``src <
    dst`` cut test selects one copy of each undirected edge. A directed
    graph must go through :func:`run`, which canonicalizes the edge set
    first (here every (u, v) edge with u > v would be dropped). Returns
    (mst_weight f32 0-d tensor, mst_edge_mask bool[E], n_components)."""
    del max_rounds  # as in JAX: the loop ends on a round that adds no edge
    weight, in_mst, n_comp, _, _ = _mst_kernel_edges(
        graph.edge_src, graph.col_indices, graph.values, graph.n_vertices)
    return weight, in_mst, n_comp


def _mst_kernel_edges(src, dst, w, V: int):
    """Boruvka over explicit edge tensors (an undirected edge may appear as
    both copies or once canonically; the ``src < dst`` cut test selects one
    copy), with per-component (min weight, then min edge id) scatter-mins.
    Returns (weight, in_mst bool[E], n_components, rounds, jump passes)."""
    dev = src.device
    E = src.shape[0]
    comp = torch.arange(V, dtype=torch.int32, device=dev)
    in_mst = torch.zeros(E + 1, dtype=torch.bool, device=dev)  # [E]: spare
    weight = torch.zeros((), dtype=torch.float32, device=dev)
    if E == 0:
        return weight, in_mst[:E], V, 0, 0
    eid = torch.arange(E, dtype=torch.int32, device=dev)
    src_l, dst_l = src.long(), dst.long()
    roots = comp.clone()
    n_comp, rounds, jumps = V, 0, 0
    while n_comp > 1:
        rs, rd = roots[src_l].long(), roots[dst_l].long()
        cut = (src < dst) & (rs != rd)
        # 1. min cut-edge weight per component (both sides)
        cand_w = torch.where(cut, w, _WMAX)
        min_w = torch.full((V,), _WMAX, dtype=torch.float32, device=dev)
        min_w.scatter_reduce_(0, rs, cand_w, reduce="amin", include_self=True)
        min_w.scatter_reduce_(0, rd, cand_w, reduce="amin", include_self=True)
        # 2. min edge id among the weight ties per component
        min_e = torch.full((V,), E, dtype=torch.int32, device=dev)
        min_e.scatter_reduce_(
            0, rs, torch.where(cut & (w == min_w[rs]), eid, E), reduce="amin",
            include_self=True)
        min_e.scatter_reduce_(
            0, rd, torch.where(cut & (w == min_w[rd]), eid, E), reduce="amin",
            include_self=True)
        # 3. add the chosen edges (one per component, deduped)
        comp_has = min_w < _WMAX
        e = torch.where(comp_has, torch.clamp(min_e, max=E - 1), 0).long()
        eu, ev = src[e], dst[e]
        from_v = roots[eu.long()] == comp  # the chosen edge leaves v
        s_v = torch.where(from_v, eu, ev)
        d_v = torch.where(from_v, ev, eu)
        other_root = roots[d_v.long()]
        add = comp_has & ((s_v < d_v) | (min_e[other_root.long()] != min_e))
        n_added = int(add.sum())  # the round's host read
        rounds += 1
        if n_added == 0:
            break
        weight = weight + torch.where(add, w[e], 0.0).sum()
        in_mst[torch.where(add, min_e, E).long()] = True
        new_roots, passes = _pointer_jump(torch.where(add, other_root, comp))
        jumps += passes
        roots = new_roots[roots.long()]
        n_comp -= n_added
    return weight, in_mst[:E], n_comp, rounds, jumps


def _canonical_edges_dev(graph: Graph):
    """Device copies of :func:`_canonical_edges` (cached)."""
    return _cached(graph, ("mst_canonical_dev",), lambda: tuple(
        torch.from_numpy(a).to(graph.device)
        for a in _canonical_edges(graph)))


def _mst_canonical(graph: Graph):
    """The ``loop`` strategy: :func:`_mst_kernel_edges` over the canonical
    edge list, the chosen edges mapped back to a CSR-edge-id mask."""
    dev = graph.device
    cs, cd, cw, orig = _canonical_edges_dev(graph)
    weight, in_c, n_comp, rounds, jumps = _mst_kernel_edges(
        cs, cd, cw, graph.n_vertices)
    mask = torch.zeros(graph.n_edges + 1, dtype=torch.bool, device=dev)
    mask[torch.where(in_c, orig, graph.n_edges).long()] = True
    return weight, mask[:-1], n_comp, rounds, jumps


def run(
    graph: Graph,
    require_connected: bool = False,
    options: Options | None = None,
    warmup: bool = True,
    strategy: str = "auto",
    device=DEFAULT,
) -> Result:
    """Role of reference ``mst::run`` (mst.hxx:287-311) on ``device``.
    ``mst_edges`` is a mask over CSR edge ids (the kept copy of each
    chosen canonical edge).

    ``strategy``: ``'auto'`` takes ``'pallas'``, the min-cut kernel path,
    whenever the graph has an edge between two vertices (``'loop'``
    otherwise). The JAX package also requires fewer than 2**24 canonical
    edges and an unpaged layout there; the port's int32 ranks and its one
    layout have neither limit. ``'contract'`` and ``'loop'``: see the
    module docstring."""
    del options
    graph = graph.to(device)
    if strategy == "auto":
        strategy = "pallas" if _rank_tables_np(graph)[0].size else "loop"
    if strategy == "pallas":
        layout, ranks = _mst_rank_layout(graph)
        tables = _rank_tables(graph)

        def fn():
            return _mst_pallas(layout, ranks, *tables, graph.n_vertices,
                               graph.n_edges)
    elif strategy == "contract":
        _rank_tables(graph)  # built outside the timed call

        def fn():
            return _mst_contract(graph)
    elif strategy == "loop":
        _canonical_edges_dev(graph)  # built outside the timed call

        def fn():
            return _mst_canonical(graph)
    else:
        raise ValueError(f"unknown MST strategy {strategy!r}")
    (weight, in_mst, n_comp, rounds, jumps), elapsed_ms = timed(
        graph.device, fn, warmup)
    if require_connected and n_comp != 1:
        # reference parity: mst.hxx:245-251 throws on no-progress rounds
        raise RuntimeError(
            f"invalid graph: {n_comp} components remain (disconnected input)")
    return Result(mst_weight=float(weight), mst_edges=in_mst,
                  n_components=int(n_comp), elapsed_ms=elapsed_ms,
                  rounds=rounds, jump_passes=jumps)
