"""Graph coloring via parallel independent sets (Luby/Jones-Plassmann).

Port of ``gunrock_tpu/algorithms/color.py`` (role of reference
``algorithms/color.hxx``). Three strategies, each as a plain-tensor body
and as a body on the bucketed kernels:

- ``luby`` (reference parity): per round an uncolored vertex takes color
  ``2*it`` if its priority beats every uncolored neighbour's, or
  ``2*it + 1`` if it is beaten by all: :func:`color_kernel`, and
  :func:`color_kernel_pallas` on the fused max/min pass
  (``ops/kernels/semiring.py``, one pass per round);
- ``rank`` (multi-color rank Jones-Plassmann): :func:`color_kernel_rank`,
  and :func:`color_kernel_rank_pallas` on two frontier-sparse semiring
  passes per round;
- ``greedy`` (speculative windowed-mex greedy): :func:`color_kernel_greedy`,
  and :func:`color_kernel_greedy_pallas` on one frontier-sparse SpMM per
  round.

Directed graphs are colored as their underlying undirected graph; self
loops are ignored. The ``*_pallas`` names are the JAX package's: in the
port they run the CUDA kernels (their plain versions on the CPU).

Priorities: ``make_priorities`` draws its permutation from an explicit
``torch.Generator`` seeded with ``seed``, so the seeded strategies give
other (equally valid) colors than the JAX package for one seed; pass
``priorities=`` to feed both the same permutation. The rank and greedy
kernel bodies are deterministic (priority = inverse vertex id) and equal
the JAX package's colors and round counts exactly.

Every loop reads one flag back to the host per round.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gunrock_tpu_torch.device import DEFAULT
from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.configs import LoadBalance, Options, default_options
from gunrock_tpu_torch.ops.kernels.layout import build_auto_layout, build_bucketed_layout
from gunrock_tpu_torch.ops.kernels.semiring import (
    _BIG,
    bucketed_semiring_spmv_sparse,
    bucketed_semiring_spmv_sparse_minmax,
)
from gunrock_tpu_torch.ops.kernels.spmm import bucketed_spmm_sparse
from gunrock_tpu_torch.ops.sort import lex_sort
from gunrock_tpu_torch.utils.timer import timed

INVALID_COLOR = -1


@dataclasses.dataclass
class Param:
    seed: int = 0
    ordering: str = "random"  # "random" (reference parity) | "degree" (JP-LDF)


@dataclasses.dataclass
class Result:
    colors: torch.Tensor  # int32[V]
    iterations: int
    elapsed_ms: float


def make_priorities(graph: Graph, seed: int, ordering: str = "random"):
    """Unique per-vertex priorities, int32[V]. "random" = a permutation of
    [0, V) (the reference's uniform randoms, color.hxx:67), drawn on the
    host from ``torch.Generator().manual_seed(seed)`` so it is the same on
    every device. "degree" = Jones-Plassmann largest-degree-first: the
    ranks of a stable sort by (degree, permutation)."""
    V = graph.n_vertices
    gen = torch.Generator().manual_seed(int(seed))
    perm = torch.randperm(V, generator=gen).to(torch.int32).to(graph.device)
    if ordering == "random":
        return perm
    if ordering == "degree":
        ids = torch.arange(V, dtype=torch.int32, device=graph.device)
        _, _, order = lex_sort((graph.out_degrees(), perm, ids), num_keys=2)
        return torch.zeros(V, dtype=torch.int32, device=graph.device).scatter_(
            0, order.long(), ids)
    raise ValueError(f"unknown ordering {ordering!r}")


def _priorities(graph: Graph, seed: int, ordering: str, priorities):
    if priorities is None:
        return make_priorities(graph, seed, ordering)
    if not isinstance(priorities, torch.Tensor):
        priorities = torch.from_numpy(np.array(priorities))  # a copy
    return priorities.to(device=graph.device, dtype=torch.int32)


def _seg_reduce(vals, index, V: int, init, reduce: str):
    """Per-vertex max/min/sum of ``vals`` grouped by ``index``, starting
    from ``init``."""
    out = torch.full((V,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, index, vals, reduce=reduce,
                               include_self=True)


def color_step(graph: Graph, colors, randoms, iteration: int):
    """One Luby round in plain tensor ops. Two new colors: 2*it and
    2*it + 1. On directed graphs the neighbour scans cover both out- and
    in-edges (the underlying undirected graph)."""
    V = graph.n_vertices
    uncolored = colors == INVALID_COLOR
    big = V + 1
    nbr_max = torch.full((V,), -1, dtype=torch.int32, device=colors.device)
    nbr_min = torch.full((V,), big, dtype=torch.int32, device=colors.device)
    sides = [(graph.edge_src.long(), graph.col_indices.long())]
    if not graph.properties.symmetric:
        sides.append((graph.csc_dst.long(), graph.csc_rows.long()))
    for at, nbr in sides:
        # relevant neighbours: uncolored, not a self loop (color.hxx:126-130)
        relevant = uncolored[nbr] & (at != nbr)
        r = randoms[nbr]
        nbr_max.scatter_reduce_(0, at, torch.where(relevant, r, -1),
                                reduce="amax", include_self=True)
        nbr_min.scatter_reduce_(0, at, torch.where(relevant, r, big),
                                reduce="amin", include_self=True)
    has_nbr = nbr_max >= 0
    colormax = uncolored & (randoms > nbr_max)
    colormin = uncolored & has_nbr & (randoms < nbr_min) & ~colormax
    color = iteration * 2
    colors = torch.where(colormax, color, colors)
    return torch.where(colormin, color + 1, colors)


def _uncolored_left(colors) -> bool:
    """The per-round host read of the coloring loops."""
    return bool((colors == INVALID_COLOR).any())


def _new_colors(V: int, device) -> torch.Tensor:
    return torch.full((V,), INVALID_COLOR, dtype=torch.int32, device=device)


def color_kernel(graph: Graph, seed: int = 0,
                 max_iterations: int | None = None, ordering: str = "random",
                 priorities=None):
    """Luby coloring in plain tensor ops. Returns (colors, iterations)."""
    V = graph.n_vertices
    max_it = V if max_iterations is None else max_iterations
    randoms = _priorities(graph, seed, ordering, priorities)
    colors = _new_colors(V, graph.device)
    it = 0
    while it < max_it and _uncolored_left(colors):
        colors = color_step(graph, colors, randoms, it)
        it += 1
    return colors, it


def _undirected_edges(graph: Graph):
    """(src, dst) int64 tensors of the underlying undirected graph's
    two-copy edge list (self loops still in)."""
    src, dst = graph.edge_src, graph.col_indices
    if not graph.properties.symmetric:
        src = torch.cat([src, graph.csc_dst])
        dst = torch.cat([dst, graph.csc_rows])
    return src.long(), dst.long()


def _assign_rank_colors(colors, col_now, rank, base, R: int):
    """Give the vertices of ``col_now`` the colors ``base + remap[rank]``,
    where remap compacts the ranks used this round. Returns (colors,
    base advanced past them)."""
    used = torch.zeros(R + 1, dtype=torch.int32, device=colors.device)
    used[torch.where(col_now, rank, R).long()] = 1
    used = used[:R]
    remap = (torch.cumsum(used, 0) - used).to(torch.int32)
    colors = torch.where(col_now, base + remap[rank.long()], colors)
    return colors, base + used.sum().to(torch.int32)


def color_kernel_rank(graph: Graph, seed: int = 0,
                      max_iterations: int | None = None,
                      ordering: str = "random", rank_cap: int = 32,
                      priorities=None):
    """Rank-based multi-color Jones-Plassmann in plain tensor ops. Per
    round every uncolored vertex computes ``rank`` = its number of
    higher-priority uncolored neighbours (clamped to ``rank_cap - 1``) and
    colors itself ``base + remap[rank]`` when its rank strictly exceeds the
    ranks of all of them. Returns (colors, iterations)."""
    V = graph.n_vertices
    max_it = V if max_iterations is None else max_iterations
    prio = _priorities(graph, seed, ordering, priorities)
    R = rank_cap
    src, dst = _undirected_edges(graph)
    outranks = (prio[dst] > prio[src]) & (src != dst)
    colors = _new_colors(V, graph.device)
    base = torch.zeros((), dtype=torch.int32, device=graph.device)
    it = 0
    while it < max_it and _uncolored_left(colors):
        unc = colors == INVALID_COLOR
        higher = unc[dst] & outranks
        rank = torch.clamp(
            _seg_reduce((higher & unc[src]).to(torch.int32), src, V, 0, "sum"),
            max=R - 1)
        mr = _seg_reduce(torch.where(higher, rank[dst], -1), src, V, -1,
                         "amax")
        mr = torch.where(unc, mr, V + 10)
        col_now = unc & (rank > mr)
        colors, base = _assign_rank_colors(colors, col_now, rank, base, R)
        it += 1
    return colors, it


def _sym_loopfree_edges(graph: Graph):
    """Host (src, dst) of the self-loop-free edge set the coloring layouts
    hold: the CSR edges, doubled when the graph is directed so that every
    edge is seen from both ends."""
    src, dst = graph.host["edge_src"], graph.host["col_indices"]
    if not graph.properties.symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    keep = src != dst  # drop self loops (color.hxx:126-130)
    return src[keep], dst[keep]


def _build_layout(graph: Graph, src, dst, vals, window, chunk):
    if window is None and chunk is None:
        return build_auto_layout(src, dst, vals, graph.n_vertices,
                                 device=graph.device)
    return build_bucketed_layout(src, dst, vals, graph.n_vertices,
                                 window=window, chunk=chunk,
                                 device=graph.device)


def _color_layout(graph: Graph, window: int | None = None,
                  chunk: int | None = None):
    """Self-loop-free, symmetrized unit push layout of the Luby scans
    (cached on the graph)."""
    key = ("color_sym", window, chunk)
    if key not in graph.layouts:
        src, dst = _sym_loopfree_edges(graph)
        graph.layouts[key] = _build_layout(
            graph, src, dst, np.ones(src.size, np.float32), window, chunk)
    return graph.layouts[key]


def _rank_color_layout(graph: Graph, window: int | None = None,
                       chunk: int | None = None):
    """Self-loop-free, symmetrized push layout whose values hold the static
    higher-priority predicate: w[(v, u)] = 1 iff neighbour u outranks v
    (u's id is smaller: the rank and greedy kernel bodies take the inverse
    vertex-id order as priority, so a degree-sorted graph gets
    largest-degree-first for free). Cached on the graph."""
    key = ("color_rank", window, chunk)
    if key not in graph.layouts:
        src, dst = _sym_loopfree_edges(graph)
        graph.layouts[key] = _build_layout(
            graph, src, dst, (dst < src).astype(np.float32), window, chunk)
    return graph.layouts[key]


def _greedy_color_setup(graph: Graph, window: int | None = None,
                        chunk: int | None = None):
    """(layout, rank) of the greedy coloring: the layout of
    :func:`_rank_color_layout` and the static outranking degree
    rank[v] = #{u ~ v : u < v}, computed once on the host (cached)."""
    layout = _rank_color_layout(graph, window, chunk)
    key = ("color_greedy_rank",)
    if key not in graph.layouts:
        src, dst = _sym_loopfree_edges(graph)
        rank = np.bincount(src[dst < src], minlength=graph.n_vertices)
        graph.layouts[key] = torch.from_numpy(rank.astype(np.int32)).to(
            graph.device)
    return layout, graph.layouts[key]


def color_kernel_rank_pallas(graph: Graph, max_iterations: int | None = None,
                             layout=None, rank_cap: int = 32):
    """Rank Jones-Plassmann on the frontier-sparse semiring kernel, two
    passes per round over the layout of :func:`_rank_color_layout`:

      rank[v] = plus_times(unc)                  # higher uncolored nbrs
      mq[v]   = max_times(pack(rankc, inv_id))

    where pack = rankc * MULT + inv_id + 1 is a lexicographic (rank,
    priority) key, so one max reduction decides: v colors iff
    pack[v] > mq[v]. pack must stay exact in f32 (<= 2^24): ids are
    shifted so that inv_id fits 18 bits; past scale 18 adjacent ids may
    tie, which only delays those vertices. The shift is kept although the
    port could pack in int32, so that the colors equal the JAX package's
    at every scale. Both passes skip source and destination windows with
    no uncolored vertex. Deterministic. Returns (colors, iterations)."""
    V = graph.n_vertices
    dev = graph.device
    max_it = V if max_iterations is None else max_iterations
    if layout is None:
        layout = _rank_color_layout(graph)
    R = rank_cap
    shift = max(0, max(1, (V - 1).bit_length()) - 18)
    ids = torch.arange(V, dtype=torch.int32, device=dev)
    inv1 = ((V - 1 - ids) >> shift) + 1
    mult = ((V - 1) >> shift) + 2
    colors = _new_colors(V, dev)
    base = torch.zeros((), dtype=torch.int32, device=dev)
    it = 0
    while it < max_it and _uncolored_left(colors):
        unc = colors == INVALID_COLOR
        rank = bucketed_semiring_spmv_sparse(
            layout, unc.float(), unc, "plus_times", out_mask=unc)
        rankc = torch.clamp(rank, max=R - 1).to(torch.int32)
        pack = (rankc * mult + inv1).float()
        mq = bucketed_semiring_spmv_sparse(
            layout, torch.where(unc, pack, 0.0), unc, "max_times",
            out_mask=unc)
        col_now = unc & (pack > mq)
        colors, base = _assign_rank_colors(colors, col_now, rankc, base, R)
        it += 1
    return colors, it


def _mex_update(colors, cnt, base, K: int, lanes_k):
    """The greedy round after ``cnt`` is known: conflicts give their color
    up, candidates take the first free slot of the window. Returns
    (new_colors, the mask of vertices left uncolored)."""
    unc = colors == INVALID_COLOR
    inwin = (colors >= base) & (colors < base + K)
    koff = torch.clamp(colors - base, 0, K - 1)
    own = (koff[:, None] == lanes_k) & inwin[:, None]
    cnt_own = torch.where(own, cnt, torch.zeros((), dtype=cnt.dtype,
                                                device=cnt.device)).sum(dim=1)
    conflict = inwin & (cnt_own > 0)
    cand = unc | conflict
    # mex: the first k with cnt == 0, K if the window is full
    mex = torch.where(cnt == 0, lanes_k, K).amin(dim=1).to(torch.int32)
    take = cand & (mex < K)
    new_colors = torch.where(conflict, INVALID_COLOR, colors)
    new_colors = torch.where(take, base + mex, new_colors)
    return new_colors, new_colors == INVALID_COLOR


def color_kernel_greedy_pallas(graph: Graph, rank: torch.Tensor | None = None,
                               max_iterations: int | None = None, layout=None,
                               K: int = 32, phase_spread: bool = True):
    """Speculative greedy (windowed-mex) coloring on the frontier-sparse
    SpMM. Per round one pass maintains ``cnt[v, k]`` = the number of
    outranking neighbours of v with color base + k (the ``higher``
    predicate is in the layout's values): its input is the signed one-hot
    delta of the vertices whose color changed last round, added into the
    carried cnt, so a round's cost tracks the change set. ``out_mask``
    leaves the rows of stable vertices stale on purpose. Every unstable
    vertex then takes the mex (first k with cnt == 0); a colored vertex
    whose own slot went positive is in conflict and takes the mex again.
    The counts are f32 sums of +-1, exact below 2^24 in any order, so the
    ``cnt == 0`` tests do not depend on the order of the atomics.

    Colors live in windows of K: when a phase stalls with uncolored
    (window-saturated) vertices, base advances by K, cnt resets and
    (``phase_spread``) the rest seeds the new window at rank % K.
    Deterministic (priority = inverse vertex id). Needs V < 2^24. Returns
    (colors, iterations)."""
    V = graph.n_vertices
    dev = graph.device
    max_it = 4 * V if max_iterations is None else max_iterations
    if layout is None or rank is None:
        d_layout, d_rank = _greedy_color_setup(graph)
        layout = d_layout if layout is None else layout
        rank = d_rank if rank is None else rank
    lanes_k = torch.arange(K, dtype=torch.int32, device=dev)[None, :]

    def onehot_inwin(cols, base, mask):
        inwin = (cols >= base) & (cols < base + K)
        koff = torch.clamp(cols - base, 0, K - 1)
        return ((koff[:, None] == lanes_k)
                & (inwin & mask)[:, None]).float(), inwin

    colors = torch.clamp(rank, max=K - 1)  # rank-init tentative coloring
    old = _new_colors(V, dev)
    changed = torch.ones(V, dtype=torch.bool, device=dev)
    cnt = torch.zeros((V, K), dtype=torch.float32, device=dev)
    base = torch.zeros((), dtype=torch.int32, device=dev)
    it = 0
    while it < max_it and bool(changed.any()
                               | (colors == INVALID_COLOR).any()):
        unc = colors == INVALID_COLOR
        oh_new, inwin = onehot_inwin(colors, base, changed)
        oh_old, _ = onehot_inwin(old, base, changed)
        unstable = unc | inwin
        cnt = cnt + bucketed_spmm_sparse(layout, oh_new - oh_old, changed,
                                         out_mask=unstable, exact=True)
        new_colors, unc2 = _mex_update(colors, cnt, base, K, lanes_k)
        changed_new = new_colors != colors
        stall = ~changed_new.any() & unc2.any()
        base_next = base + torch.where(stall, K, 0).to(torch.int32)
        if phase_spread:
            colors_next = torch.where(stall & unc2, base_next + rank % K,
                                      new_colors)
            changed_next = torch.where(stall, unc2, changed_new)
        else:
            colors_next = new_colors
            changed_next = changed_new & ~stall
        cnt = torch.where(stall, 0.0, cnt)
        old, colors, changed, base = colors, colors_next, changed_next, base_next
        it += 1
    return colors, it


def color_kernel_greedy(graph: Graph, max_iterations: int | None = None,
                        K: int = 32, phase_spread: bool = True):
    """Speculative greedy coloring in plain tensor ops: the update rules of
    :func:`color_kernel_greedy_pallas`, with cnt recomputed every round by
    a scatter-add. Returns (colors, iterations)."""
    V = graph.n_vertices
    dev = graph.device
    max_it = 4 * V if max_iterations is None else max_iterations
    hsrc, hdst = _undirected_edges(graph)
    higher = (hdst < hsrc) & (hsrc != hdst)
    rank = _seg_reduce(higher.to(torch.int32), hsrc, V, 0, "sum")
    lanes_k = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
    colors = torch.clamp(rank, max=K - 1)
    base = torch.zeros((), dtype=torch.int32, device=dev)
    changed = True
    it = 0
    while it < max_it and (changed or _uncolored_left(colors)):
        nc = colors[hdst]
        n_inwin = (nc >= base) & (nc < base + K)
        slot = hsrc * K + torch.clamp(nc - base, 0, K - 1)
        cnt = torch.zeros(V * K, dtype=torch.int32, device=dev).index_add_(
            0, slot, (n_inwin & higher).to(torch.int32)).view(V, K)
        new_colors, unc2 = _mex_update(colors, cnt, base, K, lanes_k)
        any_changed, any_unc = torch.stack(
            [(new_colors != colors).any(), unc2.any()]).tolist()
        stall = (not any_changed) and any_unc
        if stall:
            base = base + K
        if phase_spread:
            colors = (torch.where(unc2, base + rank % K, new_colors)
                      if stall else new_colors)
            changed = any_changed or stall
        else:
            colors = new_colors
            changed = any_changed
        it += 1
    return colors, it


def color_kernel_pallas(graph: Graph, seed: int = 0,
                        max_iterations: int | None = None, layout=None,
                        ordering: str = "random", priorities=None):
    """Luby coloring on the fused max/min pass: both neighbour scans of a
    round are one kernel pass over the layout of :func:`_color_layout`.
    Priorities are fed shifted by +1, so that the identity 0 always means
    "no uncolored neighbour". Only uncolored vertices feed priorities in
    and only uncolored vertices read their scan result, so source and
    destination windows with no uncolored vertex are skipped. Returns
    (colors, iterations)."""
    V = graph.n_vertices
    max_it = V if max_iterations is None else max_iterations
    if layout is None:
        layout = _color_layout(graph)
    randf = _priorities(graph, seed, ordering, priorities).float() + 1.0
    colors = _new_colors(V, graph.device)
    it = 0
    while it < max_it and _uncolored_left(colors):
        uncolored = colors == INVALID_COLOR
        nbr_max, nbr_min = bucketed_semiring_spmv_sparse_minmax(
            layout, torch.where(uncolored, randf, 0.0), uncolored,
            out_mask=uncolored)
        has_nbr = nbr_min < _BIG
        colormax = uncolored & (randf > nbr_max)
        colormin = uncolored & has_nbr & (randf < nbr_min) & ~colormax
        colors = torch.where(colormax, it * 2, colors)
        colors = torch.where(colormin, it * 2 + 1, colors)
        it += 1
    return colors, it


def run(
    graph: Graph,
    seed: int = 0,
    options: Options | None = None,
    warmup: bool = True,
    ordering: str = "random",
    strategy: str = "auto",
    device=DEFAULT,
) -> Result:
    """Role of reference ``color::run`` (color.hxx:167-186) on ``device``.

    ``strategy``: "auto" (greedy on the kernel path, luby on the plain
    path), "luby" (reference parity, 2 colors per round), "rank"
    (multi-color rank Jones-Plassmann) or "greedy" (speculative
    windowed-mex greedy). With ``options.load_balance ==
    PALLAS_MERGE_PATH`` (the default) the bodies on the bucketed kernels
    run; their rank and greedy forms take the inverse vertex-id order as
    priority and so ignore ``seed`` and ``ordering``: relabel the graph
    (``graph/reorder.py``) to change it."""
    graph = graph.to(device)
    if options is None:
        options = default_options()
    kernels = options.load_balance == LoadBalance.PALLAS_MERGE_PATH
    if strategy == "auto":
        strategy = "greedy" if kernels else "luby"
    if strategy not in ("luby", "rank", "greedy"):
        raise ValueError(f"unknown coloring strategy {strategy!r}")
    if kernels and strategy == "greedy":
        layout, rank = _greedy_color_setup(graph)

        def fn():
            return color_kernel_greedy_pallas(graph, rank, layout=layout)
    elif kernels and strategy == "rank":
        layout = _rank_color_layout(graph)

        def fn():
            return color_kernel_rank_pallas(graph, layout=layout)
    elif kernels:
        layout = _color_layout(graph)

        def fn():
            return color_kernel_pallas(graph, seed=seed, layout=layout,
                                       ordering=ordering)
    elif strategy == "greedy":
        def fn():
            return color_kernel_greedy(graph)
    elif strategy == "rank":
        def fn():
            return color_kernel_rank(graph, seed=seed, ordering=ordering)
    else:
        def fn():
            return color_kernel(graph, seed=seed, ordering=ordering)
    (colors, it), elapsed_ms = timed(graph.device, fn, warmup)
    return Result(colors=colors, iterations=int(it), elapsed_ms=elapsed_ms)
