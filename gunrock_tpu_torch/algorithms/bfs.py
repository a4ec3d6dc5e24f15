"""Breadth-first search: hop distances (+ predecessors) from a source.

Port of ``gunrock_tpu/algorithms/bfs.py``. The main path is
direction-optimizing BFS (:func:`bfs_kernel_do`): per level it takes the
push step (:func:`bfs_push_step`, a CUDA kernel) for small frontiers and
the frontier-sparse semiring pull (``ops/kernels/semiring.py``) over the
unit pull layout otherwise. :func:`msbfs_kernel` runs K searches at once
as bits, one CSC-scan kernel a level (``ops/kernels/msbfs.py``). The
other options (``Options()``, FORWARD) run the level-synchronous
:func:`bfs_step` in plain tensor ops through ``BfsProblem``/``BfsEnactor``,
the reference's enactor pattern, as the JAX package does;
:func:`bfs_kernel` is the same search as a bare loop.

The JAX package runs each search as one compiled ``while_loop``; here
:func:`bfs_kernel_do` runs the Python level loop it shares with DO-SSSP
(``framework/level_graphs.py``): one host read a level, which picks the
direction and ends the loop, and on the card one replayed CUDA graph.

Spans (``utils/profiler.py``): ``bfs.run`` a call of :func:`run`, with
``bfs.search`` (the timed search) and ``bfs.predecessors`` inside it; one
``bfs.level`` a level of :func:`bfs_kernel_do` (its index, direction, the
frontier's size and out-edges, and ``graph``: ``eager``, ``capture`` or
``replay``) and ``bfs.sync`` for each level read; ``msbfs`` a call of
:func:`msbfs_kernel` (``sources``; at its end ``slots``, the CSC slots its
levels read, and ``scan_share``, those over depth x slots x words, 1.0
where no scan stops early), with one ``msbfs.level`` a level (``level``,
``direction``, ``n_front``: the vertices entering it) and ``msbfs.sync``
for each read; ``kernel.bfs_push_step`` around the push step and
``kernel.bfs_predecessors`` inside ``bfs.predecessors``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from gunrock_tpu_torch.device import DEFAULT
from gunrock_tpu_torch.framework.enactor import Enactor
from gunrock_tpu_torch.framework.level_graphs import level_graphs, run_levels
from gunrock_tpu_torch.framework.problem import Problem
from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.configs import (
    AdvanceDirection,
    LoadBalance,
    Options,
    default_options,
)
from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.layout import pull_layout
from gunrock_tpu_torch.ops.kernels.msbfs import (
    MsbfsState,
    msbfs_pull,
    msbfs_start,
    n_words,
)
from gunrock_tpu_torch.ops.kernels.predecessors import bfs_predecessors
from gunrock_tpu_torch.ops.kernels.semiring import bucketed_semiring_spmv_sparse
from gunrock_tpu_torch.utils.limits import UNREACHED
from gunrock_tpu_torch.utils.profiler import annotate, host_read
from gunrock_tpu_torch.utils.timer import timed

_BLOCKS_PER_SM = 4
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gr_bfs_push_step": [_P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _P],
}


@dataclasses.dataclass
class Param:
    single_source: int


@dataclasses.dataclass
class Result:
    distances: torch.Tensor  # int32[V]; UNREACHED (int32 max) if unreachable
    predecessors: torch.Tensor  # int32[V]; -1 if unreachable / source
    search_depth: int
    elapsed_ms: float


def bfs_step(graph: Graph, frontier, distances, predecessors, iteration):
    """One level-synchronous expansion in plain tensor ops: the new frontier
    is the unvisited vertices with an in-neighbour in the frontier, found
    by a cumsum difference over the CSC order."""
    active = frontier[graph.csc_rows]
    ce = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=active.device),
        torch.cumsum(active, dim=0),
    ])
    offs = graph.csc_offsets.long()
    reached = (ce[offs[1:]] - ce[offs[:-1]]) > 0
    new = reached & (distances == UNREACHED)
    distances = torch.where(new, iteration + 1, distances)
    if predecessors is not None:
        cand = torch.full_like(distances, UNREACHED).scatter_reduce_(
            0, graph.csc_dst.long(),
            torch.where(active, graph.csc_rows, UNREACHED), "amin")
        predecessors = torch.where(new, cand, predecessors)
    return new, distances, predecessors


def bfs_push_step(graph: Graph, front_mask, distances, iteration,
                  edge_budget: int):
    """Sparse push expansion: every unreached out-neighbour of the frontier
    gets ``iteration + 1``. Returns (new_mask, distances); ``distances`` is
    updated IN PLACE (the search loop owns it). ``iteration`` is an int or
    a 0-d int32 tensor on the graph's device, which the kernel then reads
    there (a level graph's counter). ``edge_budget`` is the
    reference's fixed expansion size; the kernel expands exactly the
    frontier's out-edges, so it only keeps the signature.

    CUDA source: ``csrc/bfs_push.cu`` (one cooperative launch that
    spreads the frontier's out-edges over the whole grid)."""
    del edge_budget
    with annotate("kernel.bfs_push_step"):
        dev = graph.device
        V = graph.n_vertices
        _build.check_tensor(front_mask, "front_mask", torch.bool, (V,), dev)
        _build.check_tensor(distances, "distances", torch.int32, (V,), dev)
        if dev.type == "cpu":
            return bfs_push_step_plain(graph, front_mask, distances, iteration)
        if dev.type != "cuda":
            raise ValueError(f"no push kernel for device {dev}")
        level_at = None
        if isinstance(iteration, torch.Tensor):
            _build.check_tensor(iteration, "iteration", torch.int32, (), dev)
            level_at, iteration = iteration, 0
        max_blocks = _BLOCKS_PER_SM * _build.sm_count(dev)
        # fresh, so that it never aliases front_mask, which the kernel
        # reads while it clears new_mask
        new_mask = torch.empty(V, dtype=torch.bool, device=dev)
        # block counts, queue, scan
        scratch = torch.empty(2 * max_blocks + 2 * V, dtype=torch.int32,
                              device=dev)
        lib = _build.load("bfs_push", _SIGNATURES)
        err = lib.gr_bfs_push_step(
            _build.ptr(front_mask), V, graph.n_edges,
            _build.ptr(graph.row_offsets),
            _build.ptr(graph.col_indices), _build.ptr(distances),
            _build.ptr(new_mask), int(iteration), _build.ptr(level_at),
            _build.ptr(scratch), max_blocks, _build.stream(dev),
        )
        _build.check(err, "bfs_push_step")
        _build.LAUNCHES["bfs_push_step"] += 1
        return new_mask, distances


def _out_edges(graph: Graph, front_mask):
    """(queue, out-degrees, out-edge ids) of the frontier: its vertices
    ascending, and their out-edges in CSR order, queue item by item."""
    q = torch.nonzero(front_mask).flatten()
    starts = graph.row_offsets[q].long()
    degs = graph.row_offsets[q + 1].long() - starts
    first = torch.cumsum(degs, 0) - degs  # queue item -> first slot
    slot = torch.arange(int(degs.sum()), device=q.device)
    return q, degs, torch.repeat_interleave(starts - first, degs) + slot


def bfs_push_step_plain(graph: Graph, front_mask, distances, iteration):
    """Plain PyTorch version of :func:`bfs_push_step` (same in-place
    update of ``distances``; ``iteration`` an int or a 0-d tensor)."""
    _, _, e = _out_edges(graph, front_mask)
    nbr = graph.col_indices[e].long()
    tgt = nbr[distances[nbr] == UNREACHED]
    distances[tgt] = int(iteration) + 1
    new_mask = torch.zeros_like(front_mask)
    new_mask[tgt] = True
    return new_mask, distances


def _pull(layout, front, dist, it):
    """Frontier-sparse plus_times pull: with a 0/1 frontier, a vertex is
    reached iff its count is > 0. Chunks with no frontier source or no
    unreached destination are skipped. ``it`` is an int or a 0-d int32
    tensor on the card (a level graph's counter, which ``where`` reads on
    the card: ``masked_fill_`` would read it to the host)."""
    unreached = dist == UNREACHED
    y = bucketed_semiring_spmv_sparse(
        layout, front.to(torch.float32), front, "plus_times",
        out_mask=unreached, exact=True, unit=True,
    )
    new = (y > 0.5) & unreached
    level = torch.as_tensor(it + 1, dtype=torch.int32)
    return new, torch.where(new, level, dist, out=dist)


def bfs_kernel_do(
    graph: Graph,
    single_source: int,
    max_iterations: int | None = None,
    edge_budget: int | None = None,
    layout=None,
    layout_dense=None,
):
    """Direction-optimizing BFS: per level, the push step when the
    frontier's out-edges and size are under ``edge_budget``, else the pull
    (the frontier-sparse kernel over ``layout``, a unit pull layout, or
    the plain cumsum pull without one). ``layout_dense``, when given, takes
    the levels whose frontier covers half the edges. On the card with a
    ``layout``, each level after a direction's first is a replayed CUDA
    graph (``framework/level_graphs.py``). Returns (distances int32[V],
    depth)."""
    max_it = graph.n_vertices if max_iterations is None else max_iterations
    if edge_budget is None:
        # the push step's cost tracks its frontier, the pull's the graph:
        # E/64 keeps push well under one pull; a hub-first order makes the
        # masked pull cheap enough that E/512 wins (the JAX package's
        # measured tuning, kept until the card's own is measured)
        div = 512 if graph.properties.hub_ordered else 64
        edge_budget = max(4096, graph.n_edges // div)
    levels = level_graphs("bfs", graph, layout, layout_dense, torch.int32)
    levels.start(single_source, UNREACHED)
    steps = {
        "push": lambda f, d, i: bfs_push_step(graph, f, d, i, edge_budget),
        "step": lambda f, d, i: bfs_step(graph, f, d, None, i)[:2],
    }
    if layout is not None:
        steps["pull"] = lambda f, d, i: _pull(layout, f, d, i)
    if layout_dense is not None:
        steps["pull_dense"] = lambda f, d, i: _pull(layout_dense, f, d, i)
    depth = run_levels(graph, levels, steps, 0, max_it, edge_budget)
    return levels.dist.clone(), depth


def msbfs_kernel(graph: Graph, sources, pull_layout=None,
                 max_iterations: int | None = None):
    """Multi-source BFS, bit-parallel: search k is bit ``k % 32`` of word
    ``k // 32`` of each vertex's frontier and seen words, and a level is
    one pass, :func:`msbfs_pull` (on the card one launch of
    ``csrc/msbfs.cu``), that ORs the frontier words of each vertex's
    in-neighbours over its CSC run, stopping once they cover the searches
    that have not reached it. One host read a level: the next frontier's
    vertices and the slots read so far. ``pull_layout`` is taken and not
    read: the CSC holds the same in-edges. Returns (distances int32[V, K],
    depth)."""
    del pull_layout
    V = graph.n_vertices
    dev = graph.device
    max_it = V if max_iterations is None else max_iterations
    src = torch.as_tensor(sources, device=dev).long().contiguous()
    K = src.shape[0]
    with annotate("msbfs", sources=K) as query:
        state = MsbfsState.empty(V, K, dev)
        msbfs_start(graph, src, state)

        def read(level):  # (vertices entering `level`, slots read so far)
            c = host_read("msbfs", state.counts)
            return c[level % 2], c[2]

        it = 0
        n_front, slots = read(it)
        while it < max_it and n_front:
            with annotate("msbfs.level", level=it, direction="pull",
                          n_front=n_front):
                msbfs_pull(graph, state, it)
            it += 1
            n_front, slots = read(it)
        full = it * graph.n_edges * n_words(K)  # every slot, every word
        query.set(slots=slots, scan_share=slots / full if full else 0.0)
    return state.dist, it


def bfs_kernel(graph: Graph, single_source: int,
               max_iterations: int | None = None,
               compute_predecessors: bool = True):
    """Plain-tensor level-synchronous BFS. Returns (distances,
    predecessors, depth); ``compute_predecessors=False`` skips the
    predecessors' segmented min and gives None for them."""
    V = graph.n_vertices
    dev = graph.device
    max_it = V if max_iterations is None else max_iterations
    dist = torch.full((V,), UNREACHED, dtype=torch.int32, device=dev)
    dist[single_source] = 0
    pred = (torch.full((V,), -1, dtype=torch.int32, device=dev)
            if compute_predecessors else None)
    front = torch.zeros(V, dtype=torch.bool, device=dev)
    front[single_source] = True
    it = 0
    while it < max_it and bool(front.any()):
        front, dist, pred = bfs_step(graph, front, dist, pred, it)
        it += 1
    return dist, pred, it


class BfsProblem(Problem):
    def __init__(self, graph: Graph, param: Param):
        super().__init__(graph)
        self.param = param

    def reset(self):
        V, dev = self.graph.n_vertices, self.graph.device
        src = self.param.single_source
        dist = torch.full((V,), UNREACHED, dtype=torch.int32, device=dev)
        dist[src] = 0
        front = torch.zeros(V, dtype=torch.bool, device=dev)
        front[src] = True
        return {
            "distances": dist,
            "predecessors": torch.full((V,), -1, dtype=torch.int32,
                                       device=dev),
            "frontier": front,
        }


class BfsEnactor(Enactor):
    """Reference enactor pattern (bfs.hxx:75-147): prepare a single-vertex
    frontier, loop advance (with its implicit filter) until it is empty."""

    def prepare_frontier(self):
        return self.problem.reset()

    def loop(self, state):
        front, dist, pred = bfs_step(
            self.problem.graph,
            state["frontier"],
            state["distances"],
            state["predecessors"],
            state["iteration"],
        )
        return {**state, "frontier": front, "distances": dist,
                "predecessors": pred}


def run(
    graph: Graph,
    single_source: int,
    options: Options | None = None,
    warmup: bool = True,
    device=DEFAULT,
) -> Result:
    """Role of reference ``bfs::run``: BFS from ``single_source`` on
    ``device`` (the graph moves there if it is elsewhere). The default
    options take the direction-optimizing path over the bucketed kernels;
    predecessors then come from one post-pass,
    :func:`_predecessors_from_distances`: each vertex's smallest
    in-neighbour one level closer, found on the card by one launch of
    ``csrc/predecessors.cu`` that stops at the first such in-neighbour of
    each ascending CSC run. Other options run ``BfsEnactor``, which keeps
    predecessors as it goes."""
    with annotate("bfs.run", sources=1):
        graph = graph.to(device)
        if not 0 <= int(single_source) < graph.n_vertices:
            raise ValueError(
                f"source {single_source} out of range [0, {graph.n_vertices})"
            )
        single_source = int(single_source)
        if options is None:
            options = default_options()
        if options.advance_direction != AdvanceDirection.OPTIMIZED:
            enactor = BfsEnactor(BfsProblem(graph, Param(single_source)))
            state, elapsed_ms = enactor.enact(warmup=warmup)
            return Result(distances=state["distances"],
                          predecessors=state["predecessors"],
                          search_depth=int(state["iteration"]),
                          elapsed_ms=elapsed_ms)
        layout = None
        if options.load_balance == LoadBalance.PALLAS_MERGE_PATH:
            layout = pull_layout(graph, unit=True)
        with annotate("bfs.search"):
            (dist, depth), elapsed_ms = timed(
                graph.device,
                lambda: bfs_kernel_do(graph, single_source, layout=layout),
                warmup)
        pred = _predecessors_from_distances(graph, dist)
        return Result(distances=dist, predecessors=pred, search_depth=depth,
                      elapsed_ms=elapsed_ms)


def _predecessors_from_distances(graph: Graph, distances):
    """pred[v] = the smallest in-neighbour u with dist[u] == dist[v] - 1;
    -1 for the source and unreached vertices. On the card one launch of
    ``csrc/predecessors.cu`` (:func:`bfs_predecessors`) scans each
    vertex's CSC run in ascending order and stops at its first such u, the
    smallest, since sources ascend within a run; on the CPU the plain
    segment min."""
    with annotate("bfs.predecessors"):
        return bfs_predecessors(graph, distances)
