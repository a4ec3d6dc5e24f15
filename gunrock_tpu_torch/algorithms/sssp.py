"""Single-source shortest paths (frontier Bellman-Ford).

Port of ``gunrock_tpu/algorithms/sssp.py`` (role of reference
``algorithms/sssp.hxx``). Each iteration relaxes every out-edge of the
frontier against the distances before the iteration (Jacobi), and the new
frontier is exactly the set of improved vertices. The main path is
direction-optimizing SSSP (:func:`sssp_kernel_do`): per iteration the push
step (:func:`sssp_push_step`, a CUDA kernel) for small frontiers, else the
frontier-sparse min_plus pull (``ops/kernels/semiring.py``) over the
valued pull layout. :func:`sssp_kernel_pallas` relaxes every in-edge per
iteration through the dense min_plus pass; :func:`sssp_kernel_delta` is
the bucketed (delta-stepping) variant; :func:`sssp_kernel` and the
enactor run the plain-tensor relaxation :func:`sssp_step`.

The JAX package runs each search as one compiled ``while_loop``; here
:func:`sssp_kernel_do` runs the Python level loop it shares with DO-BFS
(``framework/level_graphs.py``): one host read an iteration, and on the
card one replayed CUDA graph. Predecessors come from one post-pass,
:func:`recover_predecessors`.

Spans (``utils/profiler.py``): ``sssp.run`` a call of :func:`run`, with
``sssp.search`` (the timed search) and ``sssp.predecessors`` inside it;
one ``sssp.level`` a round of :func:`sssp_kernel_do` and
:func:`sssp_kernel_delta` (its index, direction, the frontier's size and
out-edges, and in :func:`sssp_kernel_do` ``graph``: ``eager``,
``capture`` or ``replay``) and ``sssp.sync`` for each round's read;
``kernel.sssp_push_step`` around the push step and
``kernel.sssp_predecessors`` inside ``sssp.predecessors``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from gunrock_tpu_torch.algorithms.bfs import _out_edges
from gunrock_tpu_torch.device import DEFAULT
from gunrock_tpu_torch.framework import Enactor, Problem
from gunrock_tpu_torch.framework.level_graphs import level_graphs, run_levels
from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.configs import (
    AdvanceDirection,
    LoadBalance,
    Options,
    default_options,
)
from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.layout import pull_layout
from gunrock_tpu_torch.ops.kernels.predecessors import sssp_predecessors
from gunrock_tpu_torch.ops.kernels.semiring import (
    _BIG,
    bucketed_semiring_spmv,
    bucketed_semiring_spmv_sparse,
)
from gunrock_tpu_torch.utils.profiler import annotate, host_read
from gunrock_tpu_torch.utils.timer import timed

INF = float("inf")
# the push step's grid: at most this many blocks an SM (and the co-resident
# ones, and one vertex a thread)
_BLOCKS_PER_SM = 4
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gr_sssp_push_step": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
}


@dataclasses.dataclass
class Param:
    single_source: int


@dataclasses.dataclass
class Result:
    distances: torch.Tensor  # float32[V]; +inf if unreachable
    predecessors: torch.Tensor  # int32[V]; -1 if unreachable / source
    search_depth: int
    elapsed_ms: float


def _start(graph: Graph, single_source: int):
    """(distances, frontier) of a search from ``single_source``."""
    V = graph.n_vertices
    dist = torch.full((V,), INF, dtype=torch.float32, device=graph.device)
    dist[single_source] = 0.0
    front = torch.zeros(V, dtype=torch.bool, device=graph.device)
    front[single_source] = True
    return dist, front


def sssp_step(graph: Graph, frontier, distances):
    """One relaxation wave in plain tensor ops: relax all out-edges of
    frontier vertices (a masked segmented min over the CSC order)."""
    src = graph.csc_rows.long()
    cand = torch.where(frontier[src], distances[src] + graph.csc_values, INF)
    relaxed = torch.full_like(distances, INF).scatter_reduce_(
        0, graph.csc_dst.long(), cand, "amin")
    improved = relaxed < distances
    return improved, torch.where(improved, relaxed, distances)


def sssp_kernel(graph: Graph, single_source: int,
                max_iterations: int | None = None):
    """Plain-tensor SSSP distances. Returns (distances, iterations)."""
    max_it = graph.n_vertices if max_iterations is None else max_iterations
    dist, front = _start(graph, single_source)
    it = 0
    while it < max_it and bool(front.any()):
        front, dist = sssp_step(graph, front, dist)
        it += 1
    return dist, it


def sssp_push_step(graph: Graph, front_mask, distances, edge_budget: int):
    """Sparse push relaxation: every out-edge (v, u, w) of the frontier
    offers ``distances[v] + w`` to u. Returns (improved, new_distances);
    ``distances`` is not written (Jacobi: candidates come from the
    distances before the step). ``edge_budget`` is the reference's fixed
    expansion size; the kernel expands exactly the frontier's out-edges,
    so it only keeps the signature.

    CUDA source: ``csrc/sssp_push.cu`` (one cooperative launch that
    spreads the frontier's out-edges over the whole grid)."""
    del edge_budget
    with annotate("kernel.sssp_push_step"):
        dev = graph.device
        V = graph.n_vertices
        _build.check_tensor(front_mask, "front_mask", torch.bool, (V,), dev)
        _build.check_tensor(distances, "distances", torch.float32, (V,), dev)
        if dev.type == "cpu":
            return sssp_push_step_plain(graph, front_mask, distances)
        if dev.type != "cuda":
            raise ValueError(f"no SSSP push kernel for device {dev}")
        max_blocks = _BLOCKS_PER_SM * _build.sm_count(dev)
        new_dist = torch.empty(V, dtype=torch.float32, device=dev)
        improved = torch.empty(V, dtype=torch.bool, device=dev)
        # block counts, queue, scan
        scratch = torch.empty(2 * max_blocks + 2 * V, dtype=torch.int32,
                              device=dev)
        lib = _build.load("sssp_push", _SIGNATURES)
        err = lib.gr_sssp_push_step(
            _build.ptr(front_mask), V, graph.n_edges,
            _build.ptr(graph.row_offsets),
            _build.ptr(graph.col_indices), _build.ptr(graph.values),
            _build.ptr(distances), _build.ptr(new_dist), _build.ptr(improved),
            _build.ptr(scratch), max_blocks, _build.stream(dev),
        )
        _build.check(err, "sssp_push_step")
        _build.LAUNCHES["sssp_push_step"] += 1
        return improved, new_dist


def sssp_push_step_plain(graph: Graph, front_mask, distances):
    """Plain PyTorch version of :func:`sssp_push_step`."""
    q, degs, e = _out_edges(graph, front_mask)
    cand = torch.repeat_interleave(distances[q], degs) + graph.values[e]
    new_dist = distances.clone().scatter_reduce_(
        0, graph.col_indices[e].long(), cand, "amin")
    return new_dist < distances, new_dist


def _pull(layout, front, dist):
    """Frontier-sparse min_plus pull over a ``pad_value=_BIG`` pull
    layout: inactive sources carry _BIG, the min_plus gather identity.
    An unreached vertex (inf) never improves: inf < inf is false."""
    x = torch.where(front, dist, _BIG)
    relaxed = bucketed_semiring_spmv_sparse(layout, x, front, "min_plus")
    return relaxed < dist, torch.minimum(dist, relaxed)


def sssp_kernel_do(
    graph: Graph,
    single_source: int,
    max_iterations: int | None = None,
    edge_budget: int | None = None,
    layout=None,
    layout_dense=None,
    init_state=None,
    stop: int | None = None,
    return_state: bool = False,
):
    """Direction-optimizing SSSP: per iteration the push step when the
    frontier's out-edges and size are under ``edge_budget``, else the pull
    (the frontier-sparse min_plus kernel over ``layout``, a
    ``pad_value=_BIG`` pull layout, or :func:`sssp_step` without one).
    ``layout_dense``, when given with ``layout``, takes the iterations
    whose frontier covers half the edges. On the card with a ``layout``,
    each iteration after a direction's first is a replayed CUDA graph
    (``framework/level_graphs.py``). Returns (distances, depth).

    Resumable, for :func:`sssp_do_slabbed`: ``init_state`` (iteration,
    frontier, distances) continues an earlier call, ``stop`` ends the loop
    at that iteration count (in place of ``max_iterations``), and
    ``return_state`` returns the (iteration, frontier, distances) state."""
    max_it = graph.n_vertices if max_iterations is None else max_iterations
    if edge_budget is None:
        # E/128 (not BFS's E/64): a weighted search revisits vertices, so
        # pushing a larger share re-relaxes more stale edges; hub-ordered
        # graphs E/192 (the JAX package's measured tuning, kept until the
        # card's own is measured)
        div = 192 if graph.properties.hub_ordered else 128
        edge_budget = max(4096, graph.n_edges // div)
    levels = level_graphs("sssp", graph, layout, layout_dense, torch.float32)
    if init_state is None:
        it = 0
        levels.start(single_source, INF)
    else:
        it = init_state[0]
        levels.resume(*init_state)
    steps = {
        "push": lambda f, d, _: sssp_push_step(graph, f, d, edge_budget),
        "step": lambda f, d, _: sssp_step(graph, f, d),
    }
    if layout is not None:
        steps["pull"] = lambda f, d, _: _pull(layout, f, d)
        if layout_dense is not None:
            steps["pull_dense"] = lambda f, d, _: _pull(layout_dense, f, d)
    it = run_levels(graph, levels, steps, it,
                    max_it if stop is None else stop, edge_budget)
    if return_state:
        return it, levels.front.clone(), levels.dist.clone()
    return levels.dist.clone(), it


def sssp_do_slabbed(
    graph: Graph,
    single_source: int,
    rounds_per_dispatch: int = 256,
    layout=None,
):
    """Direction-optimizing SSSP in slabs of ``rounds_per_dispatch``
    rounds: :func:`sssp_kernel_do` resumed from its state until the
    frontier is empty (or V rounds). The JAX package slabs its one compiled
    loop so that no device execution outlasts an RPC deadline; here every
    round already reads the device once, so the slabs only mirror that
    API, with distances equal to :func:`sssp_kernel_do`'s. Returns
    (distances, depth)."""
    state, stop = None, 0
    while True:
        stop += rounds_per_dispatch
        state = sssp_kernel_do(graph, single_source, layout=layout,
                               init_state=state, stop=stop,
                               return_state=True)
        # a slab ends before its stop only when the frontier empties
        if state[0] < stop or state[0] >= graph.n_vertices:
            return state[2], state[0]


def sssp_kernel_delta(
    graph: Graph,
    single_source: int,
    delta=None,
    max_iterations: int | None = None,
    edge_budget: int | None = None,
):
    """Bucketed (delta-stepping style) SSSP: each round relaxes only the
    improved vertices whose tentative distance lies in the current bucket
    ``[0, (k+1)*delta)``; when the bucket settles, k advances. Every
    relaxation is exact (re-improved vertices re-enter). Returns
    (distances f32[V], rounds)."""
    V, E = graph.n_vertices, graph.n_edges
    max_it = 4 * V if max_iterations is None else max_iterations
    if edge_budget is None:
        edge_budget = max(4096, E // 64)
    if delta is None:
        # mean weight * a small multiple: buckets hold a few waves each
        delta = graph.values.mean() * 4.0
    deg = graph.out_degrees()
    dist, improved = _start(graph, single_source)
    k = 0.0
    it = 0
    while it < max_it:
        front = improved & (dist < (k + 1.0) * delta)
        n_improved, n_front, out_edges = host_read(
            "sssp", lambda: torch.stack([improved.sum(), front.sum(),
                                         torch.where(front, deg, 0).sum()]))
        if n_improved == 0:
            break
        if n_front == 0:
            k += 1.0  # bucket settled
        else:
            push = out_edges < edge_budget and n_front < edge_budget
            with annotate("sssp.level", level=it,
                          direction="push" if push else "step",
                          n_front=n_front, out_edges=out_edges):
                if push:
                    new_imp, dist = sssp_push_step(graph, front, dist,
                                                   edge_budget)
                else:
                    new_imp, dist = sssp_step(graph, front, dist)
                improved = improved & ~front | new_imp
        it += 1
    return dist, it


def sssp_kernel_pallas(graph: Graph, single_source: int, layout=None,
                       max_iterations: int | None = None):
    """SSSP through the dense min_plus pass: each wave relaxes all
    in-edges of every vertex against the frontier's distances. Returns
    (distances, depth)."""
    if layout is None:
        layout = pull_layout(graph, pad_value=_BIG)
    max_it = graph.n_vertices if max_iterations is None else max_iterations
    dist, front = _start(graph, single_source)
    it = 0
    while it < max_it and bool(front.any()):
        x = torch.where(front, dist, _BIG)
        relaxed = bucketed_semiring_spmv(layout, x, "min_plus")
        front = relaxed < dist
        dist = torch.minimum(dist, relaxed)
        it += 1
    return dist, it


def recover_predecessors(graph: Graph, distances):
    """One pass over the in-edges: pred[v] = the smallest src with
    dist[src] + w close to dist[v] (``torch.isclose`` at jnp's defaults,
    rtol 1e-5, atol 1e-8) and dist[src] finite; -1 where none (unreached
    vertices and the source). On the card one launch of
    ``csrc/predecessors.cu`` (:func:`sssp_predecessors`) scans each
    vertex's CSC run in ascending order and stops at its first such src,
    the smallest, since sources ascend within a run; on the CPU the plain
    segment min."""
    with annotate("sssp.predecessors"):
        return sssp_predecessors(graph, distances)


class SsspProblem(Problem):
    def __init__(self, graph: Graph, param: Param):
        super().__init__(graph)
        self.param = param

    def reset(self):
        dist, front = _start(self.graph, self.param.single_source)
        return {"distances": dist, "frontier": front}


class SsspEnactor(Enactor):
    def prepare_frontier(self):
        return self.problem.reset()

    def loop(self, state):
        front, dist = sssp_step(self.problem.graph, state["frontier"],
                                state["distances"])
        return {**state, "frontier": front, "distances": dist}

    def finalize(self, state):
        state = dict(state)
        state["predecessors"] = recover_predecessors(
            self.problem.graph, state["distances"])
        return state


def run(
    graph: Graph,
    single_source: int,
    options: Options | None = None,
    warmup: bool = True,
    device=DEFAULT,
) -> Result:
    """Role of reference ``sssp::run``: SSSP from ``single_source`` on
    ``device`` (the graph moves there if it is elsewhere). The strategy
    follows ``options`` as in the JAX package: BUCKETING runs
    delta-stepping; OPTIMIZED runs direction-optimizing SSSP (over the
    ``pad_value=_BIG`` pull layout with PALLAS_MERGE_PATH, the default);
    PALLAS_MERGE_PATH alone runs the dense min_plus pass per wave; anything
    else runs the enactor. Every strategy ends in
    :func:`recover_predecessors`: each vertex's smallest tight
    in-neighbour, found on the card by one launch of
    ``csrc/predecessors.cu`` that stops at the first tight in-neighbour of
    each ascending CSC run."""
    with annotate("sssp.run", sources=1):
        graph = graph.to(device)
        if not 0 <= int(single_source) < graph.n_vertices:
            raise ValueError(
                f"source {single_source} out of range [0, {graph.n_vertices})"
            )
        src = int(single_source)
        if options is None:
            options = default_options()
        pallas = options.load_balance == LoadBalance.PALLAS_MERGE_PATH
        if options.load_balance == LoadBalance.BUCKETING:
            def search():
                return sssp_kernel_delta(graph, src)
        elif options.advance_direction == AdvanceDirection.OPTIMIZED:
            layout = pull_layout(graph, pad_value=_BIG) if pallas else None

            def search():
                return sssp_kernel_do(graph, src, layout=layout)
        elif pallas:
            layout = pull_layout(graph, pad_value=_BIG)

            def search():
                return sssp_kernel_pallas(graph, src, layout=layout)
        else:
            enactor = SsspEnactor(SsspProblem(graph, Param(src)))
            state, elapsed_ms = enactor.enact(warmup=warmup)
            return Result(distances=state["distances"],
                          predecessors=state["predecessors"],
                          search_depth=int(state["iteration"]),
                          elapsed_ms=elapsed_ms)
        with annotate("sssp.search"):
            (dist, depth), elapsed_ms = timed(graph.device, search, warmup)
        return Result(distances=dist,
                      predecessors=recover_predecessors(graph, dist),
                      search_depth=int(depth), elapsed_ms=elapsed_ms)
