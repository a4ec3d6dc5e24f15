"""Asynchronous-semantics label correcting by Gauss-Seidel block sweeps.

Port of ``gunrock_tpu/experimental/async_sweep.py``. Vertices fall into
``n_blocks`` contiguous blocks, cut so that each holds about E/n_blocks
in-edges (fixed vertex blocks would put a power-law hub's whole in-edge
list into one). A sweep relaxes the blocks one after another, forward on
even sweeps and backward on odd ones, each block reading the values that
earlier blocks of the same sweep already updated, and each repeated to
its local fixed point. The sweep count is bounded by direction reversals
on shortest paths, not by the diameter: a 64x64 grid's BFS takes a few
sweeps against 126 BSP levels.

The sweeps are ``ops/kernels/async_sweep.py``'s kernels: on the card the
whole multi-sweep loop of a search is one launch, and the host reads the
counts once, at the end, as the JAX package's one ``lax.while_loop``
does.

Spans (``utils/profiler.py``): ``async.sssp`` a call of :func:`sssp_async`
(``async.bfs`` of :func:`bfs_async`), with the kernel's
``kernel.gs_sweep_min`` and its one read, ``async.sync``, inside it.
"""

from __future__ import annotations

import numpy as np
import torch

from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.kernels.async_sweep import gs_sweep_min, gs_sweep_pr
from gunrock_tpu_torch.utils.limits import UNREACHED
from gunrock_tpu_torch.utils.profiler import annotate


def _block_plan(graph: Graph, n_blocks: int):
    """Edge-balanced contiguous vertex blocks, cut on the host from
    ``graph.host["csc_offsets"]``: (v_starts int32[n_blocks+1], e_starts
    int32[n_blocks]) on the graph's device."""
    V = graph.n_vertices
    E = graph.n_edges
    csc_off = graph.host["csc_offsets"]
    targets = (np.arange(1, n_blocks) * (E / n_blocks)).astype(np.int64)
    cuts = np.searchsorted(csc_off, targets, side="left").astype(np.int64)
    v_starts = np.concatenate([[0], cuts, [V]])
    # monotone boundaries (tiny graphs can produce equal cuts)
    v_starts = np.maximum.accumulate(v_starts)
    e_starts = csc_off[v_starts[:-1]]
    dev = graph.device
    return (torch.from_numpy(v_starts.astype(np.int32)).to(dev),
            torch.from_numpy(e_starts.astype(np.int32)).to(dev))


def _rcm(graph: Graph):
    """(relabeled graph, its rank as a device tensor, the Reordering),
    cached on ``graph.layouts`` for the life of the graph."""
    key = ("rcm",)
    if key not in graph.layouts:
        from gunrock_tpu_torch.graph.reorder import rcm_sort

        rg, ro = rcm_sort(graph)
        graph.layouts[key] = (rg, torch.from_numpy(ro.rank).to(graph.device),
                              ro)
    return graph.layouts[key]


def _run(graph: Graph, single_source: int, n_blocks: int, max_sweeps,
         unit: bool, ordering: str):
    V = graph.n_vertices
    n_blocks = max(1, min(n_blocks, V))
    if not (0 <= single_source < V):
        raise ValueError(f"source {single_source} out of range [0, {V})")
    with annotate("async.bfs" if unit else "async.sssp", sources=1):
        rank = None
        if ordering == "rcm":
            graph, rank, ro = _rcm(graph)
            single_source = int(ro.rank[single_source])
        elif ordering != "natural":
            raise ValueError(f"unknown ordering {ordering!r}")
        values = (torch.ones_like(graph.csc_values) if unit
                  else graph.csc_values)
        v_starts, e_starts = _block_plan(graph, n_blocks)
        dist0 = torch.full((V,), float("inf"), dtype=torch.float32,
                           device=graph.device)
        dist0[single_source] = 0.0
        max_sweeps = 2 * V if max_sweeps is None else max_sweeps
        dist, sweeps, passes = gs_sweep_min(
            graph.csc_rows, values, graph.csc_dst, v_starts, e_starts, dist0,
            max_sweeps)
        if rank is not None:
            dist = dist[rank.long()]  # back to input vertex ids
    return dist, sweeps, passes


def sssp_async(
    graph: Graph,
    single_source: int,
    n_blocks: int = 32,
    max_sweeps: int | None = None,
    ordering: str = "natural",
):
    """Label-correcting SSSP with Gauss-Seidel block sweeps, on the
    graph's device. Returns (distances f32[V], sweeps, block_passes): a
    sweep visits every block once (forward or backward order);
    ``block_passes`` counts the blocks' inner relaxations, the total-work
    metric comparable to the BSP kernels' level count (each touches about
    E/n_blocks edges). ``ordering="rcm"`` relabels (cached per graph) so
    that shortest paths are near-monotone in id space."""
    return _run(graph, single_source, n_blocks, max_sweeps, False, ordering)


def bfs_async(
    graph: Graph,
    single_source: int,
    n_blocks: int = 32,
    max_sweeps: int | None = None,
    ordering: str = "natural",
):
    """Label-correcting BFS (unit weights through the same sweeps).
    Returns (depth int32[V], sweeps, block_passes); unreached = int32
    max."""
    dist, sweeps, passes = _run(graph, single_source, n_blocks, max_sweeps,
                                True, ordering)
    depth = torch.where(torch.isinf(dist), UNREACHED, dist.to(torch.int32))
    return depth, sweeps, passes


def pr_async(
    graph: Graph,
    alpha: float = 0.85,
    tol: float = 1e-6,
    n_blocks: int = 32,
    max_sweeps: int = 10_000,
):
    """Gauss-Seidel PageRank (async-semantics sweeps). Returns (p f32[V],
    sweeps): the same fixed point as ``algorithms/pr.run`` in fewer passes
    over E (freshness within a sweep)."""
    from gunrock_tpu_torch.algorithms.pr import compute_iweights

    V = graph.n_vertices
    n_blocks = max(1, min(n_blocks, V))
    v_starts, e_starts = _block_plan(graph, n_blocks)
    # 1/out_wsum per vertex; alpha is folded into the edge weights below
    iweights = compute_iweights(graph, 1.0)
    dangling = iweights == 0.0
    p0 = torch.full((V,), 1.0 / V, dtype=torch.float32, device=graph.device)
    return gs_sweep_pr(
        graph.csc_rows, graph.csc_values * float(np.float32(alpha)),
        graph.csc_dst, v_starts, e_starts, iweights, dangling, p0, alpha,
        tol, max_sweeps)
