"""The async sweep kernels' inputs at the async path's shapes, and their
bound: one place for ``probes/pull.py --async`` and ``chip_smoke.py``.

``sweep_args`` and ``pr_args`` build ``gs_sweep_min``'s and
``gs_sweep_pr``'s inputs as ``experimental/async_sweep.py`` does;
``kernel_cases`` names the seven searches of the async path (R-MAT SSSP
and BFS from the top-degree vertex, PageRank at tol 1e-7 and 1e-9; the
Delaunay mesh's SSSP in natural and RCM order and its RCM BFS);
``bound_work`` counts the bytes and operations of a run of block passes.
Only the kernels' public calls are used, so the probe copied with this
file into an earlier tree builds that tree's inputs the same way.
"""

from __future__ import annotations

import numpy as np
import torch

ASYNC_BLOCKS = 32  # the async sweep's default block count
MESH_SEED = 3
MESH_POINTS = 2**18  # the async path's mesh: 262,144 points


def top_vertex(graph) -> int:
    """The vertex of most out-edges (the lowest id among ties)."""
    return int(np.argmax(np.diff(graph.host["row_offsets"])))


def sweep_args(graph, source: int, unit: bool, n_blocks: int = ASYNC_BLOCKS,
               max_sweeps=None) -> tuple:
    """gs_sweep_min's inputs for one search from ``source`` (unit weights
    for BFS)."""
    from gunrock_tpu_torch.experimental.async_sweep import _block_plan

    V = graph.n_vertices
    v_starts, e_starts = _block_plan(graph, max(1, min(n_blocks, V)))
    dist0 = torch.full((V,), float("inf"), device=graph.device)
    dist0[source] = 0.0
    values = torch.ones_like(graph.csc_values) if unit else graph.csc_values
    return (graph.csc_rows, values, graph.csc_dst, v_starts, e_starts, dist0,
            2 * V if max_sweeps is None else max_sweeps)


def pr_args(graph, tol: float, n_blocks: int = ASYNC_BLOCKS,
            alpha: float = 0.85, max_sweeps: int = 10_000) -> tuple:
    """gs_sweep_pr's inputs, as ``experimental/async_sweep.pr_async``
    builds them."""
    from gunrock_tpu_torch.algorithms.pr import compute_iweights
    from gunrock_tpu_torch.experimental.async_sweep import _block_plan

    V = graph.n_vertices
    v_starts, e_starts = _block_plan(graph, max(1, min(n_blocks, V)))
    iweights = compute_iweights(graph, 1.0)
    return (graph.csc_rows, graph.csc_values * float(np.float32(alpha)),
            graph.csc_dst, v_starts, e_starts, iweights, iweights == 0.0,
            torch.full((V,), 1.0 / V, device=graph.device), alpha, tol,
            max_sweeps)


def mesh_graphs(device) -> tuple:
    """The async path's Delaunay mesh, and its RCM relabelling with the
    order (``graph.reorder.rcm_sort``)."""
    from gunrock_tpu_torch.graph.reorder import rcm_sort
    from gunrock_tpu_torch.io.generators import delaunay_graph

    mesh = delaunay_graph(MESH_POINTS, seed=MESH_SEED, device=device)
    return mesh, rcm_sort(mesh)


def kernel_cases(graph, mesh, rcm) -> dict:
    """{case: (graph, kernel name, args)} for the seven searches of the
    async path: ``graph`` the R-MAT graph, ``mesh`` the Delaunay mesh and
    ``rcm`` its (relabelled mesh, order)."""
    rmesh, order = rcm
    top, mtop = top_vertex(graph), top_vertex(mesh)
    rtop = int(order.rank[mtop])
    return {
        "rmat18_sssp": (graph, "gs_sweep_min", sweep_args(graph, top, False)),
        "rmat18_bfs": (graph, "gs_sweep_min", sweep_args(graph, top, True)),
        "rmat18_pr_1e-7": (graph, "gs_sweep_pr", pr_args(graph, 1e-7)),
        "rmat18_pr_1e-9": (graph, "gs_sweep_pr", pr_args(graph, 1e-9)),
        "mesh18_sssp_natural": (mesh, "gs_sweep_min",
                                sweep_args(mesh, mtop, False)),
        "mesh18_sssp_rcm": (rmesh, "gs_sweep_min",
                            sweep_args(rmesh, rtop, False)),
        "mesh18_bfs_rcm": (rmesh, "gs_sweep_min", sweep_args(rmesh, rtop, True)),
    }


def bound_work(graph, passes: int, ops_per_edge: int,
               n_blocks: int = ASYNC_BLOCKS) -> tuple:
    """(bytes, operations) of ``passes`` block passes of an edge-balanced
    plan: each pass reads its block's E/n_blocks edges (source, weight,
    destination: 12 B) and its V/n_blocks vertices (two words: 8 B), and
    does ``ops_per_edge`` f32 operations an edge (min-plus 2, PageRank
    3)."""
    E, V = graph.n_edges, graph.n_vertices
    return (passes * (E / n_blocks * 12 + V / n_blocks * 8),
            passes * E / n_blocks * ops_per_edge)
