"""Vertex relabelings: degree-sorted (hub clustering) and reverse
Cuthill-McKee (bandwidth).

Copy of ``gunrock_tpu/graph/reorder.py``. Relabeling vertices by
descending (in + out) degree concentrates a power-law graph's edges into
few (row window, col window) buckets, so the bucketed layout holds fewer,
fuller chunks. RCM makes shortest paths on meshes nearly monotone in id
space, which the Gauss-Seidel sweeps of ``experimental/async_sweep.py``
need. Relabel once, run in relabeled space, map results back with one
gather:

    rg, ro = degree_sort(graph)
    dist2, it = bfs_kernel_do(rg, int(ro.rank[src]), layout=...)
    dist = dist2[ro.rank]          # dist[v] = dist2[rank[v]]

Each relabeling is a span (``utils/profiler.py``), ``graph.degree_sort``
or ``graph.rcm``, with the ``graph.build`` of the relabeled graph inside.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gunrock_tpu_torch.formats import Coo
from gunrock_tpu_torch.graph.build import build_graph
from gunrock_tpu_torch.graph.graph import Graph
from gunrock_tpu_torch.utils.profiler import annotate


@dataclasses.dataclass(frozen=True)
class Reordering:
    order: np.ndarray  # int32[V] — order[new_id] = old_id (hubs first)
    rank: np.ndarray  # int32[V] — rank[old_id] = new_id


def degree_sort(graph: Graph) -> tuple[Graph, Reordering]:
    """Relabel vertices by descending (in + out) degree, on the graph's
    device. The relabeled graph carries ``hub_ordered=True``, which picks
    the direction-optimizing BFS's smaller push budget."""
    h = graph.host
    V = graph.n_vertices
    with annotate("graph.degree_sort", vertices=V, slots=graph.n_edges):
        out_deg = np.diff(h["row_offsets"])
        in_deg = np.bincount(h["col_indices"], minlength=V)
        order = np.argsort(-(out_deg + in_deg), kind="stable").astype(np.int32)
        rank = np.empty(V, np.int32)
        rank[order] = np.arange(V, dtype=np.int32)
        g2 = build_graph(
            Coo(
                n_rows=V,
                n_cols=V,
                row_indices=rank[h["edge_src"]],
                col_indices=rank[h["col_indices"]],
                values=h["values"],
            ),
            properties=dataclasses.replace(graph.properties, hub_ordered=True),
            device=graph.device,
        )
    return g2, Reordering(order=order, rank=rank)


def rcm_sort(graph: Graph) -> tuple[Graph, Reordering]:
    """Reverse-Cuthill-McKee relabeling (scipy's, on ``graph.host``), on
    the graph's device: a bandwidth-minimizing BFS-level order, the
    locality counterpart of :func:`degree_sort` for the Gauss-Seidel sweep
    solver, whose within-sweep freshness only propagates along monotone id
    paths. Same relabel/map-back contract as :func:`degree_sort`; the
    properties carry over."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    h = graph.host
    V = graph.n_vertices
    with annotate("graph.rcm", vertices=V, slots=graph.n_edges):
        cols = h["col_indices"]
        A = sp.csr_matrix(
            (np.ones(len(cols), np.float32), cols, h["row_offsets"]),
            shape=(V, V)
        )
        order = np.asarray(
            csg.reverse_cuthill_mckee(
                A, symmetric_mode=graph.properties.symmetric),
            np.int32,
        )
        rank = np.empty(V, np.int32)
        rank[order] = np.arange(V, dtype=np.int32)
        g2 = build_graph(
            Coo(n_rows=V, n_cols=V, row_indices=rank[h["edge_src"]],
                col_indices=rank[cols], values=h["values"]),
            properties=graph.properties,
            device=graph.device,
        )
    return g2, Reordering(order=order, rank=rank)
