"""Distributed graph algorithms: the public entry points.

The suite lives in :mod:`gunrock_tpu_torch.parallel.sharded`; this module
re-exports it (port of ``gunrock_tpu/parallel/algorithms.py``) and carries
triangle counting's two distributed forms.
"""

from __future__ import annotations

import numpy as np
import torch

from gunrock_tpu_torch.parallel import collectives as C
from gunrock_tpu_torch.parallel.sharded import (  # noqa: F401
    UNREACHED,
    ShardedGraph,
    bc,
    bfs,
    build_sharded_layouts,
    collective_bytes_detail,
    collective_bytes_per_exchange,
    color,
    color_greedy,
    geo,
    hits,
    kcore,
    mst,
    pagerank,
    partition_sharded,
    ppr,
    spgemm_count,
    spmv,
    sssp,
    tc_ring,
)


def tc(graph, mesh):
    """Distributed triangle counting: the ring-rotation sharded-DAG kernel
    (``sharded.tc_ring``), 2E/n adjacency a rank and nothing replicated.
    Returns (vertex counts int32[V], total)."""
    return tc_ring(graph, mesh)


def tc_replicated(graph, mesh):
    """The first distributed TC, kept for A/B comparison: the DAG edges
    split over the ranks, the DAG adjacency replicated on each (compute
    scales, memory does not). Returns (counts int32[V], total)."""
    from gunrock_tpu_torch.algorithms.tc import (build_dag, probe_chunk,
                                                 tc_kernel)

    dag_offsets, dag_adj, edge_u, edge_v, _ = build_dag(graph)
    per = -(-max(edge_u.size, 1) // mesh.size)
    mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
    D = max(int(np.diff(dag_offsets).max(initial=0)), 1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)

    counts = tc_kernel(graph.n_vertices, t(dag_offsets), t(dag_adj),
                       t(edge_u[mine]), t(edge_v[mine]), D, probe_chunk(D))
    counts = C.psum(counts, mesh)
    return counts, int(counts.sum())
