"""neighbor_reduce: a reduction over each vertex's neighbourhood (port of
``gunrock_tpu/ops/neighbor_reduce.py``; role of reference
``operators/neighborreduce/neighborreduce.hxx:53-82``).

``neighbor_reduce(G, edge_op, reduce)`` computes, for every vertex ``u``,
the ``reduce`` over its out-edges ``(u, v)`` of ``edge_op(u, v, e, w)``
(CSR order); ``direction='in'`` reduces over in-edges (CSC order).
``active`` (bool, in the chosen order) masks edges to the identity.
"""

from __future__ import annotations

from typing import Callable

import torch

from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.segment import segment_reduce
from gunrock_tpu_torch.utils.limits import reduce_identity


def neighbor_reduce(
    graph: Graph,
    edge_op: Callable,
    reduce: str = "sum",
    direction: str = "out",
    active=None,
):
    if direction == "out":
        src, dst, w = graph.edge_src, graph.col_indices, graph.values
        eid = torch.arange(graph.n_edges, dtype=torch.int32,
                           device=graph.device)
        seg = src
    elif direction == "in":
        src, dst, w = graph.csc_rows, graph.csc_dst, graph.csc_values
        eid = graph.csc_edge_perm
        seg = dst
    else:
        raise ValueError(f"unknown direction {direction!r}")

    values = edge_op(src, dst, eid, w)
    if active is not None:
        ident = reduce_identity(values.dtype, reduce, values.device)
        values = torch.where(active, values, ident)
    return segment_reduce(values, seg, graph.n_vertices, reduce)
