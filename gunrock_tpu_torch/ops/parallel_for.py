"""parallel_for: elementwise application over frontiers, vertices, edges
(port of ``gunrock_tpu/ops/parallel_for.py``; role of reference
``operators/for/for.hxx``, a ``thrust::for_each``). The function is
applied once to whole tensors and returns its results; it does not
write into captured tensors."""

from __future__ import annotations

from typing import Callable

import torch

from gunrock_tpu_torch.framework.frontier import live_slots
from gunrock_tpu_torch.graph import Graph


def for_each_vertex(graph: Graph, fn: Callable):
    """Apply ``fn(vertex_ids)`` over all vertices (for.hxx:54-66)."""
    v = torch.arange(graph.n_vertices, dtype=torch.int32, device=graph.device)
    return fn(v)


def for_each_edge(graph: Graph, fn: Callable):
    """Apply ``fn(src, dst, edge_id, weight)`` over all edges in CSR order
    (for.hxx:86-105)."""
    e = torch.arange(graph.n_edges, dtype=torch.int32, device=graph.device)
    return fn(graph.edge_src, graph.col_indices, e, graph.values)


def for_each_in_frontier_mask(mask: torch.Tensor, fn: Callable):
    """Apply ``fn(vertex_ids, active_mask)`` over a dense frontier."""
    v = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    return fn(v, mask)


def for_each_in_queue(data: torch.Tensor, count: torch.Tensor, fn: Callable):
    """Apply ``fn(items, live_mask)`` over a padded queue frontier, with
    the invalid and padding slots masked (for.hxx:26-40)."""
    return fn(data, live_slots(data, count))
