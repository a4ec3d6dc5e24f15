"""Bucketed SpMV, y = A . x (port of ``gunrock_tpu/ops/pallas/spmv.py``).

SpMV is the dense ``plus_times`` semiring pass over the graph's valued
push layout (rows = sources, cols = destinations), so this module is the
orientation and caching wrapper around
:func:`~gunrock_tpu_torch.ops.kernels.semiring.bucketed_semiring_spmv`,
whose kernel is ``csrc/semiring.cu``.
"""

from __future__ import annotations

import torch

from gunrock_tpu_torch.ops.kernels.layout import BucketedEdges, push_layout
from gunrock_tpu_torch.ops.kernels.semiring import bucketed_semiring_spmv


def bucketed_spmv(layout: BucketedEdges, x: torch.Tensor) -> torch.Tensor:
    """y = A.x from a bucketed edge layout. x: f32[V] -> y: f32[V]. The
    JAX package's name for the plus_times dense pass."""
    return bucketed_semiring_spmv(layout, x, "plus_times")


def spmv(graph, x: torch.Tensor, window: int = 2048,
         chunk: int = 256) -> torch.Tensor:
    """y = A.x over the graph's push layout (cached on the graph); zeros
    for an edgeless graph."""
    if graph.n_edges == 0:
        return torch.zeros(graph.n_vertices, dtype=torch.float32,
                           device=graph.device)
    layout = push_layout(graph, window=window, chunk=chunk)
    return bucketed_semiring_spmv(layout, x, "plus_times")
