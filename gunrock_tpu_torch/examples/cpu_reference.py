"""Serial CPU reference for ``--validate`` (the BFS oracle of
``gunrock_tpu/examples/cpu_reference.py``), on the graph's host arrays."""

from __future__ import annotations

import numpy as np

from gunrock_tpu_torch.utils.limits import UNREACHED


def bfs(graph, source: int) -> np.ndarray:
    """Hop distances; int32 max where unreachable. Level by level in numpy:
    gather the frontier's out-edges, keep the unvisited targets."""
    offs = graph.host["row_offsets"].astype(np.int64)
    cols = graph.host["col_indices"]
    dist = np.full(graph.n_vertices, UNREACHED, dtype=np.int32)
    dist[source] = 0
    front = np.asarray([source], dtype=np.int64)
    level = 0
    while front.size:
        starts, degs = offs[front], offs[front + 1] - offs[front]
        first = np.cumsum(degs) - degs
        edges = np.repeat(starts - first, degs) + np.arange(degs.sum())
        nbrs = np.unique(cols[edges])
        front = nbrs[dist[nbrs] == UNREACHED]
        level += 1
        dist[front] = level
    return dist
