"""Workload counters (counterpart of ``gunrock_tpu/framework/benchmark.py``).

Role of reference ``benchmark::`` (framework/benchmark.hxx): the edges and
vertices a run visited, for MTEPS and the roofline's byte model, computed
after the run from the arrays it produced (torch tensors on any device, or
numpy) and the graph's host CSR, so the timed run is not perturbed.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):  # a torch tensor, possibly on the card
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class WorkloadStats:
    """Role of the reference's benchmark_t counter struct."""

    edges_visited: int = 0
    vertices_visited: int = 0
    search_depth: int = 0

    def mteps(self, elapsed_ms: float) -> float:
        """MTEPS = edges_visited / time_ms / 1000."""
        return self.edges_visited / elapsed_ms / 1000.0 if elapsed_ms > 0 else 0.0


def frontier_workload(graph, reached_mask, search_depth: int = 0) -> WorkloadStats:
    """Workload of a frontier traversal: every reached vertex's out-edges
    were visited."""
    deg = np.diff(graph.host["row_offsets"])
    reached = _numpy(reached_mask).astype(bool)
    return WorkloadStats(
        edges_visited=int(deg[reached].sum()),
        vertices_visited=int(reached.sum()),
        search_depth=int(search_depth),
    )


def dense_workload(graph, iterations: int) -> WorkloadStats:
    """Workload of a dense (frontier-less) iteration like PageRank: all
    edges touched every iteration."""
    return WorkloadStats(
        edges_visited=int(graph.n_edges) * int(iterations),
        vertices_visited=int(graph.n_vertices),
        search_depth=int(iterations),
    )


def reached_from_distances(distances) -> np.ndarray:
    """Reached mask from a distances vector (int max / +inf = unreached)."""
    d = _numpy(distances)
    if np.issubdtype(d.dtype, np.floating):
        return np.isfinite(d)
    return d != np.iinfo(d.dtype).max
