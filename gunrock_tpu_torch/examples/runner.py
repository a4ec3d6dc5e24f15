"""Shared example scaffolding (the part of
``gunrock_tpu/examples/runner.py`` the port's CLIs use): load the graph,
map sources, inputs and results through an optional relabeling, report
times and, under ``--export_metrics``, write the run's stats JSON
(``utils/performance``), validate."""

from __future__ import annotations

import numpy as np

from gunrock_tpu_torch.io.loader import extract_filename, load_graph_file
from gunrock_tpu_torch.io.parameters import Parameters
from gunrock_tpu_torch.utils.compare import compare, to_numpy
from gunrock_tpu_torch.utils.performance import export_performance_stats


def print_head(arr, k: int = 10, name: str = "result"):
    print(f"{name}[:{k}] = {to_numpy(arr)[:k]}")


def load(params: Parameters):
    graph, props = load_graph_file(params.filename, device=params.device)
    print(
        f"Loaded {extract_filename(params.filename)}: "
        f"{graph.n_vertices} vertices, {graph.n_edges} edges "
        f"({'symmetric' if props.symmetric else 'directed'}) on {graph.device}"
    )
    if params.reorder == "degree":
        from gunrock_tpu_torch.graph.reorder import degree_sort

        graph, params.reordering = degree_sort(graph)
        print("Relabeled vertices hub-first (--reorder degree); "
              "results map back to input ids")
    return graph, props


def map_sources(params: Parameters, sources: list[int]) -> list[int]:
    """Input-space source ids -> execution (relabeled) ids."""
    ro = params.reordering
    if ro is None:
        return sources
    return [int(ro.rank[s]) for s in sources]


def to_relabeled(params: Parameters, arr) -> np.ndarray:
    """Per-vertex *input* (an x vector) from input ids into execution
    space."""
    ro = params.reordering
    return arr if ro is None else np.asarray(arr)[ro.order]


def to_original(params: Parameters, arr) -> np.ndarray:
    """Per-vertex result from execution space back to input ids."""
    a = to_numpy(arr)
    ro = params.reordering
    return a if ro is None else a[ro.rank]


def finish(
    params: Parameters,
    primitive: str,
    graph,
    times_ms: list[float],
    srcs=None,
    depths=None,
    edges_visited: int = 0,
    nodes_visited: int = 0,
):
    """Print the mean time and, under ``--export_metrics``, write the
    stats JSON of the run (sources in input ids, depths, the workload from
    ``framework.benchmark``)."""
    avg = float(np.mean(times_ms)) if times_ms else 0.0
    print(f"{primitive} : {avg:.4f} ms avg over {len(times_ms)} run(s)")
    if params.export_metrics:
        path = export_performance_stats(
            primitive=primitive,
            process_times_ms=times_ms,
            graph_file=params.filename,
            num_vertices=graph.n_vertices,
            num_edges=graph.n_edges,
            srcs=srcs or [],
            search_depths=depths or [],
            edges_visited=edges_visited,
            nodes_visited=nodes_visited,
            tags=params.tags,
            json_dir=params.json_dir,
            json_file=params.json_file,
            device=graph.device,
        )
        print(f"metrics written to {path}")


def validate(name: str, computed, reference, **kw) -> int:
    n = compare(computed, reference, verbose=True, **kw)
    if n == 0:
        print(f"{name} validation: PASSED")
    else:
        print(f"{name} validation: FAILED ({n} errors)")
    return n
