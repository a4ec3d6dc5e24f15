"""Shared example scaffolding (port of ``gunrock_tpu/examples/runner.py``):
load the graph, map sources, inputs and results through an optional
relabeling, report times and, under ``--export_metrics``, write the run's
stats JSON (``utils/performance``), validate; and for ``--devices N > 1``
run a CLI's sharded branch in N ranks (:func:`maybe_mesh`)."""

from __future__ import annotations

import time

import numpy as np
import torch

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


def timed_runs(n_runs: int, fn, device):
    """Timed loop of the distributed calls: each run is fenced with
    ``torch.cuda.synchronize`` on a card, so that the time covers the
    work and not only its launch. Returns (times_ms, last result)."""
    on_card = torch.device(device).type == "cuda"
    times, out = [], None
    for _ in range(n_runs):
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def maybe_mesh(params: Parameters, graph, algo: str, calls: list):
    """For ``--devices N > 1``: run ``parallel.sharded.<algo>`` in N ranks,
    one process a shard, once for each ``(args, kwargs)`` of ``calls``
    (``algo(sg, *args, mesh, **kwargs)`` on the graph's partition;
    ``tc_ring`` takes the graph itself), each run timed, through the rank
    worker ``probes.mesh.run_cases``; return rank 0's (times_ms, results)
    for this process to print and validate; None for one device. Prints
    the backend and the ranks per card first."""
    n = params.extra.devices
    if n <= 1:
        return None
    from gunrock_tpu_torch.device import resolve
    from gunrock_tpu_torch.parallel.mesh import backend_for, spawn
    from gunrock_tpu_torch.probes.mesh import run_cases

    dev = resolve(params.device)
    backend = backend_for(dev, n)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        where = (f"{-(-n // cards)} rank(s) per card on {min(n, cards)} "
                 f"card(s)")
        if backend == "gloo":
            where += ", collectives staged through the host"
    else:
        where = "on the CPU"
    print(f"distributed: {n} ranks, backend {backend}, {where}")
    cases = [{"algo": algo, "graph": "g", "args": list(args),
              "kwargs": kwargs} for args, kwargs in calls]
    info = spawn(run_cases, n, {"g": graph}, cases, params.device,
                 device=params.device)
    return ([t for c in info["cases"] for t in c["ms"]],
            [c["result"] for c in info["cases"]])
