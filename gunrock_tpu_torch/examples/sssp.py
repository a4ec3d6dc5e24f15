"""SSSP example CLI (role of reference examples/algorithms/sssp/sssp.cu).

    python -m gunrock_tpu_torch.examples.sssp --market datasets/chesapeake.mtx \\
        --src 0 --validate [--reorder degree] [--device cpu]

``--mode async`` runs the Gauss-Seidel block sweeps
(``experimental/async_sweep.py``; ``--ordering rcm`` relabels for
near-monotone paths) instead of the level/bucket-synchronous search.
``--devices N`` runs the vertex-sharded Bellman-Ford in N ranks
(``parallel/sharded.py``).
"""

from __future__ import annotations

import sys
import time

from gunrock_tpu_torch.algorithms import sssp
from gunrock_tpu_torch.examples import cpu_reference, runner
from gunrock_tpu_torch.framework.benchmark import (
    frontier_workload,
    reached_from_distances,
)
from gunrock_tpu_torch.io.parameters import parse, parse_source_string
from gunrock_tpu_torch.utils.compare import to_numpy


def main(argv=None) -> int:
    params = parse("sssp", argv, extra_args=[
        (("--mode",), dict(
            default="bsp", choices=("bsp", "async"),
            help="bsp = level/bucket-synchronous (default); async = "
                 "Gauss-Seidel block sweeps (reference experimental "
                 "async runtime role — experimental/async_sweep.py)")),
        (("--ordering",), dict(
            default="natural", choices=("natural", "rcm"),
            help="async mode only: rcm relabels for near-monotone "
                 "paths (best on meshes/roads)")),
    ])
    graph, _ = runner.load(params)
    sources = parse_source_string(params.sources, graph.n_vertices,
                                  params.num_runs)
    run_sources = runner.map_sources(params, sources)
    if params.extra.devices > 1 and params.extra.mode == "async":
        print("Error: --mode async is single-chip; drop --devices")
        return 1
    times, depths, result = [], [], None
    out = runner.maybe_mesh(params, graph, "sssp",
                            [([src], {}) for src in run_sources])
    if out is not None:
        times, results = out
        depths = [depth for _, depth in results]
        result = sssp.Result(distances=results[-1][0], predecessors=None,
                             search_depth=depths[-1], elapsed_ms=times[-1])
    elif params.extra.mode == "async":
        from gunrock_tpu_torch.experimental.async_sweep import sssp_async

        for src in run_sources:
            t0 = time.perf_counter()
            distances, sweeps, passes = sssp_async(
                graph, src, ordering=params.extra.ordering)
            times.append((time.perf_counter() - t0) * 1e3)
            depths.append(sweeps)
        print(f"async: {sweeps} sweeps, {passes} block passes")
        result = sssp.Result(distances=distances, predecessors=None,
                             search_depth=depths[-1], elapsed_ms=times[-1])
    else:
        for src in run_sources:
            result = sssp.run(graph, src, options=params.options,
                              device=graph.device)
            times.append(result.elapsed_ms)
            depths.append(result.search_depth)
    dist = to_numpy(result.distances)
    work = frontier_workload(graph, reached_from_distances(dist))
    print(f"search depth {result.search_depth}, "
          f"{work.edges_visited} edges visited")
    runner.print_head(runner.to_original(params, dist), name="distances")
    runner.finish(params, "sssp", graph, times, srcs=sources, depths=depths,
                  edges_visited=work.edges_visited,
                  nodes_visited=work.vertices_visited)
    if params.validate:
        # oracle and result both in execution (possibly relabeled) ids
        ref = cpu_reference.sssp(graph, run_sources[-1])
        if runner.validate("sssp", dist, ref):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
