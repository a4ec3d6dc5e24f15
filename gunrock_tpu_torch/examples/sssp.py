"""SSSP example CLI (role of reference examples/algorithms/sssp/sssp.cu).

    python -m gunrock_tpu_torch.examples.sssp --market datasets/chesapeake.mtx \\
        --src 0 --validate [--reorder degree] [--device cpu]

``--mode async`` (the JAX package's Gauss-Seidel sweep,
``experimental/async_sweep.py``) is not ported yet and exits with an
error.
"""

from __future__ import annotations

import sys

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
                 "Gauss-Seidel block sweeps (not ported yet)")),
    ])
    if params.extra.mode == "async":
        print("Error: --mode async is not ported yet (the JAX package's "
              "experimental/async_sweep.py); use --mode bsp")
        return 1
    graph, _ = runner.load(params)
    sources = parse_source_string(params.sources, graph.n_vertices,
                                  params.num_runs)
    run_sources = runner.map_sources(params, sources)
    times, depths, result = [], [], None
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
