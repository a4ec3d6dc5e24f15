"""BFS example CLI (role of reference examples/algorithms/bfs/bfs.cu).

    python -m gunrock_tpu_torch.examples.bfs --market datasets/chesapeake.mtx \\
        --src 0 --validate [--reorder degree] [--device cpu]
"""

from __future__ import annotations

import sys

from gunrock_tpu_torch.algorithms import bfs
from gunrock_tpu_torch.examples import cpu_reference, runner
from gunrock_tpu_torch.framework.benchmark import (
    frontier_workload,
    reached_from_distances,
)
from gunrock_tpu_torch.io.parameters import parse, parse_source_string


def main(argv=None) -> int:
    params = parse("bfs", argv)
    graph, _ = runner.load(params)
    sources = parse_source_string(params.sources, graph.n_vertices,
                                  params.num_runs)
    run_sources = runner.map_sources(params, sources)
    times, depths, result = [], [], None
    for src in run_sources:
        result = bfs.run(graph, src, options=params.options,
                         device=graph.device)
        times.append(result.elapsed_ms)
        depths.append(result.search_depth)
    print(f"search depth {result.search_depth}")
    runner.print_head(runner.to_original(params, result.distances),
                      name="distances")
    work = frontier_workload(graph, reached_from_distances(result.distances))
    runner.finish(params, "bfs", graph, times, srcs=sources, depths=depths,
                  edges_visited=work.edges_visited,
                  nodes_visited=work.vertices_visited)
    if params.validate:
        # oracle and result both in execution (possibly relabeled) ids
        ref = cpu_reference.bfs(graph, run_sources[-1])
        if runner.validate("bfs", result.distances, ref):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
