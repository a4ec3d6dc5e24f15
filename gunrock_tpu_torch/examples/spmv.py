"""SpMV example CLI (role of reference examples/algorithms/spmv/spmv.cu).

    python -m gunrock_tpu_torch.examples.spmv --market datasets/chesapeake.mtx \\
        --validate [--device cpu] [--devices N]

x is drawn from a seeded generator in input-id space and permuted into
the execution space (the identity without ``--reorder``).
"""

from __future__ import annotations

import sys

import numpy as np

from gunrock_tpu_torch.algorithms import spmv
from gunrock_tpu_torch.examples import cpu_reference, runner
from gunrock_tpu_torch.framework.benchmark import dense_workload
from gunrock_tpu_torch.io.parameters import parse


def main(argv=None) -> int:
    params = parse("spmv", argv)
    graph, _ = runner.load(params)
    rng = np.random.default_rng(0)
    x = runner.to_relabeled(params,
                            rng.random(graph.n_vertices).astype(np.float32))
    times, result = [], None
    out = runner.maybe_mesh(params, graph, "spmv",
                            [([x], {})] * params.num_runs)
    if out is not None:
        times, results = out
        result = spmv.Result(y=results[-1], elapsed_ms=times[-1])
    else:
        for _ in range(params.num_runs):
            result = spmv.run(graph, x, options=params.options,
                              device=graph.device)
            times.append(result.elapsed_ms)
    runner.print_head(runner.to_original(params, result.y), name="y")
    work = dense_workload(graph, 1)
    runner.finish(params, "spmv", graph, times,
                  edges_visited=work.edges_visited,
                  nodes_visited=work.vertices_visited)
    if params.validate:
        if runner.validate("spmv", result.y, cpu_reference.spmv(graph, x)):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
