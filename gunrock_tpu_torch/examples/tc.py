"""TC example CLI (role of reference examples/algorithms/tc/tc.cu).

    python -m gunrock_tpu_torch.examples.tc --market datasets/chesapeake.mtx \\
        --validate [-r] [--device cpu] [--devices N]

``--devices N`` runs the ring-rotation sharded count in N ranks.
"""

from __future__ import annotations

import sys

from gunrock_tpu_torch.algorithms import tc
from gunrock_tpu_torch.examples import cpu_reference, runner
from gunrock_tpu_torch.io.parameters import parse


def main(argv=None) -> int:
    params = parse("tc", argv, extra_args=[
        (("-r", "--reduce"), dict(
            action="store_true",
            help="print the single whole-graph triangle count (reference "
                 "tc.cu -r,--reduce; per-vertex counts are always "
                 "computed)")),
    ])
    graph, _ = runner.load(params)
    times = []
    result = None
    out = runner.maybe_mesh(params, graph, "tc_ring",
                            [([], {})] * params.num_runs)
    if out is not None:
        times, results = out
        counts, total = results[-1]
        result = tc.Result(vertex_triangles_count=counts,
                           total_triangles_count=total,
                           n_triangles=total // 3, elapsed_ms=times[-1])
    else:
        for _ in range(params.num_runs):
            result = tc.run(graph, options=params.options,
                            device=graph.device)
            times.append(result.elapsed_ms)
    runner.print_head(
        runner.to_original(params, result.vertex_triangles_count),
        name="triangles")
    if params.extra.reduce:
        print(f"total (3x triangles) = {result.total_triangles_count}; "
              f"distinct triangles = {result.n_triangles}")
    runner.finish(params, "tc", graph, times)
    if params.validate:
        if runner.validate("tc", result.vertex_triangles_count,
                           cpu_reference.tc(graph)):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
