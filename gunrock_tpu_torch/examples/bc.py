"""BC example CLI (role of reference examples/algorithms/bc/bc.cu).

    python -m gunrock_tpu_torch.examples.bc --market datasets/chesapeake.mtx \\
        --src 0 --validate [--all_sources] [--device cpu]

``--all_sources`` accumulates BC over every source: through the batched
SpMM kernel on the default (kernel) path, through the plain batched sweep
with ``--advance_load_balance xla_segment``.
"""

from __future__ import annotations

import sys

import numpy as np

from gunrock_tpu_torch.algorithms import bc
from gunrock_tpu_torch.examples import cpu_reference, runner
from gunrock_tpu_torch.io.parameters import parse, parse_source_string
from gunrock_tpu_torch.ops.configs import LoadBalance


def main(argv=None) -> int:
    params = parse("bc", argv, extra_args=[
        (("--all_sources",), dict(action="store_true",
                                  help="accumulate BC over every source")),
    ])
    graph, _ = runner.load(params)
    times = []
    if params.extra.all_sources:
        kernels = params.options.load_balance == LoadBalance.PALLAS_MERGE_PATH
        run_all = bc.run_all_sources_spmm if kernels else bc.run_all_sources
        result = run_all(graph, device=graph.device)
        times.append(result.elapsed_ms)
        run_sources = list(range(graph.n_vertices))
        sources = []
    else:
        sources = parse_source_string(params.sources, graph.n_vertices,
                                      params.num_runs)
        run_sources = runner.map_sources(params, sources)
        for src in run_sources:
            result = bc.run(graph, src, options=params.options,
                            device=graph.device)
            times.append(result.elapsed_ms)
        run_sources = run_sources[-1:]
    runner.print_head(runner.to_original(params, result.bc_values), name="bc")
    runner.finish(params, "bc", graph, times, srcs=sources)
    if params.validate:
        # the Brandes oracle of the last source (of every source, summed
        # in float64, under --all_sources)
        ref = sum(cpu_reference.bc(graph, s).astype(np.float64)
                  for s in run_sources)
        if runner.validate("bc", result.bc_values, ref, atol=1e-3):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
