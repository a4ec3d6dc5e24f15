"""K-core example CLI (role of reference examples/algorithms/kcore/kcore.cu).

    python -m gunrock_tpu_torch.examples.kcore --market datasets/chesapeake.mtx \\
        --validate [--device cpu] [--devices N]
"""

from __future__ import annotations

import sys

from gunrock_tpu_torch.algorithms import kcore
from gunrock_tpu_torch.examples import cpu_reference, runner
from gunrock_tpu_torch.io.parameters import parse


def main(argv=None) -> int:
    params = parse("kcore", argv)
    graph, _ = runner.load(params)
    times, result = [], None
    out = runner.maybe_mesh(params, graph, "kcore",
                            [([], {})] * params.num_runs)
    if out is not None:
        times, results = out
        cores, degen = results[-1]
        result = kcore.Result(k_cores=cores, degeneracy=degen,
                              elapsed_ms=times[-1])
    else:
        for _ in range(params.num_runs):
            result = kcore.run(graph, options=params.options,
                               device=graph.device)
            times.append(result.elapsed_ms)
    runner.print_head(runner.to_original(params, result.k_cores),
                      name="k_cores")
    print(f"degeneracy = {result.degeneracy}, {result.rounds} rounds")
    runner.finish(params, "kcore", graph, times)
    if params.validate:
        if runner.validate("kcore", result.k_cores,
                           cpu_reference.kcore(graph)):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
