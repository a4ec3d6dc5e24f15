"""MST example CLI (role of reference examples/algorithms/mst/mst.cu).

    python -m gunrock_tpu_torch.examples.mst --market datasets/chesapeake.mtx \\
        --validate [--strategy auto|pallas|contract|loop] [--device cpu]
"""

from __future__ import annotations

import sys

from gunrock_tpu_torch.algorithms import mst
from gunrock_tpu_torch.examples import cpu_reference, runner
from gunrock_tpu_torch.io.parameters import parse


def main(argv=None) -> int:
    params = parse("mst", argv, extra_args=[
        (("--strategy",), dict(
            default="auto", choices=("auto", "pallas", "contract", "loop"),
            help="auto/pallas = the min-cut kernel path; contract = "
                 "relabel-and-compact rounds; loop = (weight, id) "
                 "scatter-mins over the fixed edge list")),
    ])
    graph, _ = runner.load(params)
    times, result = [], None
    for _ in range(params.num_runs):
        result = mst.run(graph, options=params.options,
                         strategy=params.extra.strategy, device=graph.device)
        times.append(result.elapsed_ms)
    print(f"mst weight = {result.mst_weight:.6f} "
          f"({result.n_components} component(s), {result.rounds} rounds)")
    runner.finish(params, "mst", graph, times)
    if params.validate:
        want = cpu_reference.mst_weight(graph)
        ok = abs(result.mst_weight - want) <= 1e-5 * max(1.0, abs(want))
        print(f"mst validation: {'PASSED' if ok else 'FAILED'} "
              f"(cpu={want:.6f})")
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
