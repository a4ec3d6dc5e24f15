"""HITS example CLI (role of reference examples/algorithms/hits/hits.cu).

    python -m gunrock_tpu_torch.examples.hits --market datasets/chesapeake.mtx \\
        --validate [--max_iterations 20] [--device cpu]
"""

from __future__ import annotations

import sys

from gunrock_tpu_torch.algorithms import hits
from gunrock_tpu_torch.examples import cpu_reference, runner
from gunrock_tpu_torch.io.parameters import parse


def main(argv=None) -> int:
    params = parse("hits", argv, extra_args=[
        (("--max_iterations",), dict(type=int, default=20)),
    ])
    graph, _ = runner.load(params)
    times, result = [], None
    for _ in range(params.num_runs):
        result = hits.run(graph, max_iterations=params.extra.max_iterations,
                          options=params.options, device=graph.device)
        times.append(result.elapsed_ms)
    print(f"{result.iterations} iterations")
    runner.print_head(runner.to_original(params, result.auth), name="auth")
    runner.print_head(runner.to_original(params, result.hub), name="hub")
    runner.finish(params, "hits", graph, times, depths=[result.iterations])
    if params.validate:
        ref_auth, ref_hub = cpu_reference.hits(graph, result.iterations)
        bad = runner.validate("hits auth", result.auth, ref_auth, atol=1e-3)
        bad += runner.validate("hits hub", result.hub, ref_hub, atol=1e-3)
        if bad:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
