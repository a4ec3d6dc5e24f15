"""PPR example CLI (role of reference examples/algorithms/ppr/ppr.cu).

    python -m gunrock_tpu_torch.examples.ppr --market datasets/chesapeake.mtx \\
        --src 0 --validate [--alpha 0.15] [--epsilon 1e-6] [--device cpu]

Several comma-separated seeds run as one batch (``ppr.run_batch``).
``--devices N`` runs the sharded push from each seed in N ranks.
"""

from __future__ import annotations

import sys

import numpy as np

from gunrock_tpu_torch.algorithms import ppr
from gunrock_tpu_torch.examples import cpu_reference, runner
from gunrock_tpu_torch.io.parameters import parse, parse_source_string


def main(argv=None) -> int:
    params = parse("ppr", argv, extra_args=[
        (("--alpha",), dict(type=float, default=0.15)),
        (("--epsilon",), dict(type=float, default=1e-6)),
    ])
    graph, _ = runner.load(params)
    alpha, epsilon = params.extra.alpha, params.extra.epsilon
    seeds = parse_source_string(params.sources, graph.n_vertices,
                                params.num_runs)
    run_seeds = runner.map_sources(params, seeds)
    times, depths = [], []
    out = runner.maybe_mesh(params, graph, "ppr", [
        ([seed], {"alpha": alpha, "epsilon": epsilon}) for seed in run_seeds])
    if out is not None:
        times, results = out
        depths = [it for _, it in results]
        p = results[-1][0]
        print(f"{depths[-1]} iterations")
        runner.print_head(runner.to_original(params, p), name="p")
        p, run_seeds = p[None], run_seeds[-1:]
    elif len(run_seeds) > 1:
        p, elapsed = ppr.run_batch(graph, run_seeds, alpha=alpha,
                                   epsilon=epsilon, device=graph.device)
        times.append(elapsed)
        runner.print_head(runner.to_original(params, p[0]),
                          name=f"p[seed={seeds[0]}]")
    else:
        result = ppr.run(graph, run_seeds[0], alpha=alpha, epsilon=epsilon,
                         options=params.options, device=graph.device)
        times.append(result.elapsed_ms)
        depths.append(result.iterations)
        print(f"{result.iterations} iterations")
        runner.print_head(runner.to_original(params, result.p), name="p")
        p = result.p[None]
    runner.finish(params, "ppr", graph, times, srcs=seeds, depths=depths)
    if params.validate:
        # every seed's row against the oracle, both in execution (possibly
        # relabeled) ids, within rtol 1e-4 + atol 1e-6
        ref = [cpu_reference.ppr(graph, s, alpha=alpha, epsilon=epsilon)
               for s in run_seeds]
        if runner.validate("ppr", p, np.stack(ref), atol=1e-6):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
