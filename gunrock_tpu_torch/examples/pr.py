"""PageRank example CLI (role of reference examples/algorithms/pr/pr.cu).

    python -m gunrock_tpu_torch.examples.pr --market datasets/chesapeake.mtx \\
        --validate [--alpha 0.85 | --alphas 0.8,0.85,0.9] [--tol 1e-6] \\
        [--device cpu] [--devices N]

``--devices N`` runs the vertex-sharded PageRank in N ranks
(``parallel/sharded.py``); it and ``--alphas`` exclude each other.
"""

from __future__ import annotations

import sys

from gunrock_tpu_torch.algorithms import pr
from gunrock_tpu_torch.examples import cpu_reference, runner
from gunrock_tpu_torch.framework.benchmark import dense_workload
from gunrock_tpu_torch.io.parameters import parse


def main(argv=None) -> int:
    params = parse("pr", argv, extra_args=[
        (("--alpha",), dict(type=float, default=0.85)),
        (("--alphas",), dict(
            type=str, default=None,
            help="comma-separated damping sweep (e.g. 0.8,0.85,0.9): all K "
                 "rankings advance together through one [V, K] SpMM")),
        (("--tol",), dict(type=float, default=1e-6)),
    ])
    graph, _ = runner.load(params)
    tol = params.extra.tol
    if params.extra.alphas:
        if params.extra.devices > 1:
            print("Error: --alphas (batched single-chip sweep) and "
                  "--devices are mutually exclusive")
            return 1
        alphas = [float(a) for a in params.extra.alphas.split(",") if a]
        times, batch = [], None
        for _ in range(params.num_runs):
            batch = pr.run_batch(graph, alphas, tol=tol,
                                 options=params.options, device=graph.device)
            times.append(batch.elapsed_ms)
        print(f"{batch.iterations} iterations")
        for k, a in enumerate(alphas):
            runner.print_head(runner.to_original(params, batch.p[:, k]),
                              name=f"rank[alpha={a}]")
        work = dense_workload(graph, batch.iterations)
        runner.finish(params, "pr", graph, times, depths=[batch.iterations],
                      edges_visited=work.edges_visited * len(alphas),
                      nodes_visited=work.vertices_visited)
        if params.validate:
            bad = 0
            for k, a in enumerate(alphas):
                ref = cpu_reference.pr(graph, alpha=a, tol=tol)
                bad += runner.validate(f"pr[alpha={a}]", batch.p[:, k], ref,
                                       atol=1e-4)
            if bad:
                return 1
        return 0

    times, depths, result = [], [], None
    out = runner.maybe_mesh(params, graph, "pagerank", [
        ([], {"alpha": params.extra.alpha, "tol": tol})] * params.num_runs)
    if out is not None:
        times, results = out
        depths = [it for _, it in results]
        p, it = results[-1]
        result = pr.Result(p=p, iterations=it, elapsed_ms=times[-1])
    else:
        for _ in range(params.num_runs):
            result = pr.run(graph, alpha=params.extra.alpha, tol=tol,
                            options=params.options, device=graph.device)
            times.append(result.elapsed_ms)
            depths.append(result.iterations)
    print(f"{result.iterations} iterations")
    runner.print_head(runner.to_original(params, result.p), name="rank")
    work = dense_workload(graph, depths[-1])
    runner.finish(params, "pr", graph, times, depths=depths,
                  edges_visited=work.edges_visited,
                  nodes_visited=work.vertices_visited)
    if params.validate:
        ref = cpu_reference.pr(graph, alpha=params.extra.alpha, tol=tol)
        if runner.validate("pr", result.p, ref, atol=1e-4):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
