"""Coloring example CLI (role of reference examples/algorithms/color/color.cu).

    python -m gunrock_tpu_torch.examples.color --market datasets/chesapeake.mtx \\
        --validate [--strategy auto|luby|rank|greedy] [--device cpu]
"""

from __future__ import annotations

import sys

from gunrock_tpu_torch.algorithms import color
from gunrock_tpu_torch.examples import cpu_reference, runner
from gunrock_tpu_torch.io.parameters import parse
from gunrock_tpu_torch.utils.compare import to_numpy


def main(argv=None) -> int:
    params = parse("color", argv, extra_args=[
        (("--strategy",), dict(
            default="auto", choices=("auto", "luby", "rank", "greedy"),
            help="auto = greedy on the kernel path, luby on the plain path; "
                 "luby = reference-parity 2 colors per round; rank = "
                 "multi-color rank Jones-Plassmann; greedy = speculative "
                 "windowed-mex (deterministic)")),
    ])
    graph, _ = runner.load(params)
    times, result = [], None
    for i in range(params.num_runs):
        result = color.run(graph, seed=i, options=params.options,
                           strategy=params.extra.strategy,
                           device=graph.device)
        times.append(result.elapsed_ms)
    colors = to_numpy(result.colors)
    runner.print_head(runner.to_original(params, colors), name="colors")
    print(f"colors used: {int(colors.max()) + 1}, "
          f"{result.iterations} iterations")
    runner.finish(params, "color", graph, times)
    if params.validate:
        ok = cpu_reference.color_is_valid(graph, colors)
        print(f"color validation: {'PASSED' if ok else 'FAILED'}")
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
