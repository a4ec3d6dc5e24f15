"""SpGEMM example CLI (role of reference
examples/algorithms/spgemm/spgemm.cu): computes C = A.A (or A.B with
``--market_b``).

    python -m gunrock_tpu_torch.examples.spgemm \\
        --market datasets/chesapeake.mtx --validate \\
        [--strategy esc|dense|auto] [--market_b B.mtx] [--device cpu] \\
        [--devices N]

``--devices N`` runs the sharded count in N ranks: C's nnz and value
checksum only, which ``--validate`` holds against scipy's product.
"""

from __future__ import annotations

import sys

import scipy.sparse as sp

from gunrock_tpu_torch.algorithms import spgemm
from gunrock_tpu_torch.examples import cpu_reference, runner
from gunrock_tpu_torch.io.loader import load_graph_file
from gunrock_tpu_torch.io.parameters import parse


def main(argv=None) -> int:
    params = parse("spgemm", argv, extra_args=[
        (("--market_b",), dict(default="", help="B matrix (default: A)")),
        (("--strategy",), dict(
            default="esc", choices=("esc", "dense", "auto"),
            help="esc = expand-sort-contract; dense = row-blocked SpMM; "
                 "auto = cost-model pick (GUNROCK_SPGEMM_AUTO_K)")),
    ])
    graph_a, _ = runner.load(params)
    graph_b = (load_graph_file(params.extra.market_b,
                               device=params.device)[0]
               if params.extra.market_b else graph_a)
    out = runner.maybe_mesh(params, graph_a, "spgemm_count",
                            [([graph_b], {})] * params.num_runs)
    if out is not None:
        times, results = out
        nnz, checksum = results[-1]
        print(f"C nnz = {nnz}, value checksum {checksum:.6f} (distributed, "
              "count only)")
        runner.finish(params, "spgemm", graph_a, times)
        if params.validate:
            want = cpu_reference.spgemm(graph_a, graph_b)
            want_sum = float(want.sum())
            ok = nnz == want.count_nonzero() and abs(
                checksum - want_sum) <= 1e-4 * max(1.0, abs(want_sum))
            print(f"spgemm validation: {'PASSED' if ok else 'FAILED'} "
                  f"(cpu nnz {want.count_nonzero()}, checksum {want_sum:.6f})")
            if not ok:
                return 1
        return 0
    times = []
    result = None
    for _ in range(params.num_runs):
        result = spgemm.run(graph_a, graph_b, options=params.options,
                            strategy=params.extra.strategy,
                            device=graph_a.device)
        times.append(result.elapsed_ms)
    print(f"C nnz = {result.nnz}")
    runner.finish(params, "spgemm", graph_a, times)
    if params.validate:
        # entry by entry against scipy's product, both sparse: rtol 1e-3,
        # atol 1e-4 (the f32 sums run in another order)
        C = result.to_csr(graph_a.n_vertices, graph_b.n_vertices)
        got = sp.csr_matrix((C.values, C.col_indices, C.row_offsets),
                            shape=(C.n_rows, C.n_cols))
        n = cpu_reference.spgemm_errors(
            got, cpu_reference.spgemm(graph_a, graph_b), rtol=1e-3, atol=1e-4)
        print("spgemm validation: "
              f"{'PASSED' if n == 0 else f'FAILED ({n} errors)'}")
        if n:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
