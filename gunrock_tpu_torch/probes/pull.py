"""Time the semiring pull, B1 (``bucketed_semiring_spmv_sparse``) and B3
(``bucketed_semiring_spmv``), at R-MAT scale 18 (edge factor 16, seed 1,
degree-sorted), and sweep the span length P of the span table.

One JSON line per case, each with the card's name and power limit:

  b1_full    unit plus_times over the unit pull layout (W=2048/C=256), every
             vertex active and in out_mask: DO-BFS's pull on a full frontier
  b1_tenth   the same on a 10% frontier with a 50% out_mask
  b1_empty   the same with no vertex active
  b3_pr      valued plus_times over the W=4096/C=1024 pull layout (PageRank)
  b3_valued  valued plus_times over the W=2048/C=256 pull layout (the floor
             probe's layout, ``probes/v5_floor.py``)
  b3_min     min_plus over the W=2048/C=256 pull layout (the dense SSSP)

with ``ms`` (CUDA events, mean of ``--num_runs`` warm calls), ``device_ms``
(the card's busy time per call) and ``kernels`` (the device microseconds
per call of each kernel the call ran), both from one
``utils/trace_stats.device_profile`` of ``--num_runs`` calls, ``bound_ms``
(real slots only) and,
for the plus_times cases with a full frontier, ``sparse_mm_ms``: one
``torch.sparse.mm`` over the same matrix.

``--sweep 4,8,16,32`` adds one line per P: b3_valued, b3_pr and b1_full with
the table cut at P (``BucketedEdges.with_span_chunks``). On a tree without
a span table the sweep is skipped, so the same file times an earlier
tree's kernels.

Usage: python -m gunrock_tpu_torch.probes.pull [--scale 18] [--num_runs 20]
       [--sweep 4,8,16,32] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from gunrock_tpu_torch.probes import device_label, time_ms


def _n_real(layout) -> int:
    return int((layout.row_local != layout.window).sum())


def _profile(fn, n: int, dev):
    """(the card's busy ms per call, {kernel: device us per call}) of ``n``
    calls of ``fn`` under ``trace_stats.device_profile``; "not measured"
    off the card or where three profiles hold no device events."""
    from gunrock_tpu_torch.device.properties import NOT_MEASURED
    from gunrock_tpu_torch.utils.trace_stats import device_profile

    if dev.type == "cuda":
        for _ in range(3):
            prof = device_profile(lambda: [fn() for _ in range(n)])
            if "busy_us" in prof:
                return prof["busy_us"] / n / 1e3, {
                    k: us / n for k, (us, _) in prof["top_us"].items()}
    return NOT_MEASURED, NOT_MEASURED


def cases(graph, layouts: dict, gen) -> dict:
    """{case: (call, bytes the call must move, operations, library call or
    None)} at the layouts ``unit``, ``valued``, ``pr`` and ``big``."""
    from gunrock_tpu_torch.ops.kernels import semiring

    dev = graph.device
    V = graph.n_vertices
    full = torch.ones(V, dtype=torch.bool, device=dev)
    none = torch.zeros(V, dtype=torch.bool, device=dev)
    tenth = torch.rand(V, device=dev, generator=gen) < 0.1
    half = torch.rand(V, device=dev, generator=gen) < 0.5
    x = torch.rand(V, device=dev, generator=gen)
    xb = torch.where(torch.rand(V, device=dev, generator=gen) < 0.5, x,
                     semiring._BIG)
    A_unit = torch.sparse_csr_tensor(
        graph.csc_offsets.long(), graph.csc_rows.long(),
        torch.ones(graph.n_edges, device=dev), size=(V, V))
    A = torch.sparse_csr_tensor(graph.csc_offsets.long(),
                                graph.csc_rows.long(), graph.csc_values,
                                size=(V, V))
    unit, pr = layouts["unit"], layouts["pr"]
    valued, big = layouts["valued"], layouts["big"]

    def sparse(act, om):
        xa = act.float()
        return lambda: semiring.bucketed_semiring_spmv_sparse(
            unit, xa, act, "plus_times", out_mask=om, unit=True)

    def dense(lay, xv, sr):
        return lambda: semiring.bucketed_semiring_spmv(lay, xv, sr)

    def b1_bytes(lay):  # slots, x, the two masks, y, the chunk metadata
        return 8 * _n_real(lay) + 4 * V + 2 * V + 4 * V + 16 * lay.n_chunks

    def b3_bytes(lay):
        return 12 * _n_real(lay) + 8 * lay.n_chunks + 4 * V + 4 * V

    xf = full.float()
    return {
        "b1_full": (sparse(full, full), b1_bytes(unit), _n_real(unit),
                    lambda: torch.sparse.mm(A_unit, xf[:, None])),
        "b1_tenth": (sparse(tenth, half), None, None, None),
        "b1_empty": (sparse(none, full), None, None, None),
        "b3_pr": (dense(pr, x, "plus_times"), b3_bytes(pr), 2 * _n_real(pr),
                  lambda: torch.sparse.mm(A, x[:, None])),
        "b3_valued": (dense(valued, x, "plus_times"), b3_bytes(valued),
                      2 * _n_real(valued), lambda: torch.sparse.mm(A, x[:, None])),
        "b3_min": (dense(big, xb, "min_plus"), b3_bytes(big), 2 * _n_real(big),
                   None),
    }


def time_case(name: str, case, n: int, dev, **extra) -> dict:
    from gunrock_tpu_torch.utils.roofline import bound_ms

    fn, n_bytes, n_ops, library = case
    row = {"probe": "pull", "case": name, **extra, "ms": time_ms(dev, fn, n)}
    row["device_ms"], row["kernels"] = _profile(fn, n, dev)
    if n_bytes is not None and dev.type == "cuda":  # the card's peaks
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops, device=dev)
    if library is not None:
        row["sparse_mm_ms"] = time_ms(dev, library, n)
    row["device"] = device_label(dev)
    return row


def sweep(graph, layouts: dict, spans: list, n: int, gen) -> list:
    """The sweep's lines (see the module docstring); [] without a span
    table."""
    if not hasattr(layouts["unit"], "with_span_chunks"):
        return []
    rows = []
    for p in spans:
        cut = {k: lay.with_span_chunks(p) for k, lay in layouts.items()}
        cs = cases(graph, cut, gen)
        for name, key in (("b3_valued", "valued"), ("b3_pr", "pr"),
                          ("b1_full", "unit")):
            rows.append(time_case(name, cs[name], n, graph.device,
                                  span_chunks=p, n_spans=cut[key].n_spans))
    return rows


def build_layouts(graph) -> dict:
    from gunrock_tpu_torch.ops.kernels.layout import dense_window_chunk, pull_layout
    from gunrock_tpu_torch.ops.kernels.semiring import _BIG

    dense_w, dense_c = dense_window_chunk(graph.n_vertices) or (2048, 256)
    return {"unit": pull_layout(graph, unit=True), "valued": pull_layout(graph),
            "pr": pull_layout(graph, window=dense_w, chunk=dense_c),
            "big": pull_layout(graph, pad_value=_BIG)}


def main(argv=None) -> int:
    from gunrock_tpu_torch.probes.v5_floor import probe_graph

    p = argparse.ArgumentParser(prog="gunrock_tpu_torch.probes.pull")
    p.add_argument("--scale", type=int, default=18)
    p.add_argument("--num_runs", type=int, default=20)
    p.add_argument("--sweep", default="",
                   help="comma-separated span lengths P to time")
    p.add_argument("--device", default="cuda")
    ns = p.parse_args(argv)
    graph = probe_graph(ns.scale, ns.device)
    layouts = build_layouts(graph)
    gen = torch.Generator(device=graph.device).manual_seed(1)
    for name, case in cases(graph, layouts, gen).items():
        print(json.dumps(time_case(name, case, ns.num_runs, graph.device)),
              flush=True)
    spans = [int(s) for s in ns.sweep.split(",") if s]
    for row in sweep(graph, layouts, spans, ns.num_runs, gen):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
