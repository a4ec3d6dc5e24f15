"""Label-correcting SSSP by Gauss-Seidel block sweeps:
``experimental/async_sweep.sssp_async``, the whole search one launch of
the ``sweep_min`` kernel and one host read, one source a query.
``params``: ``ordering`` and ``n_blocks``, as the function takes them."""

from __future__ import annotations

import time

from gunrock_tpu_torch.experimental import async_sweep

KIND = "sssp"
WEIGHTED = True
PREDECESSORS = False  # whether the answer holds a predecessor a vertex


def prepare(prog, params: dict):
    """Relabel the graph as ``sssp_async`` would on its first call (RCM,
    cached on the graph), so that the relabeling is timed with the graph
    load (``graph/reorder.py``) and not inside the warm-up query."""
    t0 = time.perf_counter()
    if params.get("ordering", "natural") == "rcm":
        async_sweep._rcm(prog.graph)
    return dict(params), {"build_s": time.perf_counter() - t0}


def query(prog, params, sources):
    (s,) = sources
    dist, _, passes = async_sweep.sssp_async(
        prog.graph, int(prog.rank[s]),
        n_blocks=int(params.get("n_blocks", 32)),
        ordering=params.get("ordering", "natural"))
    return {"dist": prog.to_input_ids(dist)}, passes


def answer(raw) -> dict:
    return {"dist": raw["dist"]}
