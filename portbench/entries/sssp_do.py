"""Direction-optimizing SSSP with predecessors: ``algorithms/sssp.run``
with its default options (the SSSP push step, the frontier-sparse
min-plus pull over the valued pull layout, one host read a round), one
source a query."""

from __future__ import annotations

import time

from gunrock_tpu_torch.algorithms import sssp
from gunrock_tpu_torch.ops.kernels.layout import pull_layout
from gunrock_tpu_torch.ops.kernels.semiring import _BIG

KIND = "sssp"
WEIGHTED = True
PREDECESSORS = True  # whether the answer holds a predecessor a vertex


def prepare(prog, params: dict):
    """Build the layout ``run`` takes (cached on the graph under the same
    key ``run`` looks up)."""
    t0 = time.perf_counter()
    pull_layout(prog.graph, pad_value=_BIG)
    return None, {"layout_s": time.perf_counter() - t0}


def query(prog, state, sources):
    (s,) = sources
    res = sssp.run(prog.graph, int(prog.rank[s]), warmup=False,
                  device=prog.graph.device)
    raw = {"dist": prog.to_input_ids(res.distances),
           "pred": prog.preds_to_input_ids(res.predecessors)}
    return raw, res.search_depth


def answer(raw) -> dict:
    return {"dist": raw["dist"], "pred": raw["pred"].long()}
