"""Direction-optimizing BFS with predecessors: ``algorithms/bfs.run`` with
its default options (the push step, the frontier-sparse pull over the
unit pull layout, one host read a level), one source a query."""

from __future__ import annotations

import time

import torch

from gunrock_tpu_torch.algorithms import bfs
from gunrock_tpu_torch.ops.kernels.layout import pull_layout
from gunrock_tpu_torch.utils.limits import UNREACHED

KIND = "bfs"
WEIGHTED = False
PREDECESSORS = True  # whether the answer holds a predecessor a vertex


def prepare(prog, params: dict):
    """Build the layout ``run`` takes (cached on the graph)."""
    t0 = time.perf_counter()
    pull_layout(prog.graph, unit=True)
    return None, {"layout_s": time.perf_counter() - t0}


def query(prog, state, sources):
    (s,) = sources
    res = bfs.run(prog.graph, int(prog.rank[s]), warmup=False,
                  device=prog.graph.device)
    raw = {"dist": prog.to_input_ids(res.distances),
           "pred": prog.preds_to_input_ids(res.predecessors)}
    return raw, res.search_depth


def answer(raw) -> dict:
    d = raw["dist"].long()
    return {"dist": torch.where(d == UNREACHED, -1, d),
            "pred": raw["pred"].long()}
