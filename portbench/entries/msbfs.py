"""Multi-source BFS: ``algorithms/bfs.msbfs_kernel`` over the unit pull
layout, ``batch`` sources a query, one SpMM pass and one host read a
level for all of them."""

from __future__ import annotations

import time

import torch

from gunrock_tpu_torch.algorithms import bfs
from gunrock_tpu_torch.ops.kernels.layout import pull_layout
from gunrock_tpu_torch.utils.limits import UNREACHED

KIND = "msbfs"
WEIGHTED = False
PREDECESSORS = False  # whether the answer holds a predecessor a vertex


def prepare(prog, params: dict):
    t0 = time.perf_counter()
    layout = pull_layout(prog.graph, unit=True)
    return layout, {"layout_s": time.perf_counter() - t0}


def query(prog, layout, sources):
    src = torch.as_tensor(prog.rank[sources], device=prog.graph.device)
    dist, depth = bfs.msbfs_kernel(prog.graph, src, pull_layout=layout)
    return {"dist": prog.to_input_ids(dist)}, depth


def answer(raw) -> dict:
    d = raw["dist"].long()
    return {"dist": torch.where(d == UNREACHED, -1, d)}
