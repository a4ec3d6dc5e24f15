"""Multi-source BFS: for each of a query's sources, exact hop distances to
every vertex, one column a source. The control is the reference of each
column stopped one level before its end."""

from __future__ import annotations

import torch

from portbench import bytecount
from portbench.kinds.bfs import reference, truncated  # noqa: F401
from portbench.reference import search


def check_answer(csr: search.Csr, sources, answer: dict) -> dict:
    dist = answer["dist"]
    if dist.shape != (csr.n, len(sources)):
        return {"dist_mismatch": csr.n * len(sources)}
    bad = 0
    for k, s in enumerate(sources):
        bad += int((dist[:, k] != search.bfs(csr, s)).sum())
    return {"dist_mismatch": bad}


def control(csr: search.Csr, sources, entry) -> dict:
    return {"dist": torch.stack([truncated(csr, s) for s in sources], dim=1)}


def work(edges, sources: list, entry) -> tuple[list, list]:
    # one distance a vertex for each of the batch's searches
    k = len(sources[0]) if sources else 1
    return bytecount.search_work(edges, sources, k, False, 1)
