"""Single-source BFS with predecessors: exact hop distances from the source
to every vertex, and a parent one hop closer for every reached vertex but
the source. The control is the reference stopped one level before its end
(the tempting drop of the last, tiny levels and their host reads)."""

from __future__ import annotations

import torch

from portbench import bytecount, check
from portbench.reference import search


def reference(edges, device) -> search.Csr:
    return search.Csr.from_edges(edges, device)


def check_answer(csr: search.Csr, sources, answer: dict) -> dict:
    (s,) = sources
    ref = search.bfs(csr, s)
    out = {"dist_mismatch": int((answer["dist"] != ref).sum())}
    out.update(check.pred_checks(csr, s, ref, answer["pred"], weighted=False))
    return out


def truncated(csr: search.Csr, s: int) -> torch.Tensor:
    """The reference's hop distances with the last level left unreached."""
    d = search.bfs(csr, s)
    last = int(d.max())
    return torch.where(d == last, -1, d) if last > 0 else d


def control(csr: search.Csr, sources, entry) -> dict:
    (s,) = sources
    d = truncated(csr, s)
    return {"dist": d, "pred": search.bfs_parents(csr, d)}


def work(edges, sources: list, entry) -> tuple[list, list]:
    # a distance and a predecessor a vertex
    return bytecount.search_work(edges, sources, 1, False, 2)
