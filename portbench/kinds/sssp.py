"""Single-source shortest paths: float32 distances from the source to every
vertex within a relative error of the float64 reference's, the same
vertices reached, and, where the entry gives them (``PREDECESSORS``), a
parent for every reached vertex but the source whose distance plus the
edge's weight is the vertex's. The control is the reference with every
distance and sum in bfloat16, the precision below the configuration's
float32."""

from __future__ import annotations

import torch

from portbench import bytecount, check
from portbench.reference import search


def reference(edges, device) -> search.Csr:
    return search.Csr.from_edges(edges, device)


def check_answer(csr: search.Csr, sources, answer: dict) -> dict:
    (s,) = sources
    ref = search.bellman_ford(csr, s)
    d = answer["dist"].double()
    fin_r, fin_p = torch.isfinite(ref), torch.isfinite(d)
    both = fin_r & fin_p
    rel = (d - ref).abs() / torch.where(ref > 0, ref, 1.0)
    out = {
        "reach_mismatch": int((fin_r != fin_p).sum()),
        "dist_rel_err": float(torch.where(both, rel, 0.0).max()),
    }
    if "pred" in answer:
        out.update(check.pred_checks(csr, s, ref, answer["pred"],
                                     weighted=True))
    return out


def control(csr: search.Csr, sources, entry) -> dict:
    (s,) = sources
    d = search.bellman_ford(csr, s, dtype=torch.bfloat16)
    out = {"dist": d.float()}
    if entry.PREDECESSORS:
        out["pred"] = search.sssp_parents(csr, d)
    return out


def work(edges, sources: list, entry) -> tuple[list, list]:
    words = 1 + int(entry.PREDECESSORS)  # a distance, a predecessor
    return bytecount.search_work(edges, sources, 1, True, words)
