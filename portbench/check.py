"""The comparison that decides ``correct``: what every kind of answer
shares.

An answer is judged against the plain reference (``portbench/reference``)
by numbers whose limits sit in ``portbench/checks/<cell>.json``. Each
kind of answer (``portbench/kinds/<kind>.py``, named by the entry's
``KIND``) has a ``check``, which gives the readings of one query, and a
``control``: the reference put in the program's place and made to break
what the configuration guarantees. ``portbench/control.py`` reads both
on the chip. Here: the readings of a predecessor tree, which several
kinds share, and how readings merge over queries and meet their limits.

Answers come normalised (see the entries' ``answer``): BFS distances
int64 with -1 for unreached, SSSP distances floating point with +inf for
unreached, predecessors int64 with -1 for the source and unreached.
"""

from __future__ import annotations

import torch

from portbench.reference import search


def pred_checks(csr: search.Csr, source: int, ref: torch.Tensor,
                 pred: torch.Tensor, weighted: bool) -> dict:
    """Is ``pred`` a shortest-path tree of ``ref``? ``pred_invalid``
    counts vertices whose predecessor is not -1 where it must be, or is
    not an in-neighbour that the reference reaches; for BFS also one not
    one level closer. ``pred_gap`` (weighted) is the largest relative gap
    ``(d[p] + w(p, v) - d[v]) / d[v]`` by the reference's distances: 0
    for a tree edge."""
    n = csr.n
    v = torch.arange(n, device=ref.device)
    reached = (ref >= 0) if not weighted else torch.isfinite(ref)
    need = reached & (v != source)
    p = pred.long()
    in_range = (p >= 0) & (p < n)
    pc = p.clamp(0, n - 1)
    is_edge, w = csr.find(pc, v)
    ok = in_range & is_edge
    out = {}
    if weighted:
        d_p = ref[pc]
        ok &= torch.isfinite(d_p)
        gap = (d_p + w - ref) / torch.where(ref > 0, ref, 1.0)
        gap = torch.where(need & ok, gap, 0.0)
        out["pred_gap"] = float(gap.max()) if n else 0.0
    else:
        ok &= ref[pc] + 1 == ref
    bad = (~need & (p != -1)) | (need & ~ok)
    out["pred_invalid"] = int(bad.sum())
    return out


def merge(readings: list[dict]) -> dict:
    """The worst of each reading over the queries checked: counts add up,
    errors and gaps take their largest."""
    out: dict = {}
    for r in readings:
        for k, val in r.items():
            if isinstance(val, int):
                out[k] = out.get(k, 0) + val
            else:
                out[k] = max(out.get(k, 0.0), val)
    return out


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every reading within its limit, {name: {value, limit}}). A reading
    with no limit, or a limit with no reading, fails."""
    table = {}
    ok = set(readings) == set(limits)
    for name in sorted(set(readings) | set(limits)):
        val, lim = readings.get(name), limits.get(name)
        table[name] = {"value": val, "limit": lim}
        if val is None or lim is None or not val <= lim:
            ok = False
    return ok, table
