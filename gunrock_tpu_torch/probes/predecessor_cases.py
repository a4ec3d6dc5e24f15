"""The predecessor kernel's inputs (``csrc/predecessors.cu``), in one
place for ``chip_smoke.py``, ``probes/pull.py --predecessors`` and the
tests (``tests/test_torch_predecessors.py``,
``tests/test_torch_predecessors_card.py``): :func:`cases`, graphs and
distances that drive every path of the kernel, and :func:`bound_bytes`,
the bytes a pass must move.

:func:`cases` maps a name to ``(graph, kind, distances)``, ``kind`` being
"bfs" or "sssp":

  hub_mid.bfs, hub_mid.sssp  an undirected R-MAT graph (scale 14) with a
      planted hub of HUB_LEAVES neighbours, past the kernel's block
      threshold, degree-sorted: the hub is vertex 0. The search starts at
      the hub's in-neighbour in the middle of its run, so the hub's one
      tight in-neighbour (BFS) sits mid-run.
  directed.bfs, directed.sssp  a directed R-MAT graph (scale 10) in its
      natural order: its CSC is not its CSR.
  unreached.bfs, unreached.sssp  two R-MAT components and isolated
      vertices; the search reaches one component.
  ties.sssp  integer weights 1-3: many in-neighbours exactly tight.
  tolerance.sssp  a bipartite directed graph, sources (even ids) to
      targets (odd ids), runs of 1 to TOLERANCE_HUB slots; each target's
      distance sits 0-3 float32 steps inside or outside ``torch.isclose``'s
      tolerance (rtol 1e-5, atol 1e-8) of one in-edge, or on it exactly;
      some distances are infinite.

Distances come from the port's plain searches (``bfs.bfs_kernel``,
``sssp.sssp_kernel``) on ``device``, except the crafted ones.
"""

from __future__ import annotations

import numpy as np
import torch

from gunrock_tpu_torch.formats import Coo
from gunrock_tpu_torch.graph import build_graph
from gunrock_tpu_torch.graph.properties import GraphProperties
from gunrock_tpu_torch.graph.reorder import degree_sort
from gunrock_tpu_torch.io.generators import rmat_coo

HUB_LEAVES = 10_000  # the planted hub's run: past the block threshold (2048)
# and past one block round (4096 slots), with the source in the second
TOLERANCE_HUB = 2600  # the tolerance graph's longest run
RTOL, ATOL = 1e-5, 1e-8  # torch.isclose's defaults, as the pass uses them


def _undirected(u, v, w, n: int, device):
    """The symmetric graph of the pairs (u, v) with weights w: self loops
    and repeated pairs dropped (the first weight kept), each pair both
    ways with one weight."""
    a, b = np.minimum(u, v), np.maximum(u, v)
    keep = a != b
    a, b, w = a[keep], b[keep], w[keep]
    _, first = np.unique(a.astype(np.int64) * n + b, return_index=True)
    a, b, w = a[first], b[first], w[first]
    props = GraphProperties(directed=False, weighted=True, symmetric=True)
    coo = Coo(n, n, np.concatenate([a, b]).astype(np.int32),
              np.concatenate([b, a]).astype(np.int32),
              np.concatenate([w, w]).astype(np.float32))
    return build_graph(coo, props, device)


def _pairs(coo, rng, integer: bool = False):
    """The pairs u < v of a symmetric COO, with fresh weights."""
    r, c = coo.row_indices, coo.col_indices
    keep = r < c
    w = (rng.integers(1, 4, keep.sum()).astype(np.float32) if integer
         else rng.random(keep.sum(), dtype=np.float32) + 0.1)
    return r[keep], c[keep], w


def _distances(graph, kind: str, source: int):
    from gunrock_tpu_torch.algorithms import bfs, sssp

    if kind == "bfs":
        return bfs.bfs_kernel(graph, source, compute_predecessors=False)[0]
    return sssp.sssp_kernel(graph, source)[0]


def _top(graph) -> int:
    return int(np.argmax(np.diff(graph.host["row_offsets"])))


def hub_graph(device):
    """(graph, source) of the hub_mid cases."""
    rng = np.random.default_rng(11)
    n = 1 << 14
    u, v, w = _pairs(rmat_coo(14, 8, seed=5, undirected=True), rng)
    leaves = rng.choice(np.arange(1, n), HUB_LEAVES, replace=False)
    hub = np.zeros(HUB_LEAVES, np.int64)
    g = _undirected(np.concatenate([u, hub]), np.concatenate([v, leaves]),
                    np.concatenate([w, rng.random(HUB_LEAVES, dtype=np.float32)
                                    + 0.1]), n, device)
    g, _ = degree_sort(g)
    off, rows = g.host["csc_offsets"], g.host["csc_rows"]
    return g, int(rows[(off[0] + off[1]) // 2])


def directed_graph(device):
    return build_graph(rmat_coo(10, 8, seed=2),
                       GraphProperties(directed=True, weighted=True), device)


def unreached_graph(device):
    """Two R-MAT components (scale 9) and 100 isolated vertices."""
    rng = np.random.default_rng(13)
    n = 2 * 512 + 100
    parts = [_pairs(rmat_coo(9, 8, seed=s, undirected=True), rng)
             for s in (6, 7)]
    u = np.concatenate([parts[0][0], parts[1][0] + 512])
    v = np.concatenate([parts[0][1], parts[1][1] + 512])
    return _undirected(u, v, np.concatenate([parts[0][2], parts[1][2]]), n,
                       device)


def ties_graph(device):
    rng = np.random.default_rng(17)
    u, v, w = _pairs(rmat_coo(10, 8, seed=8, undirected=True), rng,
                     integer=True)
    return _undirected(u, v, w, 1 << 10, device)


def tolerance_case(device):
    """(graph, distances) of the tolerance case (see the module
    docstring)."""
    rng = np.random.default_rng(19)
    n_src, n_dst = 3000, 800
    lengths = np.concatenate([rng.integers(1, 33, 500),
                              rng.integers(33, 600, 290),
                              rng.integers(2049, TOLERANCE_HUB + 1, 10)])
    dst = np.repeat(np.arange(n_dst), lengths)
    src = np.concatenate([rng.choice(n_src, k, replace=False)
                          for k in lengths])
    w = rng.random(dst.size, dtype=np.float32) * 4 + 0.1
    n = 2 * max(n_src, n_dst)
    coo = Coo(n, n, (2 * src).astype(np.int32), (2 * dst + 1).astype(np.int32),
              w)
    g = build_graph(coo, GraphProperties(directed=True, weighted=True),
                    device)
    d = np.full(n, np.inf, np.float32)
    d[0:2 * n_src:2] = rng.random(n_src, dtype=np.float32) * 50
    d[0:2 * n_src:2][rng.random(n_src) < 0.02] = np.inf  # unreached sources
    # one in-edge of each target: a = d[u] + w in float32, then a distance
    # a few float32 steps from the tolerance's edge above or below a
    off, rows, vals = (g.host[k] for k in ("csc_offsets", "csc_rows",
                                           "csc_values"))
    targets = 2 * np.arange(n_dst) + 1
    pick = off[targets] + (rng.random(n_dst) * lengths).astype(np.int64)
    a = (d[rows[pick]] + vals[pick]).astype(np.float32)
    above = rng.random(n_dst) < 0.5
    a64 = a.astype(np.float64)
    edge = np.where(above, (a64 + ATOL) / (1 - RTOL),
                    (a64 - ATOL) / (1 + RTOL)).astype(np.float32)
    steps = rng.integers(-3, 4, n_dst)
    b = edge.copy()
    for k in range(1, 4):
        up, down = steps >= k, steps <= -k
        b[up] = np.nextafter(b[up], np.float32(np.inf))
        b[down] = np.nextafter(b[down], np.float32(-np.inf))
    exact = rng.random(n_dst) < 0.1
    b[exact] = a[exact]
    b[rng.random(n_dst) < 0.03] = np.inf  # unreached targets
    d[targets] = b
    return g, torch.from_numpy(d).to(g.device)


def cases(device) -> dict:
    """{name: (graph, kind, distances)} (see the module docstring)."""
    out = {}
    hub, s = hub_graph(device)
    directed = directed_graph(device)
    unreached = unreached_graph(device)
    for kind in ("bfs", "sssp"):
        out[f"hub_mid.{kind}"] = (hub, kind, _distances(hub, kind, s))
        out[f"directed.{kind}"] = (directed, kind, _distances(
            directed, kind, _top(directed)))
        out[f"unreached.{kind}"] = (unreached, kind, _distances(
            unreached, kind, _top(unreached)))
    ties = ties_graph(device)
    out["ties.sssp"] = (ties, "sssp", _distances(ties, "sssp", _top(ties)))
    g, d = tolerance_case(device)
    out["tolerance.sssp"] = (g, "sssp", d)
    return out


def bound_bytes(graph, distances, kind: str) -> tuple:
    """(bytes the pass's early exit needs, bytes of every slot): the
    offsets, the distances and pred over V, and 4 B a scanned slot (8 B
    with SSSP's weights); a reached vertex scans its run up to its first
    tight slot, all of it where none is tight."""
    from gunrock_tpu_torch.ops.kernels.predecessors import (
        tight_slots,
        unreached,
    )

    V, E = graph.n_vertices, graph.n_edges
    off = graph.csc_offsets.long()
    slot = torch.arange(E, device=graph.device)
    first = torch.full((V,), E, dtype=torch.long,
                       device=graph.device).scatter_reduce_(
        0, graph.csc_dst.long(),
        torch.where(tight_slots(graph, distances, kind), slot, E), "amin")
    length = off[1:] - off[:-1]
    scanned = torch.where(first < E, first - off[:-1] + 1, length)
    scanned = torch.where(unreached(distances, kind), 0, scanned)
    per_slot = 8 if kind == "sssp" else 4
    base = 4 * (V + 1) + 8 * V
    return base + per_slot * int(scanned.sum()), base + per_slot * E
