"""Plain-PyTorch reference searches over the benchmark's own edge list.

Straightforward level-synchronous BFS and Bellman-Ford, written from the
definitions and nothing else: every level or round looks at every edge.
They import nothing of the port and take nothing it made; they start from
the generator's :class:`portbench.graphs.EdgeList`.

Conventions: BFS distances are int64 with -1 for unreached; SSSP
distances are floating point with +inf for unreached; predecessors are
int64 with -1 for the source and for unreached vertices.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Csr:
    """The edge list on a device: ``src``/``dst`` per edge, sorted by
    (src, dst); ``keys = src * n + dst`` (sorted) for edge lookups."""

    n: int
    src: torch.Tensor  # int64[E]
    dst: torch.Tensor  # int64[E]
    w: torch.Tensor  # float64[E]
    keys: torch.Tensor  # int64[E], sorted

    @classmethod
    def from_edges(cls, edges, device) -> "Csr":
        src = torch.from_numpy(edges.rows).to(device).long()
        dst = torch.from_numpy(edges.cols).to(device).long()
        w = torch.from_numpy(edges.weights).to(device).double()
        return cls(n=edges.n, src=src, dst=dst, w=w, keys=src * edges.n + dst)

    def find(self, u: torch.Tensor, v: torch.Tensor):
        """(is_edge bool[...], weight float64[...]) of the pairs (u, v)."""
        q = u * self.n + v
        idx = torch.searchsorted(self.keys, q).clamp(max=self.keys.numel() - 1)
        hit = self.keys[idx] == q
        return hit, torch.where(hit, self.w[idx], float("nan"))


def bfs(csr: Csr, source: int) -> torch.Tensor:
    """Hop distances from ``source``: int64[n], -1 where unreached."""
    dist = torch.full((csr.n,), -1, dtype=torch.int64, device=csr.src.device)
    dist[source] = 0
    front = torch.zeros(csr.n, dtype=torch.bool, device=csr.src.device)
    front[source] = True
    level = 0
    while bool(front.any()):
        hit = front[csr.src]
        new = torch.zeros_like(front)
        new[csr.dst[hit]] = True
        new &= dist < 0
        dist[new] = level + 1
        front = new
        level += 1
    return dist


def bfs_parents(csr: Csr, dist: torch.Tensor) -> torch.Tensor:
    """The smallest in-neighbour one level closer, for every reached vertex
    but the source; -1 elsewhere."""
    ok = (dist[csr.src] >= 0) & (dist[csr.src] + 1 == dist[csr.dst])
    big = torch.iinfo(torch.int64).max
    pred = torch.full((csr.n,), big, dtype=torch.int64, device=dist.device)
    pred.scatter_reduce_(0, csr.dst, torch.where(ok, csr.src, big), "amin")
    return torch.where(pred == big, -1, pred)


def bellman_ford(csr: Csr, source: int,
                 dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Shortest-path distances from ``source`` with every sum rounded to
    ``dtype``: relax every edge each round until no distance falls."""
    inf = float("inf")
    w = csr.w.to(dtype)
    dist = torch.full((csr.n,), inf, dtype=dtype, device=csr.src.device)
    dist[source] = 0
    while True:
        cand = dist[csr.src] + w
        new = dist.scatter_reduce(0, csr.dst, cand, "amin", include_self=True)
        if not bool((new < dist).any()):
            return new
        dist = new


def sssp_parents(csr: Csr, dist: torch.Tensor) -> torch.Tensor:
    """The smallest in-neighbour whose distance plus the edge's weight,
    rounded to ``dist``'s type, equals the vertex's distance; -1 for the
    source and for unreached vertices."""
    w = csr.w.to(dist.dtype)
    d_src = dist[csr.src]
    ok = torch.isfinite(d_src) & (d_src + w == dist[csr.dst])
    big = torch.iinfo(torch.int64).max
    pred = torch.full((csr.n,), big, dtype=torch.int64, device=dist.device)
    pred.scatter_reduce_(0, csr.dst, torch.where(ok, csr.src, big), "amin")
    pred = torch.where(pred == big, -1, pred)
    return torch.where(dist == 0, -1, pred)
