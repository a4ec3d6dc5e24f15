"""The benchmark's graphs: made on the device from the seed.

Each configuration file names a generator (``"generator"``) and its
parameters; the generator is ``portbench/generators/<generator>.py``,
found by that name. Its ``generate(cfg, seed, device)`` draws with a
``torch.Generator`` on the device (:func:`torch_generator`) and returns
an :class:`EdgeList`, as :func:`symmetric` makes one: the symmetric edge
set sorted by (row, col), self-loops and duplicates removed, one weight
a pair, equal in both directions. The port gets these arrays through its
own load path; the reference builds its CSR from the same arrays. Nothing
here imports the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class EdgeList:
    """A symmetric graph on the host, sorted by (row, col)."""

    n: int
    rows: np.ndarray  # int32[E]
    cols: np.ndarray  # int32[E]
    weights: np.ndarray  # float32[E], in (0, 1], w(u, v) == w(v, u)

    @property
    def n_edges(self) -> int:
        return int(self.rows.shape[0])

    def offsets(self) -> np.ndarray:
        """int64[n + 1] row offsets of the sorted rows."""
        counts = np.bincount(self.rows, minlength=self.n)
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def degrees(self) -> np.ndarray:
        return np.bincount(self.rows, minlength=self.n).astype(np.int64)


def symmetric(u: torch.Tensor, v: torch.Tensor, n: int,
               gen: torch.Generator) -> EdgeList:
    """Drop self-loops and duplicate pairs, draw one weight in (0, 1] for
    each remaining unordered pair, add both directions, sort."""
    keep = u != v
    lo = torch.minimum(u, v)[keep]
    hi = torch.maximum(u, v)[keep]
    pairs = torch.unique(lo * n + hi)  # sorted, distinct
    lo, hi = pairs // n, pairs % n
    # torch.rand is in [0, 1); 1 - r is in (0, 1], as Graph500's kernel 3
    # weights are, with no zero-weight edge
    w = 1.0 - torch.rand(pairs.shape[0], generator=gen, device=u.device,
                         dtype=torch.float32)
    rows = torch.cat([lo, hi])
    cols = torch.cat([hi, lo])
    weights = torch.cat([w, w])
    order = torch.argsort(rows * n + cols)
    return EdgeList(
        n=n,
        rows=rows[order].to(torch.int32).cpu().numpy(),
        cols=cols[order].to(torch.int32).cpu().numpy(),
        weights=weights[order].cpu().numpy(),
    )


def generate(cfg: dict, seed: int, device) -> EdgeList:
    """The configuration's graph for ``seed``: drawn from ``seed``, or from
    the configuration's ``graph_seed`` where it pins one graph for every
    run."""
    from portbench import manifest

    gen = manifest.generator(cfg["generator"])
    return gen.generate(cfg, int(cfg.get("graph_seed", seed)),
                        torch.device(device))


def torch_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    # manual_seed takes up to 64 bits; fold larger seeds into that range
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def components(edges: EdgeList) -> np.ndarray:
    """Connected-component label of every vertex (scipy's, on the host).
    A search reaches exactly its source's component."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    a = sp.csr_matrix(
        (np.ones(edges.n_edges, np.int8), edges.cols, edges.offsets()),
        shape=(edges.n, edges.n))
    _, labels = connected_components(a, directed=False)
    return labels.astype(np.int64)
