"""Device-resident multi-view graph.

The port's counterpart of ``gunrock_tpu/graph/graph.py``: the CSR and CSC
views of one edge set as torch tensors on one device, with the same nine
arrays. ``host`` keeps the numpy copies the graph was built from, so that
layout construction and CPU oracles never read the device back (the role of
the JAX package's weakref host cache). ``layouts`` caches bucketed layouts
built for this graph; it lives and dies with the graph.

Accessors mirror the reference graph API (graph/csr.hxx:56-173,
graph/graph.hxx:349-439): ``get_number_of_neighbors``, ``get_in_degree``,
``get_starting_edge``, ``get_destination_vertex``, ``get_source_vertex``
(a search over the row offsets), ``get_edge_weight``, ``get_edge(u, v)``,
``get_intersection_count(u, v)`` and its visitor ``intersect_neighbors``,
the degree vectors and the degree statistics. They run on the graph's
device. Vertex and edge ids may be Python ints or int tensors of any
shape; a tensor call gives the result of the JAX method under
``jax.vmap``, element by element.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gunrock_tpu_torch.device import DEFAULT, resolve
from gunrock_tpu_torch.graph.properties import GraphProperties

ARRAYS = {
    # CSR edge e: edge_src[e] -> col_indices[e], weight values[e]; edges
    # sorted by (src, dst)
    "row_offsets": np.int32,  # [V+1]
    "col_indices": np.int32,  # [E]
    "values": np.float32,  # [E]
    "edge_src": np.int32,  # [E]
    # CSC slot k: csc_rows[k] -> csc_dst[k]; slots sorted by (dst, src);
    # csc_edge_perm[k] is the CSR edge id stored at slot k
    "csc_offsets": np.int32,  # [V+1]
    "csc_rows": np.int32,  # [E]
    "csc_dst": np.int32,  # [E]
    "csc_values": np.float32,  # [E]
    "csc_edge_perm": np.int32,  # [E]
}
# products of a batched intersection count held at once
INTERSECT_BLOCK = 1 << 24


@dataclasses.dataclass(eq=False)
class Graph:
    row_offsets: torch.Tensor
    col_indices: torch.Tensor
    values: torch.Tensor
    edge_src: torch.Tensor
    csc_offsets: torch.Tensor
    csc_rows: torch.Tensor
    csc_dst: torch.Tensor
    csc_values: torch.Tensor
    csc_edge_perm: torch.Tensor
    n_vertices: int
    n_edges: int
    properties: GraphProperties
    host: dict = dataclasses.field(repr=False)
    layouts: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_arrays(
        cls,
        arrays: dict,
        n_vertices: int,
        properties: GraphProperties,
        device=DEFAULT,
    ) -> "Graph":
        """Graph from the nine named numpy arrays (``ARRAYS``). Arrays that
        are the same object (a symmetric graph's CSC aliasing its CSR)
        become one device tensor."""
        dev = resolve(device)
        host, tensors, by_id = {}, {}, {}
        for name, dtype in ARRAYS.items():
            src = arrays[name]
            if id(src) not in by_id:
                a = np.require(src, dtype, ["C", "W"])  # torch needs writable
                by_id[id(src)] = (a, torch.from_numpy(a).to(dev))
            host[name], tensors[name] = by_id[id(src)]
        return cls(
            **tensors,
            n_vertices=int(n_vertices),
            n_edges=int(host["col_indices"].shape[0]),
            properties=properties,
            host=host,
        )

    @property
    def device(self) -> torch.device:
        return self.row_offsets.device

    def to(self, device) -> "Graph":
        """This graph on ``device`` (itself if it is there already)."""
        dev = resolve(device)
        if dev == self.device or (
            dev.type == self.device.type == "cuda" and dev.index is None
        ):
            return self
        return Graph.from_arrays(self.host, self.n_vertices, self.properties, dev)

    def out_degrees(self) -> torch.Tensor:
        return torch.diff(self.row_offsets)

    # ------------------------------------------------------------------
    # Vertex/edge accessors (reference graph/csr.hxx:56-173)
    # ------------------------------------------------------------------

    def _ids(self, x) -> torch.Tensor:
        """``x`` (an int or an int tensor) as an int64 tensor on the
        graph's device."""
        return torch.as_tensor(x, device=self.device).long()

    def _edge_keys(self) -> torch.Tensor:
        """``edge_src * V + col_indices`` as int64, ascending because edges
        are sorted by (src, dst); cached on the graph."""
        key = ("edge_keys",)
        if key not in self.layouts:
            self.layouts[key] = (self.edge_src.long() * self.n_vertices
                                 + self.col_indices.long())
        return self.layouts[key]

    def _find_edges(self, u: torch.Tensor, v: torch.Tensor):
        """(pos, found) of the int64 id tensors ``u``, ``v``: ``pos`` is the
        lower bound of (u, v) among the edges, ``found`` whether edge
        ``pos`` is (u, v). Needs E > 0."""
        keys = self._edge_keys()
        q = u * self.n_vertices + v
        pos = torch.searchsorted(keys, q.reshape(-1)).reshape(q.shape)
        found = (keys[pos.clamp(max=self.n_edges - 1)] == q) & (pos < self.n_edges)
        return pos, found

    def get_number_of_vertices(self) -> int:
        return self.n_vertices

    def get_number_of_edges(self) -> int:
        return self.n_edges

    def get_number_of_neighbors(self, v) -> torch.Tensor:
        v = self._ids(v)
        return self.row_offsets[v + 1] - self.row_offsets[v]

    def get_in_degree(self, v) -> torch.Tensor:
        v = self._ids(v)
        return self.csc_offsets[v + 1] - self.csc_offsets[v]

    def get_starting_edge(self, v) -> torch.Tensor:
        return self.row_offsets[self._ids(v)]

    def get_destination_vertex(self, e) -> torch.Tensor:
        return self.col_indices[self._ids(e)]

    def get_source_vertex(self, e) -> torch.Tensor:
        """The row holding edge ``e``: a search over the row offsets
        (reference graph/csr.hxx:72-81), JAX's answer outside [0, E) too
        (-1 below, the last row past the end)."""
        e = self._ids(e)
        pos = torch.searchsorted(self.row_offsets.long(), e.reshape(-1),
                                 right=True)
        return (pos.reshape(e.shape) - 1).int()

    def get_edge_weight(self, e) -> torch.Tensor:
        return self.values[self._ids(e)]

    def get_edge(self, u, v) -> torch.Tensor:
        """Edge id of (u, v) or -1 (reference graph/csr.hxx:99-104): the
        lower bound of v in u's sorted row, so the first of repeated
        (u, v) edges. One search over all edges' (src, dst) keys; the
        bounds of u's row reject a ``v`` outside [0, V)."""
        u, v = torch.broadcast_tensors(self._ids(u), self._ids(v))
        if self.n_edges == 0:
            return torch.full(u.shape, -1, dtype=torch.int32, device=self.device)
        pos, found = self._find_edges(u, v)
        found &= (pos >= self.row_offsets[u]) & (pos < self.row_offsets[u + 1])
        return torch.where(found, pos, -1).int()

    def _smaller_row_first(self, u, v):
        du = self.get_number_of_neighbors(u)
        dv = self.get_number_of_neighbors(v)
        small = torch.where(du <= dv, u, v)
        return small, torch.where(du <= dv, v, u), torch.minimum(du, dv)

    def get_intersection_count(self, u, v) -> torch.Tensor:
        """Size of N(u) ∩ N(v) as JAX counts it (reference
        graph/csr.hxx:116-173): each entry of the smaller row (u's on a
        tie) that occurs in the other row counts once, so a neighbour the
        smaller row holds twice counts twice, and u == v gives u's degree.
        A tensor call expands the smaller rows, one entry a product, and
        looks each up among the edges, at most ``INTERSECT_BLOCK``
        products at a time."""
        u, v = torch.broadcast_tensors(self._ids(u), self._ids(v))
        shape = u.shape
        small, big, n = (t.reshape(-1) for t in self._smaller_row_first(u, v))
        n = n.long()
        ends = torch.cumsum(n, 0)
        total = int(ends[-1]) if ends.numel() else 0
        starts = self.row_offsets[small].long()
        counts = torch.zeros(small.numel(), dtype=torch.int64, device=self.device)
        for p0 in range(0, total, INTERSECT_BLOCK):
            p = torch.arange(p0, min(p0 + INTERSECT_BLOCK, total),
                             device=self.device)
            pair = torch.searchsorted(ends, p, right=True)
            y = self.col_indices[starts[pair] + p - (ends[pair] - n[pair])]
            _, found = self._find_edges(big[pair], y.long())
            counts.index_add_(0, pair, found.long())
        return counts.int().reshape(shape)

    def intersect_neighbors(self, u, v, on_intersection, init):
        """Visitor form of :meth:`get_intersection_count` (reference
        csr.hxx:116-173 ``on_intersection``): folds
        ``on_intersection(acc, y) -> acc`` over the common neighbours ``y``
        (0-d int32 tensors) of the scalar ids ``u`` and ``v``, in the order
        of the smaller row, from ``init``; ``acc`` may be any nesting of
        tensors."""
        small, big, _ = self._smaller_row_first(self._ids(u), self._ids(v))
        row = self.col_indices[int(self.row_offsets[small]):
                               int(self.row_offsets[small + 1])]
        acc = init
        if row.numel():
            _, found = self._find_edges(big.expand(row.shape), row.long())
            for y in row[found]:
                acc = on_intersection(acc, y)
        return acc

    # ------------------------------------------------------------------
    # Degree vectors & statistics (reference graph/graph.hxx:349-439)
    # ------------------------------------------------------------------

    def in_degrees(self) -> torch.Tensor:
        return torch.diff(self.csc_offsets)

    def get_average_degree(self) -> torch.Tensor:
        """Reference graph/graph.hxx:349-361, in float32."""
        return self.out_degrees().float().mean()

    def get_degree_standard_deviation(self) -> torch.Tensor:
        """Reference graph/graph.hxx:369-385, in float32."""
        d = self.out_degrees().float()
        return torch.sqrt(torch.mean((d - d.mean()) ** 2))

    def build_degree_histogram(self) -> torch.Tensor:
        """Log-scale degree histogram (reference graph/graph.hxx:393-439):
        33 int32 bins, degree d > 0 in bin ceil(log2(float32(d) + 1)),
        degree 0 in bin 0. log2 is JAX's: the float32 natural log over the
        float32 log of 2, divided in float32. The logs are taken in float64
        and rounded to float32, so that the card and the CPU give one
        answer; a float32 log on the card puts degree 2^13 - 1 in bin 14.
        The bins equal JAX's on the CPU for every degree below 2^25."""
        d = self.out_degrees()
        ln2 = torch.log(torch.full((1,), 2.0, dtype=torch.float64,
                                   device=self.device)).float()
        log_x = torch.log((d.float() + 1).double()).float()
        bins = torch.where(d > 0, torch.ceil(log_x / ln2), 0).long()
        return torch.bincount(bins, minlength=33).int()
