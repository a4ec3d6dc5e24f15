"""Device-resident multi-view graph.

The port's counterpart of ``gunrock_tpu/graph/graph.py``: the CSR and CSC
views of one edge set as torch tensors on one device, with the same nine
arrays. ``host`` keeps the numpy copies the graph was built from, so that
layout construction and CPU oracles never read the device back (the role of
the JAX package's weakref host cache). ``layouts`` caches bucketed layouts
built for this graph; it lives and dies with the graph.
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
