"""Graph properties and view flags (copy of
``gunrock_tpu/graph/properties.py``)."""

from __future__ import annotations

import dataclasses
import enum


class View(enum.Flag):
    """Which format views a graph materializes (reference view_t,
    graph/properties.hxx:26-31)."""

    CSR = enum.auto()
    CSC = enum.auto()
    COO = enum.auto()



@dataclasses.dataclass(frozen=True, eq=True)
class GraphProperties:
    directed: bool = True
    weighted: bool = False
    symmetric: bool = False
    # Hub-first vertex order (graph/reorder.degree_sort). Picks the smaller
    # push edge budget of direction-optimizing BFS (algorithms/bfs.py).
    hub_ordered: bool = False
