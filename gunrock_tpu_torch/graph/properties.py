"""Graph properties (copy of ``gunrock_tpu/graph/properties.py``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, eq=True)
class GraphProperties:
    directed: bool = True
    weighted: bool = False
    symmetric: bool = False
    # Hub-first vertex order (graph/reorder.degree_sort). Picks the smaller
    # push edge budget of direction-optimizing BFS (algorithms/bfs.py).
    hub_ordered: bool = False
