"""The least bytes a query has to move, whatever kernels run it.

Every input byte the query needs is read once and every output byte is
written once. A search from ``s`` needs the adjacency of the vertices it
reaches (two 4-byte row offsets a vertex, a 4-byte column index an edge,
and a 4-byte weight an edge where it is weighted) and writes its answer
over all ``n`` vertices (4 bytes a distance, 4 a predecessor, for each of
its ``k`` searches). Reached vertices and their edges come from the
benchmark's own component labels (:func:`search_work`), never from the
program.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# bytes: per reached vertex (two int32 offsets), per reached edge (int32
# column index, plus a float32 weight where weighted), per output word
OFFSETS_B, INDEX_B, WEIGHT_B, WORD_B = 8, 4, 4, 4


@dataclasses.dataclass(frozen=True)
class Work:
    vertices: int  # vertices reached by at least one search of the query
    edges: int  # their out-degree sum, once
    edges_traversed: int  # the out-degree sum of each search, added up


class Components:
    """Vertex count and out-degree sum of each connected component."""

    def __init__(self, labels: np.ndarray, degrees: np.ndarray):
        self.labels = labels
        self.size = np.bincount(labels)
        self.edges = np.bincount(labels, weights=degrees).astype(np.int64)

    def work(self, sources) -> Work:
        """What a query from ``sources`` reaches: a search reaches its
        source's component (the graph is symmetric)."""
        lab = self.labels[np.asarray(sources, dtype=np.int64)]
        uniq = np.unique(lab)
        return Work(vertices=int(self.size[uniq].sum()),
                    edges=int(self.edges[uniq].sum()),
                    edges_traversed=int(self.edges[lab].sum()))


def query_bytes(work: Work, n: int, k: int, weighted: bool,
                outputs_per_vertex: int) -> int:
    """Bytes a query needs: its reached adjacency read once, and
    ``outputs_per_vertex`` words a vertex for each of its ``k`` searches
    written once."""
    per_edge = INDEX_B + (WEIGHT_B if weighted else 0)
    return (OFFSETS_B * work.vertices + per_edge * work.edges
            + WORD_B * outputs_per_vertex * n * k)


# the card's published memory rate, by torch.cuda.get_device_name (NVIDIA's
# H100 SXM data sheet, at its 700 W limit); a card not listed has none
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def search_work(edges, sources: list, k: int, weighted: bool,
                outputs_per_vertex: int) -> tuple[list, list]:
    """([Work], [bytes]) of each query of a search from ``sources[i]`` over
    the symmetric graph ``edges``: a search reaches its source's
    component, by the benchmark's own labels."""
    from portbench import graphs

    comps = Components(graphs.components(edges), edges.degrees())
    works = [comps.work(s) for s in sources]
    return works, [query_bytes(w, edges.n, k, weighted, outputs_per_vertex)
                   for w in works]
