"""The system under test: the port's graph load path.

The one place besides ``portbench/entries/`` that imports the port
(``gunrock_tpu_torch``). :func:`load` hands the generator's host arrays to
``graph/build.build_graph`` and, where the configuration says so, to
``graph/reorder.degree_sort``, as a user loading an edge list does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gunrock_tpu_torch.formats import Coo
from gunrock_tpu_torch.graph import build_graph
from gunrock_tpu_torch.graph.properties import GraphProperties
from gunrock_tpu_torch.graph.reorder import degree_sort


class Program:
    """The port's graph and the relabeling it was loaded under: ``rank``
    maps an input vertex id to the graph's, ``order`` back (identity
    where the configuration keeps input ids)."""

    def __init__(self, graph, rank: np.ndarray, order: np.ndarray):
        self.graph = graph
        self.rank = rank
        self.rank_t = torch.from_numpy(rank).to(graph.device).long()
        self.order_t = torch.from_numpy(order).to(graph.device).long()
        self.relabeled = not np.array_equal(rank, np.arange(rank.shape[0]))

    def to_input_ids(self, per_vertex: torch.Tensor) -> torch.Tensor:
        """A per-vertex result of the graph, indexed by input ids."""
        return per_vertex[self.rank_t] if self.relabeled else per_vertex

    def preds_to_input_ids(self, pred: torch.Tensor) -> torch.Tensor:
        """Predecessors of the graph (its ids, -1 for none), indexed by
        input ids and naming input ids."""
        if not self.relabeled:
            return pred
        p = pred[self.rank_t].long()
        return torch.where(p >= 0, self.order_t[p.clamp(min=0)], -1)


def load(edges, cfg: dict, device) -> tuple[Program, float]:
    """(the port's graph of ``edges``, seconds it took), relabeled as
    ``cfg["relabel"]`` says ("degree_sort" or "none")."""
    t0 = time.perf_counter()
    coo = Coo(n_rows=edges.n, n_cols=edges.n, row_indices=edges.rows,
              col_indices=edges.cols, values=edges.weights)
    props = GraphProperties(directed=False, weighted=True, symmetric=True)
    graph = build_graph(coo, properties=props, device=device)
    relabel = cfg.get("relabel", "none")
    if relabel == "degree_sort":
        graph, ro = degree_sort(graph)
        rank, order = ro.rank, ro.order
    elif relabel == "none":
        rank = order = np.arange(edges.n, dtype=np.int32)
    else:
        raise ValueError(f"unknown relabel {relabel!r}")
    prog = Program(graph, rank, order)
    _sync(device)
    return prog, time.perf_counter() - t0


def kernel_libraries() -> set[str]:
    """The port's kernel libraries built in this checkout: a run that
    finds one missing builds it during its set-up."""
    from gunrock_tpu_torch.ops.kernels import _build

    return {p.name for p in _build.BUILD_DIR.glob("*.so")}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
