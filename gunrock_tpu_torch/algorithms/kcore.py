"""K-core decomposition: the core number of every vertex.

Port of ``gunrock_tpu/algorithms/kcore.py`` (role of reference
``algorithms/kcore.hxx``): peel vertices of residual degree <= k, lower
their neighbours' degrees, and raise k when nothing peels. As in the JAX
package the loop is flat, with a fused k-jump: k is raised to the least
remaining residual degree at the start of every round, so every round
peels at least one vertex, no round is spent finding out that a level is
done, and the neighbour decrement runs unconditionally.

On the main path the decrement is one frontier-sparse plus_times pass
(``ops/kernels/semiring.py``) over the unit pull layout, counting each
vertex's in-neighbours peeled this round; source windows without a peeled
vertex and destination windows without a live one are skipped. The
kernels read the active-chunk count on the device, so the JAX package's
tail-grid ladder and its per-graph enactor cache have no counterpart.
The loop runs on ``framework.Enactor`` and reads one flag back per round.
"""

from __future__ import annotations

import dataclasses

import torch

from gunrock_tpu_torch.device import DEFAULT
from gunrock_tpu_torch.framework import Enactor, Problem
from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.configs import LoadBalance, Options, default_options
from gunrock_tpu_torch.ops.kernels.layout import pull_layout
from gunrock_tpu_torch.ops.kernels.semiring import bucketed_semiring_spmv_sparse
from gunrock_tpu_torch.ops.segment import seg_count_sorted

_BIG_DEG = 2**30


@dataclasses.dataclass
class Param:
    pass


@dataclasses.dataclass
class Result:
    k_cores: torch.Tensor  # int32[V]
    degeneracy: int
    elapsed_ms: float
    rounds: int = 0  # loop iterations (= peel waves; fused k-jump)


class KCoreProblem(Problem):
    """Role of reference kcore problem_t (kcore.hxx:54-101): the
    degrees/alive/cores state, and the layout of the kernel decrement."""

    def __init__(self, graph: Graph, layout=None):
        super().__init__(graph)
        self.layout = layout

    def reset(self):
        g = self.graph
        V = g.n_vertices
        # Self loops are excluded from the peel degrees (deviation from
        # kcore.hxx:79-84, which counts them and disagrees with the
        # standard core number on non-simple inputs). A peeled vertex's
        # self edge only ever decrements the vertex itself, whose degree is
        # never read again, so only the INITIAL degrees need the correction.
        self_loops = torch.zeros(V, dtype=torch.int32, device=g.device)
        self_loops.index_add_(0, g.edge_src.long(),
                              (g.edge_src == g.col_indices).to(torch.int32))
        return {
            "k": torch.ones((), dtype=torch.int32, device=g.device),
            "degrees": g.out_degrees().to(torch.int32) - self_loops,
            "frontier": torch.ones(V, dtype=torch.bool, device=g.device),
            "cores": torch.zeros(V, dtype=torch.int32, device=g.device),
        }


class KCoreEnactor(Enactor):
    """Reference enactor pattern (kcore.hxx:139-202): loop = k-jump + peel
    + decrement; converged when the alive frontier empties.
    ``decrement_fn(peel, alive, layout) -> int32[V]`` counts, for every
    vertex, the edges into it from the vertices peeled this round (counts
    of vertices that are not alive may be anything: their degrees are
    never read again); the default is a gather over the CSC order and a
    sorted segment count."""

    def __init__(self, problem, decrement_fn=None):
        super().__init__(problem)
        self._decrement = decrement_fn

    def prepare_frontier(self):
        return self.problem.reset()

    def loop(self, state):
        k, deg = state["k"], state["degrees"]
        alive, cores = state["frontier"], state["cores"]
        # fused k-jump: every alive vertex has residual degree >= the
        # least one, so raising k to it is safe and the argmin peels
        k = torch.maximum(k, torch.where(alive, deg, _BIG_DEG).min())
        peel = alive & (deg <= k)
        cores = torch.where(peel, k, cores)
        alive = alive & ~peel
        if self._decrement is not None:
            dec = self._decrement(peel, alive, self.problem.layout)
        else:
            g = self.problem.graph
            dec = seg_count_sorted(peel[g.csc_rows.long()], g.csc_offsets)
        return {**state, "k": k, "degrees": deg - dec, "frontier": alive,
                "cores": cores}


def kernel_decrement(peel, alive, layout):
    """The decrement as one doubly frontier-sparse plus_times pass over the
    unit pull layout (0/1 inputs: the f32 counts are exact integers)."""
    cnt = bucketed_semiring_spmv_sparse(
        layout, peel.float(), peel, "plus_times", out_mask=alive, exact=True,
        unit=True)
    return torch.round(cnt).to(torch.int32)


def kcore_kernel(graph: Graph, decrement_fn=None, layout=None):
    """Pure k-core. Returns (k_cores int32[V], degeneracy tensor, rounds)."""
    enactor = KCoreEnactor(KCoreProblem(graph, layout), decrement_fn)
    state = enactor.run(enactor.prepare_frontier())
    cores = state["cores"]
    return cores, cores.max(), state["iteration"]


def run(graph: Graph, options: Options | None = None, warmup: bool = True,
        device=DEFAULT) -> Result:
    """Role of reference ``kcore::run`` (kcore.hxx:221-244) on ``device``.
    With ``options.load_balance == PALLAS_MERGE_PATH`` (the default) the
    decrement runs through the frontier-sparse kernel."""
    graph = graph.to(device)
    if options is None:
        options = default_options()
    decrement_fn = layout = None
    if options.load_balance == LoadBalance.PALLAS_MERGE_PATH and graph.n_edges:
        # the unit pull layout BFS and PPR use (one cache entry)
        layout = pull_layout(graph, unit=True)
        decrement_fn = kernel_decrement
    enactor = KCoreEnactor(KCoreProblem(graph, layout), decrement_fn)
    state, elapsed_ms = enactor.enact(warmup=warmup)
    cores = state["cores"]
    return Result(k_cores=cores, degeneracy=int(cores.max()),
                  elapsed_ms=elapsed_ms, rounds=int(state["iteration"]))
