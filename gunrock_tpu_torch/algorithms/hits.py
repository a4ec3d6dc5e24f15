"""HITS: hub and authority scores.

Port of ``gunrock_tpu/algorithms/hits.py`` (role of reference
``algorithms/hits.hxx``). Per iteration, both from the current vectors:

    hub_next[src]  = sum over out-edges (src, nbr) of auth[nbr]
    auth_next[nbr] = sum over out-edges (src, nbr) of hub[src]

then both are L2-normalized. The loop stops at ``max_iterations`` or when
either vector reaches an exact fixpoint; the enactor reads that flag back
once per iteration.

Modes, picked as the JAX package picks them: ``fused`` (directed graph;
both sums in one sweep of the unit push layout, ``hits_fused_pass``),
``symmetric`` (A = A^T: one dense plus_times pass per iteration),
``two_pass`` (two dense passes; the JAX package's fallback past 2^22
vertices) and ``xla`` (plain segment sums).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gunrock_tpu_torch.device import DEFAULT
from gunrock_tpu_torch.framework import Enactor, Problem
from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.configs import LoadBalance, Options, default_options
from gunrock_tpu_torch.ops.kernels.hits_fused import hits_fused_pass
from gunrock_tpu_torch.ops.kernels.layout import (
    build_auto_layout,
    dense_window_chunk,
    pull_layout,
    push_layout,
)
from gunrock_tpu_torch.ops.kernels.semiring import bucketed_semiring_spmv
from gunrock_tpu_torch.ops.segment import seg_sum_sorted

# the JAX package's bound for the fused sweep (its col-side accumulator
# must fit the TPU's VMEM); kept so that both packages pick the same mode
_FUSED_MAX_V = 1 << 22


@dataclasses.dataclass
class Param:
    max_iterations: int = 50


@dataclasses.dataclass
class Result:
    auth: torch.Tensor  # float32[V]
    hub: torch.Tensor  # float32[V]
    iterations: int
    elapsed_ms: float


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / ||x||_2, or x itself when it is all zero."""
    s = (x * x).sum()
    return torch.where(s > 0, x / torch.sqrt(s), x)


def _fixpoint(auth_n, auth, hub_n, hub):
    return torch.equal(auth_n, auth) | torch.equal(hub_n, hub)


def hits_step(graph: Graph, auth, hub):
    """One HITS iteration in plain tensor ops. Returns (auth_next,
    hub_next)."""
    hub_next = seg_sum_sorted(auth[graph.col_indices.long()],
                              graph.row_offsets)
    auth_next = seg_sum_sorted(hub[graph.csc_rows.long()], graph.csc_offsets)
    return _l2_normalize(auth_next), _l2_normalize(hub_next)


def _ones(graph: Graph) -> torch.Tensor:
    return torch.ones(graph.n_vertices, dtype=torch.float32,
                      device=graph.device)


def hits_kernel(graph: Graph, max_iterations: int = 50):
    """Plain-tensor HITS to convergence. Returns (auth, hub, iterations).
    On symmetric storage hub and auth stay equal, so one segment sum per
    iteration."""
    auth = hub = _ones(graph)
    it, done = 0, False
    if graph.properties.symmetric:
        while not done and it < max_iterations:
            auth_n = _l2_normalize(seg_sum_sorted(
                auth[graph.csc_rows.long()], graph.csc_offsets))
            done = torch.equal(auth_n, auth)
            auth, it = auth_n, it + 1
        return auth, auth, it
    while not done and it < max_iterations:
        auth_n, hub_n = hits_step(graph, auth, hub)
        done = _fixpoint(auth_n, auth, hub_n, hub)
        auth, hub, it = auth_n, hub_n, it + 1
    return auth, hub, it


def _unit_layouts(graph: Graph):
    """(push, pull) unit layouts at W=2048/C=256 (not cached)."""
    h = graph.host
    ones = np.ones(graph.n_edges, np.float32)
    push = build_auto_layout(h["edge_src"], h["col_indices"], ones,
                             graph.n_vertices, device=graph.device)
    pull = build_auto_layout(h["col_indices"], h["edge_src"], ones,
                             graph.n_vertices, device=graph.device)
    return push, pull


def hits_kernel_pallas(graph: Graph, max_iterations: int = 50,
                       push_layout=None, pull_layout=None,
                       symmetric: bool = False):
    """HITS through the kernels: the symmetric single pass, else the fused
    sweep (up to 2^22 vertices) or the two dense passes. Returns (auth,
    hub, iterations)."""
    if push_layout is None or pull_layout is None:
        push_layout, pull_layout = _unit_layouts(graph)
    if symmetric:
        # A = A^T and equal starts keep hub == auth: one pass per iteration
        mode = "symmetric"
    else:
        mode = "fused" if graph.n_vertices <= _FUSED_MAX_V else "two_pass"
    auth = hub = _ones(graph)
    it, done = 0, False
    while not done and it < max_iterations:
        auth_n, hub_n = _kernel_step(mode, push_layout, pull_layout, auth, hub)
        done = _fixpoint(auth_n, auth, hub_n, hub)
        auth, hub, it = auth_n, hub_n, it + 1
    return auth, hub, it


def _kernel_step(mode: str, push, pull, auth, hub):
    """(auth_next, hub_next) of one iteration through the kernels."""
    if mode == "symmetric":
        auth_n = _l2_normalize(bucketed_semiring_spmv(
            pull, auth, "plus_times", unit=True))
        return auth_n, auth_n
    if mode == "fused":
        hub_raw, auth_raw = hits_fused_pass(push, auth, hub)
        return _l2_normalize(auth_raw), _l2_normalize(hub_raw)
    hub_n = _l2_normalize(bucketed_semiring_spmv(push, auth, "plus_times",
                                                 unit=True))
    auth_n = _l2_normalize(bucketed_semiring_spmv(pull, hub, "plus_times",
                                                  unit=True))
    return auth_n, hub_n


class HitsProblem(Problem):
    """Role of reference hits problem_t: the auth/hub vectors and the
    layouts the mode reads."""

    def __init__(self, graph: Graph, push_layout=None, pull_layout=None):
        super().__init__(graph)
        self.push_layout = push_layout
        self.pull_layout = pull_layout

    def reset(self):
        return {
            "auth": _ones(self.graph),
            "hub": _ones(self.graph),
            "done": torch.tensor(False, device=self.graph.device),
        }


class HitsEnactor(Enactor):
    """hits.hxx:138-192 on the framework skeleton: loop = both Jacobi
    accumulations (by ``mode``) and the L2 normalization; converged at
    either vector's exact fixpoint."""

    def __init__(self, problem, max_iterations: int, mode: str):
        super().__init__(problem, max_iterations=max_iterations)
        self.mode = mode  # "fused" | "two_pass" | "symmetric" | "xla"

    def prepare_frontier(self):
        return self.problem.reset()

    def is_converged(self, state):
        return state["done"]

    def loop(self, state):
        auth, hub = state["auth"], state["hub"]
        if self.mode == "xla":
            auth_n, hub_n = hits_step(self.problem.graph, auth, hub)
        else:
            auth_n, hub_n = _kernel_step(
                self.mode, self.problem.push_layout,
                self.problem.pull_layout, auth, hub)
        done = (auth_n == auth).all() | (hub_n == hub).all()
        return {**state, "auth": auth_n, "hub": hub_n, "done": done}


def run(
    graph: Graph,
    max_iterations: int = 50,
    options: Options | None = None,
    warmup: bool = True,
    device=DEFAULT,
) -> Result:
    """Role of reference ``hits::run`` on ``device``, through the
    Enactor/Problem skeleton. The default options take the kernels over
    unit layouts at the ``dense_window_chunk`` size: the symmetric single
    pass on symmetric storage, else the fused sweep (the two passes past
    2^22 vertices). The enactor is built per call."""
    graph = graph.to(device)
    if options is None:
        options = default_options()
    push = pull = None
    if options.load_balance == LoadBalance.PALLAS_MERGE_PATH:
        # HITS is dense-only: the bigger-chunk layout where it applies
        w, c = dense_window_chunk(graph.n_vertices) or (None, None)
        if graph.properties.symmetric:
            # A = A^T: one pass per iteration over one layout
            mode = "symmetric"
            pull = pull_layout(graph, unit=True, window=w, chunk=c)
        else:
            push = push_layout(graph, unit=True, window=w, chunk=c)
            if graph.n_vertices <= _FUSED_MAX_V:
                mode = "fused"  # the fused sweep reads only the push layout
            else:
                mode = "two_pass"
                pull = pull_layout(graph, unit=True, window=w, chunk=c)
    else:
        mode = "xla"
    enactor = HitsEnactor(HitsProblem(graph, push, pull), max_iterations, mode)
    state, elapsed_ms = enactor.enact(warmup=warmup)
    return Result(auth=state["auth"], hub=state["hub"],
                  iterations=int(state["iteration"]), elapsed_ms=elapsed_ms)
