"""PageRank (weighted power iteration with dangling-mass correction).

Port of ``gunrock_tpu/algorithms/pr.py`` (role of reference
``algorithms/pr.hxx``):

- ``iweights[v] = alpha / sum_out_weights(v)``, 0 for a dangling vertex;
- per iteration: ``plast = p``; ``dsum = sum over dangling v of alpha *
  plast[v]``; ``p = (1 - alpha + dsum) / n`` everywhere, plus the scatter
  of ``plast[src] * iweights[src] * w`` into ``p[dst]`` over every edge;
- converge when ``max|p - plast| < tol``.

The main path (:func:`run` with the default options) takes the edge
scatter through the dense plus_times pass (``ops/kernels/semiring.py``)
over the valued pull layout, at W=4096/C=1024 where
``dense_window_chunk`` picks it. :func:`run_batch` advances K damping
factors at once through the bucketed SpMM. Each power iteration reads its
L-inf error back to the host once.
"""

from __future__ import annotations

import dataclasses

import torch

from gunrock_tpu_torch.device import DEFAULT
from gunrock_tpu_torch.framework import Enactor, Problem
from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.configs import LoadBalance, Options, default_options
from gunrock_tpu_torch.ops.kernels.layout import dense_window_chunk, pull_layout
from gunrock_tpu_torch.ops.kernels.semiring import bucketed_semiring_spmv
from gunrock_tpu_torch.ops.kernels.spmm import bucketed_spmm
from gunrock_tpu_torch.ops.segment import seg_sum_sorted
from gunrock_tpu_torch.utils.timer import timed

_DEFAULT_MAX_IT = 10_000
_STALL_LIMIT = 16


@dataclasses.dataclass
class Param:
    alpha: float = 0.85
    tol: float = 1e-6


@dataclasses.dataclass
class Result:
    p: torch.Tensor  # float32[V]
    iterations: int
    elapsed_ms: float


@dataclasses.dataclass
class BatchResult:
    p: torch.Tensor  # float32[V, K]; column k is the ranking for alphas[k]
    alphas: tuple  # the K damping factors, column order
    iterations: int
    elapsed_ms: float


def _out_wsum(graph: Graph) -> torch.Tensor:
    """Sum of out-edge weights per vertex: a sorted segment sum over the
    CSR rows, in a fixed order, so that the card gives the same bits run
    to run (a scatter by atomics does not)."""
    return torch.segment_reduce(graph.values, "sum",
                                offsets=graph.row_offsets.long())


def compute_iweights(graph: Graph, alpha: float) -> torch.Tensor:
    """``alpha / out_weight_sum`` per vertex, 0 if dangling."""
    out_wsum = _out_wsum(graph)
    return torch.where(out_wsum != 0.0, alpha / out_wsum, 0.0)


def _base(iweights, plast, alpha: float, V: int):
    """The uniform term: teleport plus the dangling mass, spread over V."""
    dsum = torch.where(iweights == 0.0, alpha * plast, 0.0).sum()
    return (1.0 - alpha + dsum) / V


def pr_step(graph: Graph, p, iweights, alpha: float):
    """One power iteration in plain tensor ops. Returns (p_next, linf_err)."""
    plast = p
    src = graph.csc_rows.long()
    contrib = plast[src] * iweights[src] * graph.csc_values
    p = _base(iweights, plast, alpha, graph.n_vertices) + seg_sum_sorted(
        contrib, graph.csc_offsets)
    return p, (p - plast).abs().max()


def _power_iterate(step, p0, tol: float, max_iterations: int):
    """Iterate ``p, err = step(p)`` while err >= tol; one host read of err
    per iteration. Returns (p, iterations)."""
    p, err, it = p0, float("inf"), 0
    while err >= tol and it < max_iterations:
        p, err_t = step(p)
        err = float(err_t)
        it += 1
    return p, it


def pr_kernel(graph: Graph, alpha: float = 0.85, tol: float = 1e-6,
              max_iterations: int = _DEFAULT_MAX_IT):
    """Plain-tensor PageRank to convergence. Returns (p, iterations)."""
    V = graph.n_vertices
    iweights = compute_iweights(graph, alpha)
    p0 = torch.full((V,), 1.0 / V, dtype=torch.float32, device=graph.device)
    return _power_iterate(lambda p: pr_step(graph, p, iweights, alpha), p0,
                          tol, max_iterations)


def pr_kernel_pallas(graph: Graph, alpha: float = 0.85, tol: float = 1e-6,
                     max_iterations: int = _DEFAULT_MAX_IT, layout=None):
    """PageRank with the edge scatter through the dense plus_times pass
    over the valued pull layout. Returns (p, iterations)."""
    if layout is None:
        layout = pull_layout(graph)
    V = graph.n_vertices
    iweights = compute_iweights(graph, alpha)
    p0 = torch.full((V,), 1.0 / V, dtype=torch.float32, device=graph.device)

    def step(plast):
        p = _base(iweights, plast, alpha, V) + bucketed_semiring_spmv(
            layout, plast * iweights, "plus_times")
        return p, (p - plast).abs().max()

    return _power_iterate(step, p0, tol, max_iterations)


class PrProblem(Problem):
    def __init__(self, graph: Graph, param: Param):
        super().__init__(graph)
        self.param = param

    def reset(self):
        V = self.graph.n_vertices
        return {
            "p": torch.full((V,), 1.0 / V, dtype=torch.float32,
                            device=self.graph.device),
            "iweights": compute_iweights(self.graph, self.param.alpha),
            "err": torch.tensor(float("inf"), device=self.graph.device),
        }


class PrEnactor(Enactor):
    def __init__(self, problem, max_iterations: int = _DEFAULT_MAX_IT):
        super().__init__(problem, max_iterations=max_iterations)

    def prepare_frontier(self):
        return self.problem.reset()

    def loop(self, state):
        p, err = pr_step(self.problem.graph, state["p"], state["iweights"],
                         self.problem.param.alpha)
        return {**state, "p": p, "err": err}

    def is_converged(self, state):
        # err starts at +inf, so the first check is false (the reference
        # checks from iteration 1)
        return state["err"] < self.problem.param.tol


def _max_iterations(options: Options | None) -> int:
    if options is not None and options.max_iterations:
        return options.max_iterations
    return _DEFAULT_MAX_IT


def run(
    graph: Graph,
    alpha: float = 0.85,
    tol: float = 1e-6,
    options: Options | None = None,
    warmup: bool = True,
    device=DEFAULT,
) -> Result:
    """Role of reference ``pr::run`` on ``device``. With
    ``options.load_balance == PALLAS_MERGE_PATH`` (the default) the edge
    scatter runs through the dense plus_times kernel; otherwise the
    enactor runs :func:`pr_step`."""
    graph = graph.to(device)
    max_it = _max_iterations(options)
    if options is None:
        options = default_options()
    if options.load_balance == LoadBalance.PALLAS_MERGE_PATH:
        # PageRank is dense-only: the bigger-chunk layout where it applies
        w, c = dense_window_chunk(graph.n_vertices) or (None, None)
        layout = pull_layout(graph, window=w, chunk=c)
        (p, it), elapsed_ms = timed(
            graph.device, lambda: pr_kernel_pallas(graph, alpha, tol, max_it,
                                                   layout=layout), warmup)
        return Result(p=p, iterations=int(it), elapsed_ms=elapsed_ms)
    enactor = PrEnactor(PrProblem(graph, Param(alpha=alpha, tol=tol)),
                        max_iterations=max_it)
    state, elapsed_ms = enactor.enact(warmup=warmup)
    return Result(p=state["p"], iterations=int(state["iteration"]),
                  elapsed_ms=elapsed_ms)


def _batch_terms(graph: Graph, alphas: torch.Tensor):
    """(inv_wsum f32[V], dangling bool[V], p0 f32[V, K])."""
    out_wsum = _out_wsum(graph)
    inv_wsum = torch.where(out_wsum != 0.0, 1.0 / out_wsum, 0.0)
    V, K = graph.n_vertices, alphas.shape[0]
    p0 = torch.full((V, K), 1.0 / V, dtype=torch.float32, device=graph.device)
    return inv_wsum, out_wsum == 0.0, p0


def _batch_base(plast, dangling, alphas, V: int):
    dsum = torch.where(dangling[:, None], plast, 0.0).sum(dim=0) * alphas
    return (1.0 - alphas + dsum) / V  # [K]


def pr_batch_kernel_xla(graph: Graph, alphas, tol: float = 1e-6,
                        max_iterations: int = _DEFAULT_MAX_IT):
    """[V, K] multi-damping power iteration in plain tensor ops (the
    non-kernel backend of :func:`run_batch`): one CSC gather feeds all K
    columns. Returns (p f32[V, K], iterations)."""
    alphas = torch.as_tensor(alphas, dtype=torch.float32, device=graph.device)
    V = graph.n_vertices
    inv_wsum, dangling, p0 = _batch_terms(graph, alphas)
    src = graph.csc_rows.long()

    def step(plast):
        x = plast * inv_wsum[:, None] * alphas[None, :]
        contrib = x[src] * graph.csc_values[:, None]
        p = _batch_base(plast, dangling, alphas, V)[None, :] + seg_sum_sorted(
            contrib, graph.csc_offsets)
        return p, (p - plast).abs().max()

    return _power_iterate(step, p0, tol, max_iterations)


def pr_batch_kernel_spmm(graph: Graph, alphas, tol: float = 1e-6,
                         max_iterations: int = _DEFAULT_MAX_IT, layout=None):
    """Multi-damping PageRank sweep with the K axis on the bucketed SpMM:
    all K power iterations advance together through one [V, K] kernel,
    over ``layout`` (default: the valued pull layout at W=2048/C=256, the
    JAX package's ``build_auto_layout(col_indices, edge_src, values)``).
    Converges when every column's L-inf error is under tol, or when the
    error has not shrunk for 16 iterations in a row (the reference's stall
    rule for a kernel whose rounding floor sits above tol; the port's f32
    SpMM rarely needs it). Returns (p f32[V, K], iterations)."""
    if layout is None:
        layout = pull_layout(graph)
    alphas = torch.as_tensor(alphas, dtype=torch.float32, device=graph.device)
    V = graph.n_vertices
    inv_wsum, dangling, p = _batch_terms(graph, alphas)
    err = err_prev = float("inf")
    it = stall = 0
    while err >= tol and it < max_iterations and stall < _STALL_LIMIT:
        plast = p
        x = plast * inv_wsum[:, None] * alphas[None, :]
        p = _batch_base(plast, dangling, alphas, V)[None, :] + bucketed_spmm(
            layout, x)
        err = float((p - plast).abs().max())
        stall = 0 if err < err_prev else stall + 1
        err_prev = err
        it += 1
    return p, it


def run_batch(
    graph: Graph,
    alphas,
    tol: float = 1e-6,
    options: Options | None = None,
    warmup: bool = True,
    device=DEFAULT,
) -> BatchResult:
    """Multi-damping PageRank sweep on ``device``: all K alphas advance
    together, the K axis riding the SpMM's columns (the reference's batch
    operator runs independent runs instead)."""
    graph = graph.to(device)
    alphas = tuple(float(a) for a in alphas)
    max_it = _max_iterations(options)
    if options is None:
        options = default_options()
    if options.load_balance == LoadBalance.PALLAS_MERGE_PATH:
        layout = pull_layout(graph)

        def fn():
            return pr_batch_kernel_spmm(graph, alphas, tol, max_it,
                                        layout=layout)
    else:
        def fn():
            return pr_batch_kernel_xla(graph, alphas, tol, max_it)
    (p, it), elapsed_ms = timed(graph.device, fn, warmup)
    return BatchResult(p=p, alphas=alphas, iterations=int(it),
                       elapsed_ms=elapsed_ms)
