"""Personalized PageRank from a seed (Andersen-style push), plus batch.

Port of ``gunrock_tpu/algorithms/ppr.py`` (role of reference
``algorithms/ppr.hxx``):

- reset: ``p = 0``, ``r = r' = indicator(seed)`` (ppr.hxx:68-86);
- per iteration, over the frontier: ``p[v] += 2a/(1+a) * r[v]``,
  ``r'[v] = 0`` (ppr.hxx:124-130); then along the frontier's out-edges
  ``r'[dst] += (1-a)/(1+a) * r[src]/deg(src)``, and ``dst`` enters the next
  frontier exactly when the accumulation crosses ``deg(dst) * eps``
  (ppr.hxx:132-143); then ``r <- r'``.

As in the JAX package the reference's per-edge atomic threshold race is a
deterministic dense form: the per-destination sums of one wave are
computed at once and the crossing test compares the totals before and
after. On the main path the wave is one frontier-sparse plus_times pass
over the unit pull layout (``ops/kernels/semiring.py``), whose cost
tracks the frontier's window spread; :func:`run_batch` puts K seeds on
the columns of the bucketed SpMM (``ops/kernels/spmm.py``). Each wave
reads one flag back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from gunrock_tpu_torch.device import DEFAULT
from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.configs import LoadBalance, Options, default_options
from gunrock_tpu_torch.ops.kernels.layout import pull_layout
from gunrock_tpu_torch.ops.kernels.semiring import bucketed_semiring_spmv_sparse
from gunrock_tpu_torch.ops.kernels.spmm import bucketed_spmm
from gunrock_tpu_torch.ops.segment import seg_sum_sorted
from gunrock_tpu_torch.utils.timer import timed


@dataclasses.dataclass
class Param:
    seed: int
    alpha: float = 0.15
    epsilon: float = 1e-6


@dataclasses.dataclass
class Result:
    p: torch.Tensor  # float32[V]
    iterations: int
    elapsed_ms: float


def _push_loop(graph: Graph, front, r, advance, alpha: float, epsilon: float,
               max_iterations: int | None):
    """The PPR wave loop for ``front``/``r`` of shape [V] or [V, K].
    ``advance(x, front)`` returns the per-destination sums of x over the
    in-edges. Returns (p, iterations)."""
    V = graph.n_vertices
    max_it = (2 * V) if max_iterations is None else max_iterations
    absorb = (2 * alpha) / (1 + alpha)
    spread = (1 - alpha) / (1 + alpha)
    deg = graph.out_degrees().float()
    if front.dim() == 2:
        deg = deg[:, None]
    # the threshold uses the destination's out-degree (ppr.hxx:140-141)
    thresh = deg * epsilon
    p = torch.zeros_like(r)
    rp = r
    it = 0
    while it < max_it and bool(front.any()):
        # filter: absorb 2a/(1+a) of the residual, reset r' on the frontier
        p = torch.where(front, p + absorb * r, p)
        rp = torch.where(front, 0.0, rp)
        # advance: push (1-a)/(1+a) * r/deg along the frontier's out-edges
        x = torch.where(front, spread * r / torch.clamp(deg, min=1.0), 0.0)
        new_rp = rp + advance(x, front)
        front = (rp < thresh) & (new_rp >= thresh)
        r = rp = new_rp
        it += 1
    return p, it


def _start(graph: Graph, seeds):
    """(front, r) with one column per seed ([V] for an int seed)."""
    V, dev = graph.n_vertices, graph.device
    if isinstance(seeds, int):
        front = torch.zeros(V, dtype=torch.bool, device=dev)
        front[seeds] = True
    else:
        seeds = torch.as_tensor(seeds, dtype=torch.int64, device=dev)
        front = torch.zeros((V, seeds.numel()), dtype=torch.bool, device=dev)
        front[seeds, torch.arange(seeds.numel(), device=dev)] = True
    return front, front.float()


def ppr_kernel(graph: Graph, seed: int, alpha: float = 0.15,
               epsilon: float = 1e-6, max_iterations: int | None = None):
    """PPR in plain tensor ops: each wave is a gather over the CSC order
    and a sorted segment sum. Returns (p f32[V], iterations)."""
    src = graph.csc_rows.long()

    def advance(x, front):
        return seg_sum_sorted(x[src], graph.csc_offsets)

    front, r = _start(graph, int(seed))
    return _push_loop(graph, front, r, advance, alpha, epsilon, max_iterations)


def ppr_kernel_pallas(graph: Graph, seed: int, layout, alpha: float = 0.15,
                      epsilon: float = 1e-6,
                      max_iterations: int | None = None):
    """PPR with the frontier-sparse semiring advance: each wave is one
    chunk-skipping plus_times pass over ``layout`` (the unit pull layout).
    Same update rules as :func:`ppr_kernel`. Returns (p f32[V],
    iterations)."""
    def advance(x, front):
        return bucketed_semiring_spmv_sparse(layout, x, front, "plus_times")

    front, r = _start(graph, int(seed))
    return _push_loop(graph, front, r, advance, alpha, epsilon, max_iterations)


def ppr_batch_kernel_spmm(graph: Graph, seeds, alpha: float = 0.15,
                          epsilon: float = 1e-6,
                          max_iterations: int | None = None, layout=None):
    """K-seed PPR with the batch axis on the SpMM's columns: every wave of
    all seeds is one [V, K] bucketed SpMM. Runs until every column's
    frontier is empty. Returns (p f32[V, K], iterations)."""
    if layout is None:
        layout = pull_layout(graph, unit=True)

    def advance(x, front):
        return bucketed_spmm(layout, x)

    front, r = _start(graph, seeds)
    return _push_loop(graph, front, r, advance, alpha, epsilon, max_iterations)


def run(
    graph: Graph,
    seed: int,
    alpha: float = 0.15,
    epsilon: float = 1e-6,
    options: Options | None = None,
    warmup: bool = True,
    device=DEFAULT,
) -> Result:
    """Role of reference ``ppr::run`` (ppr.hxx:170-195) on ``device``. With
    ``options.load_balance == PALLAS_MERGE_PATH`` (the default) the waves
    run through the frontier-sparse kernel, else through
    :func:`ppr_kernel`."""
    graph = graph.to(device)
    if not 0 <= int(seed) < graph.n_vertices:
        raise ValueError(f"seed {seed} outside [0, {graph.n_vertices})")
    if options is None:
        options = default_options()
    if options.load_balance == LoadBalance.PALLAS_MERGE_PATH and graph.n_edges:
        layout = pull_layout(graph, unit=True)

        def fn():
            return ppr_kernel_pallas(graph, seed, layout, alpha, epsilon)
    else:
        def fn():
            return ppr_kernel(graph, seed, alpha, epsilon)
    (p, it), elapsed_ms = timed(graph.device, fn, warmup)
    return Result(p=p, iterations=int(it), elapsed_ms=elapsed_ms)


def run_batch(
    graph: Graph,
    seeds,
    alpha: float = 0.15,
    epsilon: float = 1e-6,
    warmup: bool = True,
    use_spmm: bool | None = None,
    device=DEFAULT,
):
    """Multi-seed PPR (role of reference ``ppr::run_batch``,
    ppr.hxx:217-238) on ``device``. ``use_spmm`` (default: true on a CUDA
    device, false on the CPU) puts the seed batch on the SpMM's columns;
    otherwise the seeds run one after another through :func:`ppr_kernel`.
    Returns (p[n_seeds, V], elapsed_ms)."""
    graph = graph.to(device)
    seeds = [int(s) for s in seeds]
    if use_spmm is None:
        use_spmm = graph.device.type == "cuda"
    if use_spmm:
        layout = pull_layout(graph, unit=True)

        def fn():
            return ppr_batch_kernel_spmm(graph, seeds, alpha, epsilon,
                                         layout=layout)[0].T
    else:
        def fn():
            return torch.stack([ppr_kernel(graph, s, alpha, epsilon)[0]
                                for s in seeds])
    return timed(graph.device, fn, warmup)
