"""Betweenness centrality (Brandes) from a source, plus all-sources batch.

Port of ``gunrock_tpu/algorithms/bc.py`` (role of reference
``algorithms/bc.hxx``):

- forward sweep: level-synchronous BFS that keeps per-vertex depth labels
  and shortest-path counts sigma (bc.hxx:125-154);
- backward sweep over the levels d = depth-1 .. 1: for each edge
  (src, dst) with ``label[dst] == label[src] + 1``,
  ``delta[src] += sigma[src] / sigma[dst] * (1 + delta[dst])``; the result
  is ``0.5 * delta`` with the source excluded (bc.hxx:158-192);
- all sources: the per-source results summed (bc.hxx:304-321).

As in the JAX package the labels are the frontier stack (the frontier at
depth d is ``labels == d``), and a positive sigma sum into an unreached
vertex is reachability (sigma >= 1 on the frontier), so one sum per level
serves both. Every kernel of this module is the same two loops around an
advance: sorted-order scatter sums (:func:`bc_kernel`), the frontier-sparse
semiring pass on the unit pull and push layouts
(:func:`bc_kernel_pallas`), or the bucketed SpMM with one column per
source (:func:`bc_batch_kernel`). The sums are taken within each vertex's
own edges, never as differences of a global prefix: sigma spans ~2^depth
on meshes. The ``while_loop``s are Python loops here; the forward loop
reads one flag per level back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from gunrock_tpu_torch.device import DEFAULT
from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.configs import LoadBalance, Options, default_options
from gunrock_tpu_torch.ops.kernels.layout import pull_layout, push_layout
from gunrock_tpu_torch.ops.kernels.semiring import bucketed_semiring_spmv_sparse
from gunrock_tpu_torch.ops.kernels.spmm import bucketed_spmm
from gunrock_tpu_torch.utils.timer import timed


@dataclasses.dataclass
class Param:
    single_source: int


@dataclasses.dataclass
class Result:
    bc_values: torch.Tensor  # float32[V] (scaled by 0.5, reference parity)
    elapsed_ms: float


def _forward(graph: Graph, sources, pull):
    """Forward sweep from ``sources`` (an int: state of shape [V]; a
    sequence of K: [V, K], one column each). ``pull(x, front, unreached)``
    returns the sums of x over each vertex's in-edges. Returns (labels
    int32, sigma f32, depth)."""
    V, dev = graph.n_vertices, graph.device
    if isinstance(sources, int):
        at = (sources,)
        shape = (V,)
    else:
        sources = torch.as_tensor(sources, dtype=torch.int64, device=dev)
        at = (sources, torch.arange(sources.numel(), device=dev))
        shape = (V, sources.numel())
    labels = torch.full(shape, -1, dtype=torch.int32, device=dev)
    sigma = torch.zeros(shape, dtype=torch.float32, device=dev)
    front = torch.zeros(shape, dtype=torch.bool, device=dev)
    labels[at], sigma[at], front[at] = 0, 1.0, True
    depth = 0
    while depth < V and bool(front.any()):
        unreached = labels == -1
        sig_add = pull(torch.where(front, sigma, 0.0), front, unreached)
        front = unreached & (sig_add > 0)
        labels = torch.where(front, depth + 1, labels)
        sigma = torch.where(front, sig_add, sigma)
        depth += 1
    return labels, sigma, depth


def _backward(labels, sigma, depth: int, push):
    """Backward sweep. ``push(x, up, here)`` returns the sums of x over
    each vertex's out-edges. Returns delta f32, shaped as ``labels``."""
    sigma_safe = torch.where(sigma > 0, sigma, 1.0)
    delta = torch.zeros_like(sigma)
    for d in range(depth - 1, 0, -1):
        up, here = labels == d + 1, labels == d
        x = torch.where(up, (1.0 + delta) / sigma_safe, 0.0)
        delta = torch.where(here, delta + sigma_safe * push(x, up, here),
                            delta)
    return delta


def _segment_advances(graph: Graph):
    """(pull, push) as scatter sums over the graph's CSC and CSR orders."""
    V = graph.n_vertices
    csc_src, csc_dst = graph.csc_rows.long(), graph.csc_dst.long()
    src, dst = graph.edge_src.long(), graph.col_indices.long()

    def summed(x, take, into):
        return torch.zeros((V, *x.shape[1:]), dtype=x.dtype,
                           device=x.device).index_add_(0, into, x[take])

    return (lambda x, front, unreached: summed(x, csc_src, csc_dst),
            lambda x, up, here: summed(x, dst, src))


def bc_forward(graph: Graph, single_source: int):
    """Forward sweep. Returns (labels int32[V], sigma f32[V], depth)."""
    return _forward(graph, int(single_source), _segment_advances(graph)[0])


def _finish(delta, sources):
    """0.5-scaled dependencies with each source's own entry zeroed; a
    batch is summed over its sources."""
    if isinstance(sources, int):
        delta[sources] = 0.0
        return 0.5 * delta
    s = torch.as_tensor(sources, dtype=torch.int64, device=delta.device)
    delta[s, torch.arange(s.numel(), device=delta.device)] = 0.0
    return 0.5 * delta.sum(dim=1)


def _bc(graph: Graph, sources, pull, push) -> torch.Tensor:
    labels, sigma, depth = _forward(graph, sources, pull)
    return _finish(_backward(labels, sigma, depth, push), sources)


def bc_kernel(graph: Graph, single_source: int) -> torch.Tensor:
    """Single-source BC in plain tensor ops. Returns f32[V] (0.5-scaled,
    source excluded: reference bc.hxx:160-180)."""
    return _bc(graph, int(single_source), *_segment_advances(graph))


def bc_kernel_pallas(graph: Graph, single_source: int, pull_layout,
                     push_layout) -> torch.Tensor:
    """Single-source BC on the frontier-sparse semiring kernel: one
    doubly-masked plus_times pass per forward level (the frontier's sigma
    into the unreached rows) and one per backward level (level d+1 into
    level d), so the chunks outside both masks are skipped. Same contract
    as :func:`bc_kernel`."""
    def pull(x, front, unreached):
        return bucketed_semiring_spmv_sparse(
            pull_layout, x, front, "plus_times", out_mask=unreached)

    def push(x, up, here):
        return bucketed_semiring_spmv_sparse(
            push_layout, x, up, "plus_times", out_mask=here)

    return _bc(graph, int(single_source), pull, push)


def bc_batch_kernel(graph: Graph, sources, pull_layout=None,
                    push_layout=None) -> torch.Tensor:
    """BC from K sources at once through the bucketed SpMM, one column per
    source. Returns the summed 0.5-scaled contributions f32[V] of these
    sources."""
    if pull_layout is None or push_layout is None:
        pull_layout, push_layout = _bc_layouts(graph)
    return _bc(graph, [int(s) for s in sources],
               lambda x, front, unreached: bucketed_spmm(pull_layout, x),
               lambda x, up, here: bucketed_spmm(push_layout, x))


def _bc_layouts(graph: Graph):
    """The unit-weight pull (rows = dst) and push (rows = src) layouts:
    the cache entries BFS, PPR, k-core and HITS use."""
    return pull_layout(graph, unit=True), push_layout(graph, unit=True)


def run(graph: Graph, single_source: int, options: Options | None = None,
        warmup: bool = True, device=DEFAULT) -> Result:
    """Role of reference ``bc::run`` single-source (bc.hxx:276-292) on
    ``device``. With ``options.load_balance == PALLAS_MERGE_PATH`` (the
    default) the levels run through the frontier-sparse kernel, else
    through :func:`bc_kernel`."""
    graph = graph.to(device)
    if not 0 <= int(single_source) < graph.n_vertices:
        raise ValueError(f"source {single_source} outside "
                         f"[0, {graph.n_vertices})")
    if options is None:
        options = default_options()
    if options.load_balance == LoadBalance.PALLAS_MERGE_PATH and graph.n_edges:
        layouts = _bc_layouts(graph)

        def fn():
            return bc_kernel_pallas(graph, single_source, *layouts)
    else:
        def fn():
            return bc_kernel(graph, single_source)
    bc, elapsed_ms = timed(graph.device, fn, warmup)
    return Result(bc_values=bc, elapsed_ms=elapsed_ms)


def _all_sources(graph: Graph, chunk_size: int, one_chunk) -> Result:
    V = graph.n_vertices

    def fn():
        total = torch.zeros(V, dtype=torch.float32, device=graph.device)
        for s0 in range(0, V, chunk_size):
            total += one_chunk(range(s0, min(s0 + chunk_size, V)))
        return total

    bc, elapsed_ms = timed(graph.device, fn, warmup=False)
    return Result(bc_values=bc, elapsed_ms=elapsed_ms)


def run_all_sources_spmm(graph: Graph, chunk_size: int = 64,
                         warmup: bool = True, device=DEFAULT) -> Result:
    """BC over every source through the batched SpMM kernel, ``chunk_size``
    sources at a time. (No padded last chunk: the SpMM takes any K.)"""
    del warmup  # the first chunk warms the rest
    graph = graph.to(device)
    layouts = _bc_layouts(graph)
    return _all_sources(graph, chunk_size,
                        lambda srcs: bc_batch_kernel(graph, srcs, *layouts))


def run_all_sources(graph: Graph, chunk_size: int = 32, warmup: bool = True,
                    device=DEFAULT) -> Result:
    """BC from every source (role of reference ``bc::run(G, bc_values)``,
    bc.hxx:304-321): chunks of sources as the columns of the plain
    kernel's state, summed."""
    del warmup
    graph = graph.to(device)
    advances = _segment_advances(graph)
    return _all_sources(graph, chunk_size,
                        lambda srcs: _bc(graph, list(srcs), *advances))
