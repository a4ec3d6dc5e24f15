"""SpMV: y = A.x over the CSR graph.

Port of ``gunrock_tpu/algorithms/spmv.py`` (role of reference
``algorithms/spmv.hxx``): ``y[src] += w * x[nbr]`` over every edge. The
main path (:func:`run` with the default options) is the dense plus_times
pass over the valued push layout at W=2048/C=256
(``ops/kernels/spmv.py``); otherwise a plain segment sum.
"""

from __future__ import annotations

import dataclasses

import torch

from gunrock_tpu_torch.device import DEFAULT
from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.configs import LoadBalance, Options, default_options
from gunrock_tpu_torch.ops.kernels import spmv as kspmv
from gunrock_tpu_torch.ops.kernels.layout import push_layout
from gunrock_tpu_torch.ops.kernels.spmm import bucketed_spmm
from gunrock_tpu_torch.utils.timer import timed


@dataclasses.dataclass
class Param:
    pass


@dataclasses.dataclass
class Result:
    y: torch.Tensor  # float32[V]
    elapsed_ms: float


def _segment_sum(values, keys, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.float32, device=values.device).index_add_(
        0, keys.long(), values)


def spmv_kernel(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """y = A.x in plain tensor ops (push formulation)."""
    contrib = graph.values * x[graph.col_indices.long()]
    return _segment_sum(contrib, graph.edge_src, graph.n_vertices)


def spmv_pull_kernel(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """Pull variant in CSC order: y[v] = sum over in-edges (u, v) of
    w * x[u], i.e. A^T.x (equal to A.x on a symmetric graph)."""
    contrib = graph.csc_values * x[graph.csc_rows.long()]
    return _segment_sum(contrib, graph.csc_dst, graph.n_vertices)


def spmm_kernel(graph: Graph, X, layout=None) -> torch.Tensor:
    """Y = A.X for a dense X[V, K] through the bucketed SpMM over the
    graph's push layout."""
    if layout is None:
        layout = push_layout(graph)
    X = torch.as_tensor(X, dtype=torch.float32, device=graph.device)
    return bucketed_spmm(layout, X.contiguous())


def run(graph: Graph, x, options: Options | None = None, warmup: bool = True,
        device=DEFAULT) -> Result:
    """Role of reference ``spmv::run`` on ``device``."""
    graph = graph.to(device)
    options = options or default_options()
    x = torch.as_tensor(x, dtype=torch.float32, device=graph.device).contiguous()
    if options.load_balance == LoadBalance.PALLAS_MERGE_PATH:
        def fn():
            return kspmv.spmv(graph, x)
    else:
        def fn():
            return spmv_kernel(graph, x)
    y, elapsed_ms = timed(graph.device, fn, warmup)
    return Result(y=y, elapsed_ms=elapsed_ms)
