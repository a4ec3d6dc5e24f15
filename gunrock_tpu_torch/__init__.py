"""gunrock_tpu_torch — the PyTorch/CUDA port of gunrock_tpu.

The same frontier model and the same bucketed edge layout as the JAX
package, on torch tensors, with its TPU kernels rewritten as CUDA C++
kernels for Hopper (``csrc/``, built with ``nvcc`` at first use). It
imports torch and numpy and nothing of JAX or of ``gunrock_tpu``.

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise. ``device="cpu"`` runs every kernel's plain PyTorch version.

Layout (mirrors ``gunrock_tpu``):

- ``formats``     — host CSR/COO/CSC containers and conversions (numpy;
                    the counting sort native from 2^16 edges)
- ``_native``     — host C++ (``fast_io.cpp``, built with the host's C++
                    compiler at first use): the mmap .mtx parser and the
                    counting sort
- ``graph``       — the device Graph, ``build_graph``, ``degree_sort``
- ``io``          — Matrix Market / binary CSR loading, generators, sample
                    graphs, CLI flags
- ``ops.kernels`` — the bucketed layout and the CUDA kernels with their
                    plain versions
- ``ops``         — the operators (advance, filter, uniquify,
                    neighbor_reduce, parallel_for, batch), sorted-segment
                    sums, sorts, searches, random fills, operator options
- ``framework``   — frontier containers, the Enactor/Problem loop,
                    workload counters
- ``algorithms``  — BFS (direction-optimizing, multi-source), SSSP,
                    PageRank, HITS, SpMV, graph coloring, minimum spanning
                    tree, k-core, personalized PageRank, betweenness
                    centrality, SpGEMM, triangle counting, geolocation
- ``examples``    — the CLIs, their CPU oracles and the regression battery
- ``device``      — the device rule and the card's properties and peaks
- ``utils``       — comparison, timers, roofline, profiler traces and
                    their per-op stats, the metrics JSON export
- ``probes``      — drivers of the TPU probes' Hopper kernels
"""

__version__ = "0.1.0"

from gunrock_tpu_torch.graph import Graph, build_graph  # noqa: F401
from gunrock_tpu_torch.framework.frontier import DenseFrontier, QueueFrontier  # noqa: F401

# the algorithm modules and the high-level entry points, as gunrock_tpu
# re-exports them
from gunrock_tpu_torch import algorithms  # noqa: F401
from gunrock_tpu_torch.interop import (  # noqa: F401
    bc_run,
    bfs,
    bfs_run,
    color_run,
    geo_run,
    hits_run,
    kcore_run,
    mst_run,
    ppr_run,
    pr_run,
    spgemm_run,
    spmv_run,
    sssp,
    sssp_run,
    tc_run,
)
from gunrock_tpu_torch.ops.configs import Options  # noqa: F401
