"""Predecessors of a single-source search from its distances, one pass for
BFS and SSSP: ``pred[v]`` is the smallest in-neighbour ``u`` of ``v`` that
is tight for ``v``, -1 where ``v`` is unreached or has none. The two
searches differ only in the tightness test and in what marks a vertex
unreached:

    BFS  (int32):   dist[u] != UNREACHED and dist[u] + 1 == dist[v];
                    unreached: dist[v] == UNREACHED
    SSSP (float32): torch.isclose(dist[u] + w, dist[v], rtol=1e-5,
                    atol=1e-8) and dist[u] < inf; unreached: dist[v] inf

On the CPU both run :func:`predecessors_plain`, the JAX package's segment
min over the CSC order (a gather over every slot and a scatter-min). On
the card both launch ``csrc/predecessors.cu``: each vertex's CSC run is
scanned in ascending slot order, by a lane, a warp or a whole block as
its length asks, and the scan stops at the first tight slot. CSC slots
are sorted by (dst, src) (``graph/graph.py``), so that slot holds the
smallest tight source and the kernel's answer is the plain pass's, bit
for bit. One launch, no global atomic, no host sync; ``pred`` is its only
allocation.

No TPU kernel: the JAX package leaves this pass to XLA.
"""

from __future__ import annotations

import ctypes

import torch

from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.utils.limits import UNREACHED
from gunrock_tpu_torch.utils.profiler import annotate

_NONE = torch.iinfo(torch.int32).max  # no tight source; BFS's UNREACHED
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gr_bfs_predecessors": [_P, _P, _P, _P, _I, _I, _I, _P],
    "gr_sssp_predecessors": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def _bfs_tight(d_src, d_dst, w):
    del w
    return (d_src != UNREACHED) & (d_src + 1 == d_dst)


def _sssp_tight(d_src, d_dst, w):
    return torch.isclose(d_src + w, d_dst, rtol=1e-5, atol=1e-8) & (
        d_src < float("inf"))


# kind: (distances' dtype, tightness test, unreached test)
_KINDS = {
    "bfs": (torch.int32, _bfs_tight, lambda d: d == UNREACHED),
    "sssp": (torch.float32, _sssp_tight, torch.isinf),
}


def bfs_predecessors(graph, distances) -> torch.Tensor:
    """int32[V]: each vertex's smallest in-neighbour one level closer to
    the source, -1 for the source and unreached vertices. ``distances``:
    int32[V], UNREACHED where unreached. CUDA source:
    ``csrc/predecessors.cu`` (``gr_bfs_predecessors``)."""
    return _predecessors(graph, distances, "bfs")


def sssp_predecessors(graph, distances) -> torch.Tensor:
    """int32[V]: each vertex's smallest in-neighbour ``u`` with
    ``distances[u] + w`` close to its distance (``torch.isclose`` at rtol
    1e-5, atol 1e-8), -1 for the source and unreached vertices.
    ``distances``: float32[V], +inf where unreached. CUDA source:
    ``csrc/predecessors.cu`` (``gr_sssp_predecessors``)."""
    return _predecessors(graph, distances, "sssp")


def _predecessors(graph, distances, kind: str) -> torch.Tensor:
    name = f"{kind}_predecessors"
    with annotate(f"kernel.{name}"):
        dev = graph.device
        V = graph.n_vertices
        _build.check_tensor(distances, "distances", _KINDS[kind][0], (V,),
                            dev)
        if dev.type == "cpu":
            return predecessors_plain(graph, distances, kind)
        if dev.type != "cuda":
            raise ValueError(f"no predecessor kernel for device {dev}")
        pred = torch.empty(V, dtype=torch.int32, device=dev)
        lib = _build.load("predecessors", _SIGNATURES)
        values = (_build.ptr(graph.csc_values),) if kind == "sssp" else ()
        err = getattr(lib, f"gr_{name}")(
            _build.ptr(graph.csc_offsets), _build.ptr(graph.csc_rows),
            *values, _build.ptr(distances), _build.ptr(pred), V,
            graph.n_edges, _build.sm_count(dev), _build.stream(dev),
        )
        _build.check(err, name)
        _build.LAUNCHES[name] += 1
        return pred


def tight_slots(graph, distances, kind: str) -> torch.Tensor:
    """bool[E]: whether CSC slot k's source is tight for its destination
    (``kind`` "bfs" or "sssp"; see the module docstring)."""
    tight = _KINDS[kind][1]
    return tight(distances[graph.csc_rows.long()],
                 distances[graph.csc_dst.long()], graph.csc_values)


def unreached(distances, kind: str) -> torch.Tensor:
    """bool[V]: the vertices the search did not reach."""
    return _KINDS[kind][2](distances)


def predecessors_plain(graph, distances, kind: str) -> torch.Tensor:
    """Plain PyTorch version of :func:`bfs_predecessors` (``kind="bfs"``)
    and :func:`sssp_predecessors` (``kind="sssp"``): the tightness test
    over every CSC slot, then a scatter-min of the tight sources."""
    ok = tight_slots(graph, distances, kind)
    pred = torch.full(distances.shape, _NONE, dtype=torch.int32,
                      device=distances.device).scatter_reduce_(
        0, graph.csc_dst.long(), torch.where(ok, graph.csc_rows, _NONE),
        "amin")
    return torch.where((pred == _NONE) | unreached(distances, kind), -1,
                       pred).to(torch.int32)
