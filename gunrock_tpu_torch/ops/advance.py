"""Advance: frontier expansion as gather, map and segmented reduction
(port of ``gunrock_tpu/ops/advance.py``; role of reference
``operators/advance/advance.hxx:102-275``).

The reference expands an input frontier to all neighbours, applying a
user lambda under per-edge atomics. Here, as in the JAX package:

1. **gather**: frontier activity and per-edge operands for every edge in
   one pass over the edge arrays;
2. **map**: the user's ``edge_op(src, dst, edge, weight)`` on whole
   tensors;
3. **reduce**: per-vertex results keyed by destination (forward, over the
   CSC order) or source (backward, over the CSR order). Sums are a
   cumsum difference at the offsets (``ops/segment.seg_sum_sorted``, as
   the JAX package); min and max a scatter into the identity.

:func:`advance_semiring` is the declarative form with the operator-level
runtime dispatch of the reference (``advance.hxx:247-275``):
``XLA_SEGMENT`` is plain tensor ops, ``PALLAS_MERGE_PATH`` runs the
bucketed semiring kernels of ``ops/kernels/semiring.py`` (CUDA on the
card, their plain versions on the CPU).
"""

from __future__ import annotations

from typing import Callable

import torch

from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.configs import AdvanceDirection, LoadBalance
from gunrock_tpu_torch.ops.kernels.layout import pull_layout, push_layout
from gunrock_tpu_torch.ops.kernels.semiring import (
    _BIG,
    bucketed_semiring_spmv,
    bucketed_semiring_spmv_sparse,
)
from gunrock_tpu_torch.ops.segment import (
    seg_count_sorted,
    seg_sum_sorted,
    segment_reduce,
)
from gunrock_tpu_torch.utils.limits import reduce_identity

def edge_map_reduce(
    graph: Graph,
    edge_values: torch.Tensor,
    active: torch.Tensor | None,
    reduce: str = "sum",
    by: str = "dst",
    edge_order: str = "csr",
) -> torch.Tensor:
    """Segmented combine of per-edge values into per-vertex values.

    ``edge_values``/``active`` are in CSR edge order (``edge_order='csr'``)
    or CSC slot order (``'csc'``); ``by`` picks the key. Inactive edges
    contribute the reduction identity."""
    if by == "dst" and edge_order == "csr":
        perm = graph.csc_edge_perm.long()
        edge_values = edge_values[perm]
        if active is not None:
            active = active[perm]
        seg = graph.csc_dst
    elif by == "dst" and edge_order == "csc":
        seg = graph.csc_dst
    elif by == "src" and edge_order == "csr":
        seg = graph.edge_src
    else:
        raise ValueError(f"unsupported combination by={by} edge_order={edge_order}")

    if active is not None:
        ident = reduce_identity(edge_values.dtype, reduce, edge_values.device)
        edge_values = torch.where(active, edge_values, ident)
    return segment_reduce(edge_values, seg, graph.n_vertices, reduce)


def advance(
    graph: Graph,
    frontier: torch.Tensor,
    edge_op: Callable,
    reduce: str = "min",
    direction: AdvanceDirection = AdvanceDirection.FORWARD,
    load_balance: LoadBalance = LoadBalance.XLA_SEGMENT,
    edge_frontier: bool = False,
):
    """Expand a frontier along edges and reduce per vertex.

    ``frontier`` is a ``bool[V]`` vertex mask, or a ``bool[E]`` mask over
    CSR edge ids with ``edge_frontier=True``. ``edge_op(src, dst, edge_id,
    weight) -> values`` sees int32/float32 tensors of all E edges.
    FORWARD reduces by destination over the out-edges of frontier
    vertices; BACKWARD reduces by source over the out-edges whose
    destination is in the frontier (pull). A Python ``edge_op`` always
    takes the plain tensor path, whatever ``load_balance`` says (a lambda
    cannot be staged into a kernel); :func:`advance_semiring` dispatches
    on it.

    Returns ``(reduced[V], touched bool[V])``: the reduced values (the
    identity where no active edge arrives) and the vertices that receive
    at least one active edge."""
    del load_balance
    if isinstance(edge_op, str):
        raise TypeError(
            "declarative semiring advance: call advance_semiring(graph, x, "
            f"semiring={edge_op!r}, ...) — it carries the x operand and "
            "dispatches between the plain and kernel paths")

    if direction == AdvanceDirection.FORWARD:
        # CSC slot order: sorted by destination
        src, dst = graph.csc_rows, graph.csc_dst
        eid, w = graph.csc_edge_perm, graph.csc_values
        seg, offsets = dst, graph.csc_offsets
    elif direction == AdvanceDirection.BACKWARD:
        # CSR edge order: sorted by source; frontier tested at destination
        src, dst = graph.edge_src, graph.col_indices
        eid = torch.arange(graph.n_edges, dtype=torch.int32,
                           device=graph.device)
        w = graph.values
        seg, offsets = src, graph.row_offsets
    else:
        raise ValueError(f"advance does not dispatch {direction} directly")

    if edge_frontier:
        active = frontier[eid.long()] if direction == AdvanceDirection.FORWARD \
            else frontier
    else:
        active = frontier[(src if direction == AdvanceDirection.FORWARD
                           else dst).long()]

    values = edge_op(src, dst, eid, w)
    ident = reduce_identity(values.dtype, reduce, values.device)
    masked = torch.where(active, values, ident)
    if reduce == "sum":
        reduced = seg_sum_sorted(masked, offsets)
    else:
        reduced = segment_reduce(masked, seg, graph.n_vertices, reduce)
    touched = seg_count_sorted(active, offsets) > 0
    return reduced, touched


_SEMIRINGS = ("plus_times", "min_plus", "max_times")


def advance_semiring(
    graph: Graph,
    x: torch.Tensor,
    semiring: str,
    frontier: torch.Tensor | None = None,
    direction: AdvanceDirection = AdvanceDirection.FORWARD,
    load_balance: LoadBalance = LoadBalance.XLA_SEGMENT,
    window: int = 2048,
    chunk: int = 256,
) -> torch.Tensor:
    """Declarative advance: a per-vertex semiring reduction over edges.

    - FORWARD (push): ``y[dst] = reduce over in-edges (src, dst) with src
      active of combine(w, x[src])``;
    - BACKWARD (pull): ``y[src] = reduce over out-edges (src, dst) with
      dst active of combine(w, x[dst])``.

    ``semiring``: ``plus_times`` (sum of w*x), ``min_plus`` (min of w+x),
    ``max_times`` (max of w*x, at least 0). With a ``frontier`` (bool[V])
    inactive x takes the gather identity (3.0e38 for min_plus, else 0),
    which the semiring absorbs. ``load_balance=PALLAS_MERGE_PATH`` runs
    the bucketed kernels over the graph's cached ``window``/``chunk``
    layout (FORWARD: the pull layout, rows = destinations; BACKWARD: the
    push layout; min_plus pads with 3.0e38 and takes its own entry): B3
    (``bucketed_semiring_spmv``) without a frontier, B1
    (``bucketed_semiring_spmv_sparse``, after B2's chunk plan) with one.
    On a CUDA tensor those launch their kernels or raise.

    Returns float32[V]: min_plus gives ``+inf`` where no active edge
    arrives, plus_times and max_times ``0``."""
    if semiring not in _SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}")
    if direction not in (AdvanceDirection.FORWARD, AdvanceDirection.BACKWARD):
        raise ValueError(f"advance_semiring does not dispatch {direction}")
    x = x.to(torch.float32)
    if frontier is not None:
        x = torch.where(frontier, x, _BIG if semiring == "min_plus" else 0.0)

    if load_balance == LoadBalance.PALLAS_MERGE_PATH:
        pad = _BIG if semiring == "min_plus" else 0.0
        make = pull_layout if direction == AdvanceDirection.FORWARD \
            else push_layout
        layout = make(graph, window=window, chunk=chunk, pad_value=pad)
        if frontier is not None:
            # chunks whose source window holds no active vertex are skipped
            return bucketed_semiring_spmv_sparse(layout, x, frontier, semiring)
        return bucketed_semiring_spmv(layout, x, semiring)

    # the plain segmented path
    if direction == AdvanceDirection.FORWARD:
        vals = x[graph.csc_rows.long()]
        w, seg, offsets = graph.csc_values, graph.csc_dst, graph.csc_offsets
    else:
        vals = x[graph.col_indices.long()]
        w, seg, offsets = graph.values, graph.edge_src, graph.row_offsets

    if semiring == "min_plus":
        msg = torch.clamp(w + vals, max=_BIG)
        reduced = segment_reduce(msg, seg, graph.n_vertices, "min")
        # >= _BIG: no active edge (empty segments reduce to +inf)
        return torch.where(reduced >= _BIG, torch.inf, reduced)
    msg = w * vals
    if semiring == "plus_times":
        return seg_sum_sorted(msg, offsets)
    reduced = segment_reduce(msg, seg, graph.n_vertices, "max")
    return torch.clamp(reduced, min=0.0)  # identity 0 for empty segments
