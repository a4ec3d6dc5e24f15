"""Sorted-segment reductions (port of ``gunrock_tpu/ops/segment.py``).

For segments sorted by key (the CSR/CSC edge orders), a sum is a
cumulative-sum difference at the segment offsets: one prefix scan and two
gathers, deterministic on every device.
"""

from __future__ import annotations

import torch

from gunrock_tpu_torch.utils.limits import reduce_identity


def seg_sum_sorted(values: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of ``values`` (ordered by segment, any trailing
    shape) split by ``offsets`` (int[S+1]).

    Precision note: the global f32 prefix carries the *total* magnitude,
    so per-segment results inherit ~ulp(total) absolute error. Fine for
    normalized quantities (ranks, probabilities, int counts). The prefix
    keeps ``values``' dtype (torch would widen int32 to int64), as JAX's
    does: an int32 segment sum is exact where it fits in int32, whatever
    the total (the differences wrap back)."""
    ce = torch.cat([
        torch.zeros((1,) + tuple(values.shape[1:]), dtype=values.dtype,
                    device=values.device),
        torch.cumsum(values, dim=0, dtype=values.dtype),
    ])
    offs = offsets.long()
    return ce[offs[1:]] - ce[offs[:-1]]


def seg_count_sorted(mask: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per-segment True counts (int32)."""
    return seg_sum_sorted(mask.to(torch.int32), offsets).to(torch.int32)


_SCATTER_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}


def segment_reduce(values: torch.Tensor, seg: torch.Tensor, num_segments: int,
                   reduce: str) -> torch.Tensor:
    """Per-segment ``reduce`` ('min' | 'max' | 'sum') of ``values`` keyed
    by ``seg``, as ``jax.ops.segment_{min,max,sum}``: a segment with no
    value holds the reduction's identity (0; +inf/-inf for floats, int
    max/min for ints). A scatter into an identity-filled tensor, so the
    sum accumulates each segment on its own (in any order on the card)."""
    if reduce not in _SCATTER_REDUCE:
        raise ValueError(f"unknown reduction {reduce!r}")
    ident = reduce_identity(values.dtype, reduce, values.device)
    # out of place, so that it runs under torch.func.vmap (ops/batch.py)
    return ident.expand(num_segments).scatter_reduce(
        0, seg.long(), values, reduce=_SCATTER_REDUCE[reduce],
        include_self=True)
