"""Sorted-segment reductions (port of ``gunrock_tpu/ops/segment.py``).

For segments sorted by key (the CSR/CSC edge orders), a sum is a
cumulative-sum difference at the segment offsets: one prefix scan and two
gathers, deterministic on every device.
"""

from __future__ import annotations

import torch


def seg_sum_sorted(values: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of ``values`` (ordered by segment, any trailing
    shape) split by ``offsets`` (int[S+1]).

    Precision note: the global f32 prefix carries the *total* magnitude,
    so per-segment results inherit ~ulp(total) absolute error. Fine for
    normalized quantities (ranks, probabilities, int counts)."""
    ce = torch.cat([
        torch.zeros((1,) + tuple(values.shape[1:]), dtype=values.dtype,
                    device=values.device),
        torch.cumsum(values, dim=0),
    ])
    offs = offsets.long()
    return ce[offs[1:]] - ce[offs[:-1]]


def seg_count_sorted(mask: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per-segment True counts (int32)."""
    return seg_sum_sorted(mask.to(torch.int32), offsets).to(torch.int32)
