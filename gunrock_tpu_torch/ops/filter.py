"""Filter: predicate-driven frontier pruning (port of
``gunrock_tpu/ops/filter.py``; role of reference
``operators/filter/filter.hxx``).

- ``bypass`` (bypass.hxx:13-69): failures are marked invalid in place, no
  compaction; for a dense mask frontier a plain AND.
- ``predicated``/``remove``: compaction into a new padded queue by a
  cumsum scatter (``framework/frontier.compact``), in place of
  ``thrust::copy_if``. No host read.
"""

from __future__ import annotations

from typing import Callable

import torch

from gunrock_tpu_torch.framework import frontier
from gunrock_tpu_torch.utils.limits import INVALID_VERTEX


def filter_mask(frontier_mask: torch.Tensor, pred_mask: torch.Tensor):
    """Bypass filter over a dense mask frontier: keep where pred holds."""
    return frontier_mask & pred_mask


def filter_queue(data: torch.Tensor, count: torch.Tensor, pred: Callable,
                 compact: bool = True):
    """Filter a padded queue frontier. Returns ``(data, count)``.

    ``pred(items) -> bool`` is evaluated over the whole buffer; invalid
    and padding entries are always dropped (filter.hxx:17-30). With
    ``compact=False`` this is the bypass strategy: failures become
    ``INVALID_VERTEX`` in place and ``count`` is kept."""
    keep = frontier.live_slots(data, count) & pred(data)
    if not compact:
        return torch.where(keep, data, int(INVALID_VERTEX)), count
    out, n = frontier.compact(data, keep, data.shape[0])
    return out.to(data.dtype), n.to(count.dtype)
