"""Uniquify: frontier deduplication (port of
``gunrock_tpu/ops/uniquify.py``; role of reference
``operators/uniquify/uniquify.hxx:27-94``, a sort and ``thrust::unique``
with a ``best_effort`` mode that dedups only adjacent runs).

- ``SCATTER`` (the default): exact; each vertex keeps its first
  occurrence in queue order (a scatter-min of slot ids per vertex).
- ``UNIQUE``/``UNIQUE_COPY``: sort, then drop adjacent repeats; the
  result is ascending. ``best_effort`` with ``UNIQUE`` skips the sort.

Both compact by a cumsum scatter and read nothing back to the host.
"""

from __future__ import annotations

import torch

from gunrock_tpu_torch.framework import frontier
from gunrock_tpu_torch.ops.configs import UniquifyAlgorithm
from gunrock_tpu_torch.utils.limits import INVALID_VERTEX


def uniquify(
    data: torch.Tensor,
    count: torch.Tensor,
    n_vertices: int,
    algorithm: UniquifyAlgorithm = UniquifyAlgorithm.SCATTER,
    best_effort: bool = False,
):
    """Deduplicate a padded queue frontier. Returns ``(data, count)``."""
    capacity = data.shape[0]
    dev = data.device
    live = frontier.live_slots(data, count)

    if algorithm == UniquifyAlgorithm.SCATTER:
        idx = torch.arange(capacity, dtype=torch.int32, device=dev)
        at = frontier.spare_slots(data, live, n_vertices)
        slot = torch.full((n_vertices + capacity,), capacity,
                          dtype=torch.int32, device=dev)
        slot.scatter_reduce_(0, at, idx, reduce="amin", include_self=True)
        keep = live & (slot[at] == idx)
    else:
        # padding keyed to int max sorts to the end
        big = torch.iinfo(data.dtype).max
        keyed = torch.where(live, data, big)
        if best_effort and algorithm == UniquifyAlgorithm.UNIQUE:
            sorted_data = keyed
        else:
            sorted_data = torch.sort(keyed).values
        prev = torch.cat([sorted_data.new_full((1,), int(INVALID_VERTEX)),
                          sorted_data[:-1]])
        keep = (sorted_data != prev) & (sorted_data != big)
        data = sorted_data
    out, n = frontier.compact(data, keep, capacity)
    return out.to(data.dtype), n.to(count.dtype)
