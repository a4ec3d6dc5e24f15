"""Frontier containers (port of ``gunrock_tpu/framework/frontier.py``).

The reference's frontier is a device vector with a host-tracked element
count, over-allocated and padded with invalid sentinels (reference
``framework/frontier/vector_frontier.hxx:28-311``). Both designs of the
JAX package are here:

- ``DenseFrontier``: a ``bool[V]`` vertex mask, the default of the
  algorithms;
- ``QueueFrontier``: a fixed-capacity padded queue, ``data`` int32 with
  live elements in ``[0, count)`` and ``INVALID_VERTEX`` elsewhere.
  ``count`` is a 0-d int32 tensor on the data's device, so a loop over
  queue operators reads the device once per round, where it tests
  ``is_empty()``.

Every mutator returns a new frontier and leaves its input untouched.
No method reads the device back to the host but ``print``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gunrock_tpu_torch.device import DEFAULT, resolve
from gunrock_tpu_torch.utils.limits import INVALID_VERTEX, is_valid


def live_slots(data: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Slots in the live prefix that hold a valid element."""
    idx = torch.arange(data.shape[0], device=data.device)
    return (idx < count) & is_valid(data)


def spare_slots(index: torch.Tensor, use: torch.Tensor, n: int) -> torch.Tensor:
    """``index`` where ``use``, else a slot of its own past ``n`` (n + the
    position): a scatter into a buffer of ``n + len(index)`` then sends
    every unused entry to a distinct address, so the card never serializes
    them on one (a padded queue is mostly unused)."""
    spare = n + torch.arange(index.shape[0], device=index.device)
    return torch.where(use, index.long(), spare)


def compact(items: torch.Tensor, keep: torch.Tensor, capacity: int):
    """(out, count): ``items[keep]`` packed in order into the front of an
    ``INVALID_VERTEX``-padded int32[capacity] by a cumsum scatter, and the
    number kept (which may exceed ``capacity``; the excess is dropped).
    No host read."""
    pos = torch.cumsum(keep, 0, dtype=torch.int64) - 1
    slot = spare_slots(pos, keep & (pos < capacity), capacity)
    out = torch.full((capacity + items.shape[0],), int(INVALID_VERTEX),
                     dtype=torch.int32, device=items.device)
    out.scatter_(0, slot, items.to(torch.int32))
    return out[:capacity], keep.sum(dtype=torch.int32)


def queue_to_mask(data: torch.Tensor, count: torch.Tensor,
                  n_vertices: int) -> torch.Tensor:
    """Scatter a padded queue into a dense bool mask."""
    live = live_slots(data, count)
    mask = torch.zeros(n_vertices + data.shape[0], dtype=torch.bool,
                       device=data.device)
    # every write is True, so repeated vertices need no atomics
    return mask.scatter_(0, spare_slots(data, live, n_vertices), True)[
        :n_vertices]


def mask_to_queue(mask: torch.Tensor, capacity: int):
    """Compact a dense mask into an ascending padded queue. Returns
    ``(data, count)``; ``count`` is ``sum(mask)`` even when it exceeds
    ``capacity`` (the queue then holds the first ``capacity`` vertices)."""
    ids = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    return compact(ids, mask, capacity)


@dataclasses.dataclass
class DenseFrontier:
    """Dense vertex mask frontier, the algorithms' default."""

    mask: torch.Tensor  # bool[V]

    @staticmethod
    def empty(n_vertices: int, device=DEFAULT) -> "DenseFrontier":
        return DenseFrontier(torch.zeros(n_vertices, dtype=torch.bool,
                                         device=resolve(device)))

    @staticmethod
    def single(n_vertices: int, v, device=DEFAULT) -> "DenseFrontier":
        f = DenseFrontier.empty(n_vertices, device)
        f.mask[v] = True
        return f

    @staticmethod
    def all(n_vertices: int, device=DEFAULT) -> "DenseFrontier":
        return DenseFrontier(torch.ones(n_vertices, dtype=torch.bool,
                                        device=resolve(device)))

    def get_number_of_elements(self) -> torch.Tensor:
        return self.mask.sum(dtype=torch.int32)

    def is_empty(self) -> torch.Tensor:
        return ~self.mask.any()


@dataclasses.dataclass
class QueueFrontier:
    """Fixed-capacity padded vertex/edge queue with an invalid sentinel
    (the reference ``vector_frontier_t``)."""

    data: torch.Tensor  # int32[capacity]
    count: torch.Tensor  # int32, 0-d, on data's device

    # -- construction ---------------------------------------------------
    @staticmethod
    def with_capacity(capacity: int, device=DEFAULT) -> "QueueFrontier":
        dev = resolve(device)
        return QueueFrontier(
            torch.full((capacity,), int(INVALID_VERTEX), dtype=torch.int32,
                       device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))

    @staticmethod
    def from_list(items, capacity: int, device=DEFAULT) -> "QueueFrontier":
        """A queue holding ``items`` (a list, numpy array or tensor)."""
        if isinstance(items, torch.Tensor):
            items = items.cpu().numpy()
        items = np.asarray(items, dtype=np.int32).reshape(-1)
        data = np.full(capacity, INVALID_VERTEX, dtype=np.int32)
        data[: items.shape[0]] = items
        dev = resolve(device)
        return QueueFrontier(torch.from_numpy(data).to(dev),
                             torch.tensor(items.shape[0], dtype=torch.int32,
                                          device=dev))

    # -- accessors (vector_frontier.hxx:112-160) ------------------------
    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def get_number_of_elements(self) -> torch.Tensor:
        return self.count

    def is_empty(self) -> torch.Tensor:
        return self.count == 0

    def get_element_at(self, i) -> torch.Tensor:
        return self.data[i]

    def set_element_at(self, i, v) -> "QueueFrontier":
        data = self.data.clone()
        data[i] = v
        return QueueFrontier(data, self.count)

    def live_mask(self) -> torch.Tensor:
        return live_slots(self.data, self.count)

    # -- mutators (vector_frontier.hxx:204-292) -------------------------
    def push_back(self, v) -> "QueueFrontier":
        """Append ``v`` at ``count``; past the capacity the element is
        dropped and the count still grows (as the JAX queue's)."""
        cap = self.capacity
        buf = torch.cat([self.data, self.data.new_full((1,), int(INVALID_VERTEX))])
        at = torch.clamp(self.count, max=cap).long().reshape(1)
        buf.scatter_(0, at, torch.as_tensor(v, dtype=buf.dtype,
                                            device=buf.device).reshape(1))
        return QueueFrontier(buf[:cap], self.count + 1)

    def fill(self, v) -> "QueueFrontier":
        return QueueFrontier(torch.full_like(self.data, v), self.count)

    def sequence(self, start: int, size: int) -> "QueueFrontier":
        """Fill with [start, start+size) (vector_frontier.hxx:236-254)."""
        idx = torch.arange(self.capacity, dtype=self.data.dtype,
                           device=self.data.device)
        data = torch.where(idx < size, idx + start, int(INVALID_VERTEX))
        return QueueFrontier(data.to(self.data.dtype),
                             torch.tensor(size, dtype=torch.int32,
                                          device=self.data.device))

    def sort(self) -> "QueueFrontier":
        """Ascending sort of the live elements; padding stays at the end."""
        big = torch.iinfo(self.data.dtype).max
        s = torch.sort(torch.where(self.live_mask(), self.data, big)).values
        return QueueFrontier(torch.where(s == big, int(INVALID_VERTEX), s),
                             self.count)

    def to_mask(self, n_vertices: int) -> torch.Tensor:
        return queue_to_mask(self.data, self.count, n_vertices)

    def print(self, name: str = "frontier", k: int = 40) -> None:  # noqa: A003
        head = self.data[:k].cpu().numpy()
        print(f"{name} (count={int(self.count)}): {head}")
