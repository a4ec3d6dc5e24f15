"""Device sort strategies (port of ``gunrock_tpu/ops/sort.py``; role of
reference ``algorithms/sort/radix_sort.hxx`` and ``stable_sort.hxx``).

``torch.sort(stable=True)`` is the primitive. A lexicographic sort by
several keys is a chain of stable one-key sorts from the minor key to the
major one, which gives the order of ``jax.lax.sort(num_keys=k)`` exactly
(that sort is stable too). The JAX package's ``two_pass`` knob and its
``GUNROCK_LEX2PASS`` variable pick between two lowerings of the same
order on the TPU; the port has the one lowering, so it takes
``two_pass`` and ignores it, and reads no such variable.
"""

from __future__ import annotations

import torch


def lex_sort(operands: tuple, num_keys: int = 2, two_pass: bool | None = None):
    """Stable lexicographic sort of the 1-D tensors ``operands`` by the
    first ``num_keys`` of them (the rest are payload). Returns the tuple
    of sorted tensors. ``two_pass`` is JAX's choice of lowering; both of
    its lowerings give this order, so it is ignored."""
    del two_pass
    operands = tuple(operands)
    perm = None
    for key in reversed(operands[:num_keys]):
        k = key if perm is None else key[perm]
        idx = torch.sort(k, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return tuple(op[perm] for op in operands)


def stable_sort_by(*operands, num_keys: int = 1):
    """Stable lexicographic sort of ``operands`` by the first ``num_keys``
    of them (reference sort/stable_sort.hxx)."""
    return lex_sort(tuple(operands), num_keys=num_keys)


def sort_keys(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of a key tensor (reference radix_sort.hxx:39-47
    ``sort::radix::sort_keys``)."""
    return torch.sort(keys).values


def sort_pairs(keys: torch.Tensor, values: torch.Tensor):
    """Key-value pair sort ascending by key, stable (reference
    radix_sort.hxx:49-62 ``sort::radix::sort_pairs``). Returns
    (keys, values)."""
    return lex_sort((keys, values), num_keys=1)
