"""Binary search (port of ``gunrock_tpu/ops/search.py``; role of
reference ``search/binary_search.hxx:43-60``): a vectorized
``searchsorted`` and a fixed-trip-count bounded search, which runs under
``torch.func.vmap`` as the JAX one runs under ``vmap``/``while_loop``."""

from __future__ import annotations

import torch


def binary_search(sorted_arr: torch.Tensor, needles, side: str = "left"):
    """Vectorized lower (``side='left'``) or upper bound, int32."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    needles = torch.as_tensor(needles, dtype=sorted_arr.dtype,
                              device=sorted_arr.device)
    return torch.searchsorted(sorted_arr, needles,
                              right=side == "right").to(torch.int32)


def bounded_binary_search(arr: torch.Tensor, needle, lo, hi,
                          steps: int = 32):
    """Lower bound of ``needle`` within ``arr[lo:hi]`` in ``steps`` fixed
    halvings (reference ``search::binary::execute``): no host read, no
    data-dependent branch."""
    lo = torch.as_tensor(lo, device=arr.device)
    hi = torch.as_tensor(hi, device=arr.device)
    last = arr.shape[0] - 1
    for _ in range(steps):
        active = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        go_right = arr[torch.clamp(mid, max=last)] < needle
        new_lo = torch.where(go_right, mid + 1, lo)
        new_hi = torch.where(go_right, hi, mid)
        lo = torch.where(active, new_lo, lo)
        hi = torch.where(active, new_hi, hi)
    return lo
