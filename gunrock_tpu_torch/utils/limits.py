"""Invalid sentinels and reduction identities (port of
``gunrock_tpu/utils/limits.py``; role of reference
``util/type_limits.hxx:16-71``).

- signed integers  -> -1
- unsigned integers -> max value
- floats           -> NaN

A fixed-capacity queue is padded with ``invalid()`` entries and every
operator skips them. The functions that make a tensor take ``device=``
(default ``"cuda"``); operators pass the device of their inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from gunrock_tpu_torch.device import DEFAULT, resolve

# 'not yet reached' hop distance: the min-reduction identity of int32
UNREACHED = int(np.iinfo(np.int32).max)

# canonical sentinels for the default vertex/edge dtype (int32)
INVALID_VERTEX = np.int32(-1)
INVALID_EDGE = np.int32(-1)

_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def _scalar(value, dtype, device) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=resolve(device))


def invalid(dtype, device=DEFAULT) -> torch.Tensor:
    """The invalid sentinel for ``dtype`` as a 0-d tensor (signed -1,
    unsigned max, float NaN, bool False)."""
    if dtype.is_floating_point:
        return _scalar(float("nan"), dtype, device)
    if dtype == torch.bool:
        return _scalar(False, dtype, device)
    if dtype in _UNSIGNED:
        return _scalar(torch.iinfo(dtype).max, dtype, device)
    if not dtype.is_complex:
        return _scalar(-1, dtype, device)
    raise TypeError(f"no invalid sentinel for dtype {dtype}")


def is_valid(x: torch.Tensor) -> torch.Tensor:
    """Elementwise validity test (reference util/type_limits.hxx:61-71)."""
    if x.dtype.is_floating_point:
        return ~torch.isnan(x)
    if x.dtype == torch.bool:
        return x
    if x.dtype in _UNSIGNED:
        return x != torch.iinfo(x.dtype).max
    if not x.dtype.is_complex:
        return x >= 0
    raise TypeError(f"no validity test for dtype {x.dtype}")


def reduce_identity(dtype, reduce: str, device=DEFAULT) -> torch.Tensor:
    """Identity of a segmented reduction over ``dtype``, a 0-d tensor:
    inactive edges contribute it, in place of the reference's conditional
    atomics. An empty segment reduces to it."""
    if reduce in ("sum", "add"):
        return _scalar(0, dtype, device)
    if reduce in ("min", "max"):
        if dtype.is_floating_point:
            inf = float("inf")
            return _scalar(inf if reduce == "min" else -inf, dtype, device)
        info = torch.iinfo(dtype)
        return _scalar(info.max if reduce == "min" else info.min, dtype,
                       device)
    if reduce in ("or", "any"):
        return _scalar(False, torch.bool, device)
    raise ValueError(f"unknown reduction {reduce!r}")


def unreached(dtype, device=DEFAULT) -> torch.Tensor:
    """'Not yet reached' distances and labels: the min identity (int max,
    +inf), so that min-updates behave like the reference's ``atomic::min``
    on fresh arrays."""
    return reduce_identity(dtype, "min", device)
