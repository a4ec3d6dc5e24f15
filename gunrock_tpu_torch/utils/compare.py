"""Computed vs reference result comparison (copy of
``gunrock_tpu/utils/compare.py``): count mismatches, the workhorse of every
``--validate`` path."""

from __future__ import annotations

from typing import Callable

import numpy as np


def to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, possibly on the card
        return x.detach().cpu().numpy()
    return np.asarray(x)


def compare(
    result,
    reference,
    error_op: Callable | None = None,
    verbose: bool = False,
    atol: float = 1e-4,
) -> int:
    """Return the number of mismatching positions.

    ``error_op(computed, reference) -> bool ndarray`` marks errors; the
    default treats NaN==NaN and inf==inf as equal and floats within
    ``atol``/1e-4 relative as equal."""
    a = to_numpy(result)
    b = to_numpy(reference)
    if error_op is not None:
        errors = error_op(a, b)
    elif np.issubdtype(a.dtype, np.floating) or np.issubdtype(b.dtype, np.floating):
        both_nan = np.isnan(a.astype(float)) & np.isnan(b.astype(float))
        both_inf = np.isinf(a.astype(float)) & np.isinf(b.astype(float))
        close = np.isclose(a, b, rtol=1e-4, atol=atol)
        errors = ~(close | both_nan | both_inf)
    else:
        errors = a != b
    n = int(np.sum(errors))
    if verbose and n:
        for i in np.nonzero(errors)[0][:10]:
            print(f"  mismatch at {i}: computed={a[i]} reference={b[i]}")
    return n
