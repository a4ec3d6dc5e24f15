"""Print helpers (copy of ``gunrock_tpu/utils/print_utils.py``; role of
reference util/print.hxx:32-43)."""

from __future__ import annotations

import numpy as np


def head(vec, k: int = 10, name: str = "") -> None:
    """Print the first ``k`` elements (reference ``print::head``). A torch
    tensor is read back to the host first."""
    if hasattr(vec, "detach"):
        vec = vec.detach().cpu().numpy()
    a = np.asarray(vec)
    label = f"{name}[:{k}]" if name else f"[:{k}]"
    print(f"{label} = {a[:k]}")
