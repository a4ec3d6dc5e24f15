"""Sentinels (the part of ``gunrock_tpu/utils/limits.py`` the port uses)."""

from __future__ import annotations

import numpy as np

# 'not yet reached' hop distance: the min-reduction identity of int32
UNREACHED = int(np.iinfo(np.int32).max)
