"""DIMACS10 ``delaunay_nX``: the Delaunay triangulation of ``2**log2_n``
points uniform in the unit square. The points are drawn on the device;
the triangulation is scipy's (Qhull) on the host. Parameter: ``log2_n``."""

from __future__ import annotations

import numpy as np
import torch

from portbench.graphs import EdgeList, symmetric, torch_generator


def generate(cfg: dict, seed: int, device) -> EdgeList:
    from scipy.spatial import Delaunay

    n = 1 << int(cfg["log2_n"])
    gen = torch_generator(seed, device)
    pts = torch.rand((n, 2), generator=gen, device=device, dtype=torch.float64)
    simplices = torch.from_numpy(
        Delaunay(pts.cpu().numpy()).simplices.astype(np.int64)).to(device)
    u = simplices.flatten()
    v = simplices[:, [1, 2, 0]].flatten()
    return symmetric(u, v, n, gen)
