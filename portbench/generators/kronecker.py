"""Graph500 Kronecker generator (spec v3, section 3): ``edge_factor *
2**scale`` edge tuples, each of whose ``scale`` bit levels picks a quadrant
with probabilities a, b, c and d = 1 - a - b - c; vertex labels randomly
permuted; then made undirected. Parameters: ``scale``, ``edge_factor``,
``a``, ``b``, ``c``."""

from __future__ import annotations

import torch

from portbench.graphs import EdgeList, symmetric, torch_generator


def generate(cfg: dict, seed: int, device) -> EdgeList:
    scale, ef = int(cfg["scale"]), int(cfg["edge_factor"])
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    n, m = 1 << scale, ef << scale
    gen = torch_generator(seed, device)
    rows = torch.zeros(m, dtype=torch.int64, device=device)
    cols = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        r = torch.rand(m, generator=gen, device=device)
        # quadrant a = (0, 0), b = (0, 1), c = (1, 0), d = (1, 1)
        rows |= (r >= a + b).to(torch.int64) << bit
        cols |= (((r >= a) & (r < a + b)) | (r >= a + b + c)).to(
            torch.int64) << bit
    perm = torch.randperm(n, generator=gen, device=device)
    return symmetric(perm[rows], perm[cols], n, gen)
