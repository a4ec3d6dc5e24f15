"""pygunrock-style API that fills caller-provided tensors (the BFS part of
``gunrock_tpu/interop.py``).

``bfs(graph, src, distances, predecessors)`` runs the search and writes
the results into the given tensors, returning elapsed milliseconds. A
CUDA tensor is filled device to device with ``tensor.copy_``; a CPU tensor
or a numpy array receives a copy of the result.
"""

from __future__ import annotations

import numpy as np
import torch

from gunrock_tpu_torch.device import DEFAULT
from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.configs import Options


def _fill(out, values: torch.Tensor) -> None:
    if out is None:
        return
    if isinstance(out, torch.Tensor):
        out.copy_(values)  # casts dtype, crosses devices as needed
        return
    if isinstance(out, np.ndarray):
        out[...] = values.cpu().numpy()
        return
    raise TypeError(f"unsupported output tensor type {type(out)!r}")


def bfs_run(graph: Graph, single_source: int, options: Options | None = None,
            device=DEFAULT):
    from gunrock_tpu_torch.algorithms import bfs as _bfs

    return _bfs.run(graph, single_source, options=options, device=device)


def bfs(graph: Graph, single_source: int, distances=None, predecessors=None,
        context=None, options: Options | None = None, device=DEFAULT) -> float:
    """Reference ``gunrock.bfs`` (bindings.cu:233-258). Returns ms."""
    del context  # the device is the context
    res = bfs_run(graph, single_source, options=options, device=device)
    _fill(distances, res.distances)
    _fill(predecessors, res.predecessors)
    return res.elapsed_ms
