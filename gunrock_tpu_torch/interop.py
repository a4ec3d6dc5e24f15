"""pygunrock-style API that fills caller-provided tensors (the
single-device part of ``gunrock_tpu/interop.py``).

``bfs``/``sssp(graph, src, distances, predecessors)`` run the search and
write the results into the given tensors, returning elapsed milliseconds.
A CUDA tensor is filled device to device with ``tensor.copy_``; a CPU
tensor or a numpy array receives a copy of the result. The ``*_run``
wrappers return the algorithm's Result.
"""

from __future__ import annotations

import numpy as np
import torch

from gunrock_tpu_torch.device import DEFAULT, resolve
from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.configs import Options


def as_device_array(x, device=DEFAULT) -> torch.Tensor:
    """One contiguous tensor on ``device`` from a torch tensor or a numpy
    array (role of the reference's ``data_ptr()`` reads,
    bindings.cu:65-82). A contiguous tensor already on ``device``, or a
    contiguous writable array for the CPU, comes back without a copy (the
    same ``data_ptr()``); anything else is copied once on its way there,
    and packed if it was not contiguous."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if isinstance(x, np.ndarray):
        if not x.flags.writeable:  # torch cannot view read-only memory
            return torch.tensor(x, device=dev)
        x = torch.from_numpy(x)
    elif not isinstance(x, torch.Tensor):
        raise TypeError(f"as_device_array takes a torch.Tensor or a numpy "
                        f"array, got {type(x)!r}")
    if x.device == dev:
        return x.contiguous()
    return x.to(dev, memory_format=torch.contiguous_format)


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


def sssp_run(graph: Graph, single_source: int,
             options: Options | None = None, device=DEFAULT):
    from gunrock_tpu_torch.algorithms import sssp as _sssp

    return _sssp.run(graph, single_source, options=options, device=device)


def sssp(graph: Graph, single_source: int, distances=None, predecessors=None,
         context=None, options: Options | None = None, device=DEFAULT) -> float:
    """Reference ``gunrock.sssp`` (bindings.cu:186-224). Returns ms."""
    del context  # the device is the context
    res = sssp_run(graph, single_source, options=options, device=device)
    _fill(distances, res.distances)
    _fill(predecessors, res.predecessors)
    return res.elapsed_ms


def pr_run(graph: Graph, alpha: float = 0.85, tol: float = 1e-6,
           options: Options | None = None, alphas=None, device=DEFAULT):
    """``alphas=[...]`` runs the batched multi-damping sweep
    (``pr.run_batch``: one [V, K] SpMM per iteration for all K)."""
    from gunrock_tpu_torch.algorithms import pr as _pr

    if alphas is not None:
        return _pr.run_batch(graph, alphas, tol=tol, options=options,
                             device=device)
    return _pr.run(graph, alpha=alpha, tol=tol, options=options,
                   device=device)


def hits_run(graph: Graph, max_iterations: int = 50,
             options: Options | None = None, device=DEFAULT):
    from gunrock_tpu_torch.algorithms import hits as _hits

    return _hits.run(graph, max_iterations=max_iterations, options=options,
                     device=device)


def spmv_run(graph: Graph, x, options: Options | None = None, device=DEFAULT):
    from gunrock_tpu_torch.algorithms import spmv as _spmv

    return _spmv.run(graph, x, options=options, device=device)


def color_run(graph: Graph, seed: int = 0, options: Options | None = None,
              strategy: str = "auto", device=DEFAULT):
    from gunrock_tpu_torch.algorithms import color as _color

    return _color.run(graph, seed=seed, options=options, strategy=strategy,
                      device=device)


def mst_run(graph: Graph, options: Options | None = None,
            strategy: str = "auto", device=DEFAULT):
    from gunrock_tpu_torch.algorithms import mst as _mst

    return _mst.run(graph, options=options, strategy=strategy, device=device)


def kcore_run(graph: Graph, options: Options | None = None, device=DEFAULT):
    from gunrock_tpu_torch.algorithms import kcore as _kcore

    return _kcore.run(graph, options=options, device=device)


def ppr_run(graph: Graph, seed: int, alpha: float = 0.15,
            epsilon: float = 1e-6, options: Options | None = None,
            device=DEFAULT):
    from gunrock_tpu_torch.algorithms import ppr as _ppr

    return _ppr.run(graph, seed, alpha=alpha, epsilon=epsilon,
                    options=options, device=device)


def bc_run(graph: Graph, single_source: int, options: Options | None = None,
           device=DEFAULT):
    from gunrock_tpu_torch.algorithms import bc as _bc

    return _bc.run(graph, single_source, options=options, device=device)


def tc_run(graph: Graph, reduce_all_triangles: bool = True,
           options: Options | None = None, device=DEFAULT):
    from gunrock_tpu_torch.algorithms import tc as _tc

    return _tc.run(graph, reduce_all_triangles=reduce_all_triangles,
                   options=options, device=device)


def geo_run(graph: Graph, latitude, longitude, total_iterations: int = 3,
            spatial_iterations: int = 1000, options: Options | None = None,
            device=DEFAULT):
    from gunrock_tpu_torch.algorithms import geo as _geo

    return _geo.run(graph, latitude, longitude,
                    total_iterations=total_iterations,
                    spatial_iterations=spatial_iterations, options=options,
                    device=device)


def spgemm_run(graph_a: Graph, graph_b: Graph, options: Options | None = None,
               device=DEFAULT):
    from gunrock_tpu_torch.algorithms import spgemm as _spgemm

    return _spgemm.run(graph_a, graph_b, options=options, device=device)


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
