"""Bucketed SpMM, Y = A . X (plus_times) for a dense multi-vector X.

Port of ``gunrock_tpu/ops/pallas/spmm.py::bucketed_spmm`` (kernel
``_make_kernel``): Y[rb*W + row_local, k] += values * X[cb*W + col_local, k]
over every real slot of every chunk; rows no chunk reaches are 0.
``exact`` is accepted for the callers and changes nothing: the port
computes in f32 throughout, which covers the bf16-exact case.

CUDA source: ``csrc/spmm.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.layout import BucketedEdges, slot_indices

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gr_spmm": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def bucketed_spmm(layout: BucketedEdges, x: torch.Tensor,
                  exact: bool = False) -> torch.Tensor:
    """x: f32[V, K] -> y: f32[V, K]."""
    del exact  # f32 throughout covers the bf16-exact mode
    dev = layout.device
    V, W = layout.n_vertices, layout.window
    if x.dim() != 2:
        raise ValueError(f"x must be [V, K], got shape {tuple(x.shape)}")
    K = x.shape[1]
    _build.check_tensor(x, "x", torch.float32, (V, K), dev)
    if layout.n_chunks == 0:
        return torch.zeros((V, K), dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        return bucketed_spmm_plain(layout, x)
    if dev.type != "cuda":
        raise ValueError(f"no SpMM kernel for device {dev}")
    y = torch.zeros((layout.n_row_blocks * W, K), dtype=torch.float32,
                    device=dev)
    lib = _build.load("spmm", _SIGNATURES)
    err = lib.gr_spmm(
        layout.n_chunks, _build.ptr(layout.chunk_rb),
        _build.ptr(layout.chunk_cb), _build.ptr(layout.row_local),
        _build.ptr(layout.col_local), _build.ptr(layout.values),
        _build.ptr(x), _build.ptr(y), W, layout.chunk, K, _build.stream(dev),
    )
    _build.check(err, "bucketed_spmm")
    _build.LAUNCHES["bucketed_spmm"] += 1
    return y[:V]


def bucketed_spmm_plain(layout: BucketedEdges, x: torch.Tensor,
                        exact: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`bucketed_spmm`."""
    del exact
    row, col, slot = slot_indices(layout)
    y = torch.zeros((layout.n_row_blocks * layout.window, x.shape[1]),
                    dtype=torch.float32, device=x.device)
    y.index_add_(0, row, x[col] * layout.values[slot, None])
    return y[: layout.n_vertices]
