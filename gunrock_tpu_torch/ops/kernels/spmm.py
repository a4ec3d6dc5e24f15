"""Bucketed SpMM, Y = A . X (plus_times) for a dense multi-vector X: the
dense pass and the frontier-sparse pass.

Ports of ``gunrock_tpu/ops/pallas/spmm.py``:

- :func:`bucketed_spmm` (kernel ``_make_kernel``):
  Y[rb*W + row_local, k] += values * X[cb*W + col_local, k] over every real
  slot of every chunk; rows no chunk reaches are 0;
- :func:`bucketed_spmm_sparse` (kernel ``_sparse_kernel``): the same over
  the chunks that ``active`` (and ``out_mask``) select
  (``chunkplan.chunk_activity``). Rows no active chunk reaches are 0, so a
  caller can accumulate the result (``carry += spmm_sparse(delta)``); with
  ``out_mask`` only the rows inside it are defined.

``exact`` is accepted for the callers and changes nothing: the port
computes in f32 throughout, which covers the bf16-exact case.

CUDA source: ``csrc/spmm.cu``. The dense pass is one block per chunk
with global atomics; the sparse pass runs on the layout's span table:
each span's slots that can send are kept once, then one block per (span,
tile of ``k_tile`` columns) reduces them into a W x Kt window in shared
memory and adds the window into Y.
"""

from __future__ import annotations

import ctypes

import torch

from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.chunkplan import chunk_activity, chunk_activity_plain
from gunrock_tpu_torch.ops.kernels.layout import BucketedEdges, slot_indices
from gunrock_tpu_torch.ops.kernels.semiring import check_window

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gr_spmm": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gr_spmm_spans": [_I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _P],
}
# shared memory for the sparse pass's W x Kt window: 64 KB, three blocks
# on an SM
K_TILE_BYTES = 64 * 1024
K_TILES = (1, 2, 4, 8, 16, 32)


def k_tile(k: int, window: int) -> int:
    """Kt, the columns of X one block of the sparse pass takes: the
    smallest of ``K_TILES`` that holds all K columns, halved until a
    W x Kt float window fits ``K_TILE_BYTES`` (at least 1). 8 at W=2048
    and K >= 8."""
    kt = next((t for t in K_TILES if t >= k), K_TILES[-1])
    while kt > 1 and 4 * window * kt > K_TILE_BYTES:
        kt //= 2
    return kt


def _check_x(layout: BucketedEdges, x: torch.Tensor) -> int:
    if x.dim() != 2:
        raise ValueError(f"x must be [V, K], got shape {tuple(x.shape)}")
    K = x.shape[1]
    _build.check_tensor(x, "x", torch.float32, (layout.n_vertices, K),
                        layout.device)
    return K


def _launch_dense(layout: BucketedEdges, x: torch.Tensor,
                  K: int) -> torch.Tensor:
    dev = layout.device
    V, W = layout.n_vertices, layout.window
    y = torch.zeros((layout.n_row_blocks * W, K), dtype=torch.float32,
                    device=dev)
    lib = _build.load("spmm", _SIGNATURES)
    err = lib.gr_spmm(
        layout.n_chunks, _build.ptr(layout.chunk_rb),
        _build.ptr(layout.chunk_cb), _build.ptr(layout.row_local),
        _build.ptr(layout.col_local), _build.ptr(layout.values),
        _build.ptr(x), _build.ptr(y), W, layout.chunk, K, V,
        layout.n_row_blocks, _build.stream(dev),
    )
    _build.check(err, "bucketed_spmm")
    _build.LAUNCHES["bucketed_spmm"] += 1
    return y[:V]


def bucketed_spmm(layout: BucketedEdges, x: torch.Tensor,
                  exact: bool = False) -> torch.Tensor:
    """x: f32[V, K] -> y: f32[V, K]."""
    del exact  # f32 throughout covers the bf16-exact mode
    dev = layout.device
    K = _check_x(layout, x)
    if layout.n_chunks == 0:
        return torch.zeros((layout.n_vertices, K), dtype=torch.float32,
                           device=dev)
    if dev.type == "cpu":
        return bucketed_spmm_plain(layout, x)
    if dev.type != "cuda":
        raise ValueError(f"no SpMM kernel for device {dev}")
    return _launch_dense(layout, x, K)


def _plain(layout: BucketedEdges, x: torch.Tensor, ch_act) -> torch.Tensor:
    row, col, slot = slot_indices(layout, ch_act)
    y = torch.zeros((layout.n_row_blocks * layout.window, x.shape[1]),
                    dtype=torch.float32, device=x.device)
    y.index_add_(0, row, x[col] * layout.values[slot, None])
    return y[: layout.n_vertices]


def bucketed_spmm_plain(layout: BucketedEdges, x: torch.Tensor,
                        exact: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`bucketed_spmm`."""
    del exact
    return _plain(layout, x, None)


def bucketed_spmm_sparse(layout: BucketedEdges, x: torch.Tensor,
                         active: torch.Tensor,
                         out_mask: torch.Tensor | None = None,
                         exact: bool = False,
                         k_tile_cols: int | None = None) -> torch.Tensor:
    """x: f32[V, K], active (and out_mask): bool[V] -> y: f32[V, K] over the
    active chunks; rows none of them reaches are 0. ``k_tile_cols`` sets
    the kernel's K tile (one of ``K_TILES``; :func:`k_tile` when None), to
    measure it at another tile."""
    del exact  # f32 throughout covers the bf16-exact mode
    dev = layout.device
    V, W = layout.n_vertices, layout.window
    K = _check_x(layout, x)
    _build.check_tensor(active, "active", torch.bool, (V,), dev)
    if out_mask is not None:
        _build.check_tensor(out_mask, "out_mask", torch.bool, (V,), dev)
    if layout.n_chunks == 0:
        return torch.zeros((V, K), dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        return bucketed_spmm_sparse_plain(layout, x, active, out_mask)
    if dev.type != "cuda":
        raise ValueError(f"no SpMM kernel for device {dev}")
    kt = k_tile(K, W) if k_tile_cols is None else k_tile_cols
    if kt not in K_TILES:
        raise ValueError(f"k_tile_cols must be one of {K_TILES}, got {kt}")
    check_window(W * kt)
    ch_act = chunk_activity(layout, active, out_mask)[0]
    y = torch.zeros((layout.n_row_blocks * W, K), dtype=torch.float32,
                    device=dev)
    xrow = torch.empty(V, dtype=torch.uint8, device=dev)
    # per span its number of kept slots, then the kept slots' rows, X rows
    # and values at the span's own slot offsets
    n_slots = layout.n_chunks * layout.chunk
    scratch = torch.empty(layout.n_spans + 3 * n_slots, dtype=torch.int32,
                          device=dev)
    lib = _build.load("spmm", _SIGNATURES)
    err = lib.gr_spmm_spans(
        kt, layout.n_spans, _build.ptr(layout.span_first_chunk),
        _build.ptr(ch_act), layout.n_chunks, _build.ptr(layout.chunk_rb),
        _build.ptr(layout.chunk_cb), _build.ptr(layout.row_local),
        _build.ptr(layout.col_local), _build.ptr(layout.values),
        _build.ptr(x), _build.ptr(xrow), _build.ptr(scratch), _build.ptr(y),
        W, layout.chunk, K, V, layout.n_row_blocks, _build.stream(dev),
    )
    _build.check(err, "bucketed_spmm_sparse")
    _build.LAUNCHES["bucketed_spmm_sparse"] += 1
    return y[:V]


def bucketed_spmm_sparse_plain(layout: BucketedEdges, x: torch.Tensor,
                               active: torch.Tensor,
                               out_mask: torch.Tensor | None = None,
                               exact: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`bucketed_spmm_sparse`."""
    del exact
    if layout.n_chunks == 0:
        return torch.zeros((layout.n_vertices, x.shape[1]),
                           dtype=torch.float32, device=x.device)
    ch_act, _, _ = chunk_activity_plain(layout, active, out_mask)
    return _plain(layout, x, ch_act)
