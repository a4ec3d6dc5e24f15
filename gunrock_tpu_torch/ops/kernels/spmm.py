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

CUDA source: ``csrc/spmm.cu``. Both passes run on the layout's span
table, the dense pass with every chunk active: each span's slots that can
send are kept once (the dense pass sorts them by row), then one block per
(span, tile of the window's rows and X's columns, :func:`tile_shape`)
reduces its part of them into the tile in shared memory and adds the tile
into Y. Where :func:`walks` says so, the dense pass's tile pass walks the
span's metadata itself instead of a kept list.

Spans (``utils/profiler.py``): ``kernel.bucketed_spmm`` around the dense
pass's wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.chunkplan import chunk_activity, chunk_activity_plain
from gunrock_tpu_torch.ops.kernels.layout import BucketedEdges, slot_indices
from gunrock_tpu_torch.ops.kernels.semiring import MAX_WINDOW, check_window
from gunrock_tpu_torch.utils.profiler import annotate

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gr_spmm_spans": [_I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P,
                      _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}
# shared memory for a tile of the window, row_tile rows x Kt columns: 64
# KB, three blocks on an SM
K_TILE_BYTES = 64 * 1024
K_TILES = (1, 2, 4, 8, 16, 32)


def tile_shape(k: int, window: int, sort: bool) -> tuple[int, int]:
    """(Kt, rows): the columns of X and the rows of the W-row window that
    one block of the tile pass takes, a tile of at most ``K_TILE_BYTES``.
    Kt is the smallest of ``K_TILES`` that holds all K columns. Over a
    list sorted by row (``sort``), Kt stays (32 at most) and the window is
    cut into row tiles: (8, 2048) at W=2048 and K=8, (32, 512) at K >= 32.
    Over an unsorted list a tile holds all W rows, so Kt is halved until
    it fits (at least 1): (8, 2048) at W=2048 and K >= 8."""
    kt = next((t for t in K_TILES if t >= k), K_TILES[-1])
    if sort:
        return kt, min(window, K_TILE_BYTES // (4 * kt))
    while kt > 1 and 4 * window * kt > K_TILE_BYTES:
        kt //= 2
    return kt, window


def k_tile(k: int, window: int) -> int:
    """Kt of the frontier-sparse pass (its list is not sorted), the
    columns of X one block takes: 8 at W=2048 and K >= 8."""
    return tile_shape(k, window, sort=False)[0]


def _check_x(layout: BucketedEdges, x: torch.Tensor) -> int:
    if x.dim() != 2:
        raise ValueError(f"x must be [V, K], got shape {tuple(x.shape)}")
    K = x.shape[1]
    _build.check_tensor(x, "x", torch.float32, (layout.n_vertices, K),
                        layout.device)
    return K


def walks(n_tiles: int, n_row_tiles: int) -> bool:
    """Whether the dense pass's tile pass walks the layout's metadata
    itself rather than the keep pass's sorted list: where one tile holds
    the whole window (K <= 8 at W=2048), where it was the faster
    (PERF.md)."""
    return n_tiles == 1 and n_row_tiles == 1


def _launch(layout: BucketedEdges, x: torch.Tensor, ch_act, kt: int,
            rows: int, walk: bool, sort: bool, what: str) -> torch.Tensor:
    """Y over the chunks ``ch_act`` selects (every chunk when None), in
    tiles of ``rows`` window rows and ``kt`` columns; through the keep
    pass, sorting by row where ``sort``, unless ``walk``. Counts the
    launch as ``what``."""
    dev = layout.device
    V, W, K = layout.n_vertices, layout.window, x.shape[1]
    if kt not in K_TILES:
        raise ValueError(f"k_tile_cols must be one of {K_TILES}, got {kt}")
    if rows % 4 or rows < 4:
        raise ValueError(f"tile_rows must be a positive multiple of 4, got {rows}")
    rows = min(rows, W)
    check_window(rows * kt)
    n_row_tiles = -(-W // rows)
    if (walk or not sort) and n_row_tiles != 1:
        raise ValueError("a tile pass over an unsorted list takes one row tile")
    span_slots = layout.max_span_chunks * layout.chunk
    if sort and not walk and W + 3 * span_slots > MAX_WINDOW:
        raise ValueError(
            f"the keep pass stages a span's {span_slots} slots and W={W} "
            f"row counts in shared memory: at most {MAX_WINDOW} words")
    y = torch.zeros((layout.n_row_blocks * W, K), dtype=torch.float32,
                    device=dev)
    xrow = torch.empty(V, dtype=torch.uint8, device=dev)
    # the keep pass's: per span its row tiles' offsets into its kept slots,
    # then the kept slots' rows, X rows and values at the span's own slot
    # offsets
    scratch = None if walk else torch.empty(
        layout.n_spans * (n_row_tiles + 1) + 3 * layout.n_chunks * layout.chunk,
        dtype=torch.int32, device=dev)
    lib = _build.load("spmm", _SIGNATURES)
    err = lib.gr_spmm_spans(
        kt, rows, int(walk), int(sort), span_slots, layout.n_spans,
        _build.ptr(layout.span_first_chunk), _build.ptr(ch_act),
        layout.n_chunks, _build.ptr(layout.chunk_rb),
        _build.ptr(layout.chunk_cb), _build.ptr(layout.row_local),
        _build.ptr(layout.col_local), _build.ptr(layout.values),
        _build.ptr(x), _build.ptr(xrow), _build.ptr(scratch), _build.ptr(y),
        W, layout.chunk, K, V, layout.n_row_blocks, _build.stream(dev),
    )
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return y[:V]


def bucketed_spmm(layout: BucketedEdges, x: torch.Tensor,
                  exact: bool = False, k_tile_cols: int | None = None,
                  tile_rows: int | None = None,
                  walk: bool | None = None) -> torch.Tensor:
    """x: f32[V, K] -> y: f32[V, K]. ``k_tile_cols``, ``tile_rows`` and
    ``walk`` set the kernel's tile and whether its tile pass walks the
    metadata (:func:`tile_shape` and :func:`walks` when None), to measure
    or test it otherwise."""
    del exact  # f32 throughout covers the bf16-exact mode
    with annotate("kernel.bucketed_spmm"):
        dev = layout.device
        K = _check_x(layout, x)
        if layout.n_chunks == 0:
            return torch.zeros((layout.n_vertices, K), dtype=torch.float32,
                               device=dev)
        if dev.type == "cpu":
            return bucketed_spmm_plain(layout, x)
        if dev.type != "cuda":
            raise ValueError(f"no SpMM kernel for device {dev}")
        kt, rows = tile_shape(K, layout.window, sort=True)
        if k_tile_cols is not None:
            kt, rows = k_tile_cols, K_TILE_BYTES // (4 * k_tile_cols)
        rows = min(rows if tile_rows is None else tile_rows, layout.window)
        if walk is None:
            walk = walks(-(-K // kt), -(-layout.window // rows))
        return _launch(layout, x, None, kt, rows, walk, True,
                       "bucketed_spmm")


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
    V = layout.n_vertices
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
    kt = k_tile(K, layout.window) if k_tile_cols is None else k_tile_cols
    ch_act = chunk_activity(layout, active, out_mask, queue=False)[0]
    return _launch(layout, x, ch_act, kt, layout.window, False, False,
                   "bucketed_spmm_sparse")


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
