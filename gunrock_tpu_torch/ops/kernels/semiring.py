"""Semiring pull over the bucketed layout: the frontier-sparse pass, the
dense pass and the fused max/min pass.

Ports of ``gunrock_tpu/ops/pallas/semiring.py``:

- :func:`bucketed_semiring_spmv_sparse` (kernel ``_make_sparse_kernel``):
  every slot of every ACTIVE chunk (``chunkplan.chunk_activity``);
- :func:`bucketed_semiring_spmv` (kernels ``_make_kernel_v1..v5``, one
  contract): every slot of every chunk, the dense pass of PageRank, SpMV,
  symmetric HITS and the non-DO SSSP;
- :func:`bucketed_semiring_spmv_sparse_minmax` (kernel
  ``_sparse_minmax_kernel``): coloring's paired neighbour scans, see the
  function.

The first two compute y[row] (+)= msg(x[col], value):

- ``plus_times``  y[r] = sum  val * x[c]         identity 0
- ``max_times``   y[r] = max  val * x[c]         identity 0
- ``min_plus``    y[r] = min (val + x[c])        identity _BIG; results
  >= _BIG come back as inf

The sparse pass reduces all slots of an active chunk, including those
whose source is inactive: the contract assumes inactive x already holds
the gather identity. Rows that no (active) chunk reaches come back as the
identity. ``unit=True`` skips the values: msg = x for plus/max, min(x,
_BIG) for min_plus (the (x)-identity, not weight 1). ``exact`` is accepted
for the callers and changes nothing: the port computes in f32 throughout.

CUDA source: ``csrc/semiring.cu`` (one kernel template, sparse or dense,
and the max/min kernel).
"""

from __future__ import annotations

import ctypes

import torch

from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.chunkplan import chunk_activity, chunk_activity_plain
from gunrock_tpu_torch.ops.kernels.layout import BucketedEdges, slot_indices

_BIG = 3.0e38  # f32-safe infinity stand-in (keeps arithmetic finite)

SEMIRINGS = {
    # name: (kernel id, identity, scatter_reduce op)
    "plus_times": (0, 0.0, "sum"),
    "min_plus": (1, _BIG, "amin"),
    "max_times": (2, 0.0, "amax"),
}
_BLOCKS_PER_SM = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gr_spmv_sparse": [_I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                       _I, _I, _I, _P],
    "gr_spmv_dense": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _I, _P],
    "gr_spmv_sparse_minmax": [_I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _P],
    # the dense pass's floor modes (ops/kernels/probes.py::spmv_floor)
    "gr_spmv_dense_floor": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                            _I, _I, _I, _P],
}


def _finish(y: torch.Tensor, V: int, semiring: str) -> torch.Tensor:
    y = y[:V]
    if semiring == "min_plus":
        y = torch.where(y >= _BIG, torch.inf, y)
    return y


def _empty_result(V: int, semiring: str, device) -> torch.Tensor:
    """What an edgeless layout gives: the identity (inf for min_plus)."""
    fill = torch.inf if semiring == "min_plus" else SEMIRINGS[semiring][1]
    return torch.full((V,), fill, dtype=torch.float32, device=device)


def bucketed_semiring_spmv(
    layout: BucketedEdges,
    x: torch.Tensor,
    semiring: str = "plus_times",
    unit: bool = False,
) -> torch.Tensor:
    """f32[V]: the dense semiring pull over every chunk of ``layout``. See
    the module docstring for the contract; a min_plus layout carries
    ``pad_value=_BIG``."""
    sr_id, ident, _ = SEMIRINGS[semiring]
    dev = layout.device
    V = layout.n_vertices
    _build.check_tensor(x, "x", torch.float32, (V,), dev)
    if layout.n_chunks == 0:
        return _empty_result(V, semiring, dev)
    if dev.type == "cpu":
        return bucketed_semiring_spmv_plain(layout, x, semiring, unit=unit)
    if dev.type != "cuda":
        raise ValueError(f"no semiring kernel for device {dev}")
    W = layout.window
    y = torch.full((layout.n_row_blocks * W,), ident, dtype=torch.float32,
                   device=dev)
    blocks = min(layout.n_chunks, _BLOCKS_PER_SM * _build.sm_count(dev))
    lib = _build.load("semiring", _SIGNATURES)
    err = lib.gr_spmv_dense(
        sr_id, int(unit), blocks, layout.n_chunks,
        _build.ptr(layout.chunk_rb), _build.ptr(layout.chunk_cb),
        _build.ptr(layout.row_local), _build.ptr(layout.col_local),
        None if unit else _build.ptr(layout.values), _build.ptr(x),
        _build.ptr(y), W, layout.chunk, V, layout.n_row_blocks,
        _build.stream(dev),
    )
    _build.check(err, "bucketed_semiring_spmv")
    _build.LAUNCHES["bucketed_semiring_spmv"] += 1
    return _finish(y, V, semiring)


def _reduce(layout: BucketedEdges, x, semiring: str, unit: bool, row, col,
            slot) -> torch.Tensor:
    """The plain versions' body: messages of the given slots, reduced into
    y (the identity everywhere else)."""
    _, ident, reduce = SEMIRINGS[semiring]
    xg = x[col]
    if semiring == "min_plus":
        msg = xg if unit else layout.values[slot] + xg
        msg = torch.clamp(msg, max=_BIG)
    else:
        msg = xg if unit else layout.values[slot] * xg
    y = torch.full((layout.n_row_blocks * layout.window,), ident,
                   dtype=torch.float32, device=x.device)
    y.scatter_reduce_(0, row, msg, reduce=reduce, include_self=True)
    return _finish(y, layout.n_vertices, semiring)


def bucketed_semiring_spmv_plain(
    layout: BucketedEdges,
    x: torch.Tensor,
    semiring: str = "plus_times",
    unit: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`bucketed_semiring_spmv`."""
    if layout.n_chunks == 0:
        return _empty_result(layout.n_vertices, semiring, x.device)
    return _reduce(layout, x, semiring, unit, *slot_indices(layout))


def bucketed_semiring_spmv_sparse(
    layout: BucketedEdges,
    x: torch.Tensor,
    active: torch.Tensor,
    semiring: str = "plus_times",
    out_mask: torch.Tensor | None = None,
    exact: bool = False,
    unit: bool = False,
) -> torch.Tensor:
    """f32[V]: the semiring pull over the chunks ``active`` (and
    ``out_mask``) select. See the module docstring for the contract."""
    del exact  # f32 throughout covers the bf16-exact mode
    sr_id, ident, _ = SEMIRINGS[semiring]
    dev = layout.device
    V = layout.n_vertices
    _build.check_tensor(x, "x", torch.float32, (V,), dev)
    _build.check_tensor(active, "active", torch.bool, (V,), dev)
    if out_mask is not None:
        _build.check_tensor(out_mask, "out_mask", torch.bool, (V,), dev)
    if layout.n_chunks == 0:
        return _empty_result(V, semiring, dev)
    if dev.type == "cpu":
        return bucketed_semiring_spmv_sparse_plain(
            layout, x, active, semiring, out_mask, unit=unit)
    if dev.type != "cuda":
        raise ValueError(f"no semiring kernel for device {dev}")
    _, queue, count = chunk_activity(layout, active, out_mask)
    W = layout.window
    y = torch.full((layout.n_row_blocks * W,), ident, dtype=torch.float32,
                   device=dev)
    blocks = min(layout.n_chunks, _BLOCKS_PER_SM * _build.sm_count(dev))
    lib = _build.load("semiring", _SIGNATURES)
    err = lib.gr_spmv_sparse(
        sr_id, int(unit), blocks, _build.ptr(queue), _build.ptr(count),
        layout.n_chunks,
        _build.ptr(layout.chunk_rb), _build.ptr(layout.chunk_cb),
        _build.ptr(layout.row_local), _build.ptr(layout.col_local),
        None if unit else _build.ptr(layout.values), _build.ptr(x),
        _build.ptr(y), W, layout.chunk, V, layout.n_row_blocks,
        _build.stream(dev),
    )
    _build.check(err, "bucketed_semiring_spmv_sparse")
    _build.LAUNCHES["bucketed_semiring_spmv_sparse"] += 1
    return _finish(y, V, semiring)


def bucketed_semiring_spmv_sparse_plain(
    layout: BucketedEdges,
    x: torch.Tensor,
    active: torch.Tensor,
    semiring: str = "plus_times",
    out_mask: torch.Tensor | None = None,
    exact: bool = False,
    unit: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`bucketed_semiring_spmv_sparse`."""
    del exact
    if layout.n_chunks == 0:
        return _empty_result(layout.n_vertices, semiring, x.device)
    ch_act, _, _ = chunk_activity_plain(layout, active, out_mask)
    return _reduce(layout, x, semiring, unit,
                   *slot_indices(layout, ch_act))


def _check_minmax_inputs(layout: BucketedEdges, x, active, out_mask) -> None:
    dev, V = layout.device, layout.n_vertices
    _build.check_tensor(x, "x", torch.float32, (V,), dev)
    _build.check_tensor(active, "active", torch.bool, (V,), dev)
    if out_mask is not None:
        _build.check_tensor(out_mask, "out_mask", torch.bool, (V,), dev)


def bucketed_semiring_spmv_sparse_minmax(
    layout: BucketedEdges,
    x: torch.Tensor,
    active: torch.Tensor,
    out_mask: torch.Tensor | None = None,
):
    """(y_max f32[V], y_min f32[V]) over the chunks ``active`` (and
    ``out_mask``) select: ``y_max[r]`` is the largest and ``y_min[r]`` the
    smallest POSITIVE message ``value * x[col]`` into row r. A row with no
    positive message gets ``(0, _BIG)``: ``_BIG`` itself, not inf (the
    callers test ``y_min < _BIG``). Needs x >= 0 and values >= 0, with 0
    for an inactive source. With ``out_mask`` only the rows inside it are
    defined. An edgeless layout gives ``(zeros, full(_BIG))``."""
    dev = layout.device
    V = layout.n_vertices
    _check_minmax_inputs(layout, x, active, out_mask)
    if layout.n_chunks == 0:
        return (torch.zeros(V, dtype=torch.float32, device=dev),
                torch.full((V,), _BIG, dtype=torch.float32, device=dev))
    if dev.type == "cpu":
        return bucketed_semiring_spmv_sparse_minmax_plain(
            layout, x, active, out_mask)
    if dev.type != "cuda":
        raise ValueError(f"no semiring kernel for device {dev}")
    _, queue, count = chunk_activity(layout, active, out_mask)
    W = layout.window
    n_pad = layout.n_row_blocks * W
    ymax = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    ymin = torch.full((n_pad,), _BIG, dtype=torch.float32, device=dev)
    blocks = min(layout.n_chunks, _BLOCKS_PER_SM * _build.sm_count(dev))
    lib = _build.load("semiring", _SIGNATURES)
    err = lib.gr_spmv_sparse_minmax(
        blocks, _build.ptr(queue), _build.ptr(count), layout.n_chunks,
        _build.ptr(layout.chunk_rb), _build.ptr(layout.chunk_cb),
        _build.ptr(layout.row_local), _build.ptr(layout.col_local),
        _build.ptr(layout.values), _build.ptr(x), _build.ptr(ymax),
        _build.ptr(ymin), W, layout.chunk, V, layout.n_row_blocks,
        _build.stream(dev),
    )
    _build.check(err, "bucketed_semiring_spmv_sparse_minmax")
    _build.LAUNCHES["bucketed_semiring_spmv_sparse_minmax"] += 1
    return ymax[:V], ymin[:V]


def bucketed_semiring_spmv_sparse_minmax_plain(
    layout: BucketedEdges,
    x: torch.Tensor,
    active: torch.Tensor,
    out_mask: torch.Tensor | None = None,
):
    """Plain PyTorch version of
    :func:`bucketed_semiring_spmv_sparse_minmax`."""
    V = layout.n_vertices
    n_pad = layout.n_row_blocks * layout.window
    ymax = torch.zeros(n_pad, dtype=torch.float32, device=x.device)
    ymin = torch.full((n_pad,), _BIG, dtype=torch.float32, device=x.device)
    if layout.n_chunks:
        ch_act, _, _ = chunk_activity_plain(layout, active, out_mask)
        row, col, slot = slot_indices(layout, ch_act)
        msg = layout.values[slot] * x[col]
        ymax.scatter_reduce_(0, row, torch.clamp(msg, min=0.0), reduce="amax",
                             include_self=True)
        ymin.scatter_reduce_(0, row, torch.where(msg > 0.0, msg, _BIG),
                             reduce="amin", include_self=True)
    return ymax[:V], ymin[:V]
