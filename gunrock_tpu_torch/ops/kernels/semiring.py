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

CUDA source: ``csrc/semiring.cu``. The three passes are one template: a
block per span of the layout's span table reduces its chunks into the row
window in shared memory (the max/min pass into two windows, max and min),
and a second pass combines the spans of each row block into y (ymax and
ymin), which the kernels write whole.

Spans (``utils/profiler.py``): ``kernel.bucketed_semiring_spmv_sparse``
around that wrapper, its chunk plan included.
"""

from __future__ import annotations

import ctypes

import torch

from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.chunkplan import chunk_activity, chunk_activity_plain
from gunrock_tpu_torch.ops.kernels.layout import BucketedEdges, slot_indices
from gunrock_tpu_torch.utils.profiler import annotate

_BIG = 3.0e38  # f32-safe infinity stand-in (keeps arithmetic finite)

SEMIRINGS = {
    # name: (kernel id, identity, scatter_reduce op)
    "plus_times": (0, 0.0, "sum"),
    "min_plus": (1, _BIG, "amin"),
    "max_times": (2, 0.0, "amax"),
}
_MAX_MIN = "max_min"  # the fused max/min pass's kernel tag, see _pull
_MAX_MIN_ID = 3

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gr_spmv_pull": [_I, _I, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                     _P, _I, _I, _I, _I, _P],
    # the dense pass's floor modes (ops/kernels/probes.py::spmv_floor)
    "gr_spmv_dense_floor": [_I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _P],
}
# the span pass holds a row window of W floats in shared memory, beside 1 KB
# of its own: within the 227 KB one block can take on Hopper
MAX_WINDOW = (227 * 1024 - 1024) // 4


def check_window(window: int) -> None:
    """Raise unless the span pass can hold a row window of ``window``
    floats in shared memory and store it four at a time."""
    if window % 4 or not 0 < window <= MAX_WINDOW:
        raise ValueError(f"the semiring pull takes a window that is a "
                         f"multiple of 4 and at most {MAX_WINDOW} floats "
                         f"(227 KB of shared memory), got {window}")


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
    dev = layout.device
    V = layout.n_vertices
    _build.check_tensor(x, "x", torch.float32, (V,), dev)
    if layout.n_chunks == 0:
        return _empty_result(V, semiring, dev)
    if dev.type == "cpu":
        return bucketed_semiring_spmv_plain(layout, x, semiring, unit=unit)
    if dev.type != "cuda":
        raise ValueError(f"no semiring kernel for device {dev}")
    return _finish(_pull(layout, x, semiring, unit, None,
                         "bucketed_semiring_spmv"), V, semiring)


def _pull(layout: BucketedEdges, x, semiring: str, unit: bool, ch_act,
          what: str) -> torch.Tensor:
    """Launch the span pass and the reduce pass over the chunks ``ch_act``
    selects (every chunk when None) and count the launch as ``what``.
    Returns y, f32[n_row_blocks * W] (for ``_MAX_MIN``: ymax, then ymin)."""
    n_win = 2 if semiring == _MAX_MIN else 1  # windows per span
    check_window(n_win * layout.window)
    dev = layout.device
    W, V, n_spans = layout.window, layout.n_vertices, layout.n_spans
    y = torch.empty(n_win * layout.n_row_blocks * W, dtype=torch.float32,
                    device=dev)
    # the partial windows of the spans, then their touched flags
    scratch = torch.empty(n_spans * (n_win * W + 1), dtype=torch.float32,
                          device=dev)
    lib = _build.load("semiring", _SIGNATURES)
    err = lib.gr_spmv_pull(
        _MAX_MIN_ID if semiring == _MAX_MIN else SEMIRINGS[semiring][0],
        int(unit), _build.ptr(ch_act), n_spans,
        _build.ptr(layout.span_first_chunk), _build.ptr(layout.rb_first_span),
        layout.n_chunks, _build.ptr(layout.chunk_cb),
        _build.ptr(layout.row_local), _build.ptr(layout.col_local),
        None if unit else _build.ptr(layout.values), _build.ptr(x),
        _build.ptr(y), _build.ptr(scratch), W, layout.chunk, V,
        layout.n_row_blocks, _build.stream(dev),
    )
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return y


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
    with annotate("kernel.bucketed_semiring_spmv_sparse"):
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
        ch_act = chunk_activity(layout, active, out_mask, queue=False)[0]
        return _finish(_pull(layout, x, semiring, unit, ch_act,
                             "bucketed_semiring_spmv_sparse"), V, semiring)


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
    ch_act = chunk_activity(layout, active, out_mask, queue=False)[0]
    y = _pull(layout, x, _MAX_MIN, False, ch_act,
              "bucketed_semiring_spmv_sparse_minmax").view(2, -1)
    return y[0, :V], y[1, :V]


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
