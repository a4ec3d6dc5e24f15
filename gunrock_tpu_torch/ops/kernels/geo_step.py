"""Geolocation's Weiszfeld step over the bucketed layout: the dense pass
and the chunk-skipping pass.

Ports of ``gunrock_tpu/ops/pallas/geo_step.py``:

- :func:`weiszfeld_step_sums` (kernel ``_make_wstep_kernel``): every slot
  of every chunk;
- :func:`weiszfeld_step_sums_sparse` (kernel ``_make_wstep_sparse_kernel``):
  every slot of the chunks whose row sub-blocks hold an ``undone`` vertex
  (``chunkplan.chunk_activity`` with every source active and ``undone`` as
  the row mask). Rows that no such chunk reaches come back 0; the geo loop
  never reads them.

The layout is the push layout (rows = the vertex that iterates, one slot
per out-edge). ``mlat3``/``mlon3``/``ok3`` carry, per slot, the
neighbour's coordinates and 1.0 where the slot is a real edge to a labeled
neighbour (0.0 on padding and unlabeled neighbours, whose coordinates are
0, never NaN). For every slot with ``ok > 0``, with ``d`` the haversine
distance from the neighbour to the row's iterate ``(y_lat, y_lon)``, and
only if ``d != 0``:

    cnt[row] += 1;  dinv[row] += 1 / max(d, 1e-30)
    wlat[row] += mlat / d;  wlon[row] += mlon / d

Returns ``(cnt, dinv, wlat, wlon)``, each f32[V].

The arcsin is the library's (``asinf`` on the card, ``torch.asin`` here);
the JAX kernel's is a Cephes polynomial within 2e-6 of it, because its
compiler has none.

CUDA source: ``csrc/geo_step.cu`` (one kernel template, dense or queued).
"""

from __future__ import annotations

import ctypes
import math

import torch

from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.chunkplan import chunk_activity, chunk_activity_plain
from gunrock_tpu_torch.ops.kernels.layout import BucketedEdges, slot_indices

_BLOCKS_PER_SM = 8
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gr_weiszfeld_step": [_I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _I, _I, _P],
}
_RAD = math.pi / 180.0


def haversine(lat1, lon1, lat2, lon2, radius: float = 6371.0):
    """Great-circle distance in km between points in degrees (reference
    geo.hxx:105-127), in the tensors' type."""
    la1, lo1 = lat1 * _RAD, lon1 * _RAD
    la2, lo2 = lat2 * _RAD, lon2 * _RAD
    sdlat = torch.sin((la2 - la1) * 0.5)
    sdlon = torch.sin((lo2 - lo1) * 0.5)
    a = sdlat * sdlat + torch.cos(la1) * torch.cos(la2) * sdlon * sdlon
    return radius * 2.0 * torch.asin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def _check(layout: BucketedEdges, y_lat, y_lon, mlat3, mlon3, ok3, undone):
    dev, V = layout.device, layout.n_vertices
    _build.check_tensor(y_lat, "y_lat", torch.float32, (V,), dev)
    _build.check_tensor(y_lon, "y_lon", torch.float32, (V,), dev)
    n_slots = layout.n_chunks * layout.chunk
    for name, t in (("mlat3", mlat3), ("mlon3", mlon3), ("ok3", ok3)):
        if t.numel() != n_slots:
            raise ValueError(f"{name} must hold one value per slot "
                             f"({n_slots}), got shape {tuple(t.shape)}")
        _build.check_tensor(t, name, torch.float32, t.shape, dev)
    if undone is not None:
        _build.check_tensor(undone, "undone", torch.bool, (V,), dev)


def _zeros(layout: BucketedEdges):
    out = torch.zeros((4, layout.n_vertices), dtype=torch.float32,
                      device=layout.device)
    return out[0], out[1], out[2], out[3]


def _launch(layout: BucketedEdges, y_lat, y_lon, mlat3, mlon3, ok3, queue,
            count, what: str):
    dev, V = layout.device, layout.n_vertices
    out = torch.zeros((4, V), dtype=torch.float32, device=dev)
    blocks = min(layout.n_chunks, _BLOCKS_PER_SM * _build.sm_count(dev))
    lib = _build.load("geo_step", _SIGNATURES)
    err = lib.gr_weiszfeld_step(
        blocks, _build.ptr(queue), _build.ptr(count), layout.n_chunks,
        _build.ptr(layout.chunk_rb), _build.ptr(layout.row_local),
        _build.ptr(mlat3), _build.ptr(mlon3), _build.ptr(ok3),
        _build.ptr(y_lat), _build.ptr(y_lon), _build.ptr(out), layout.window,
        layout.chunk, V, _build.stream(dev),
    )
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return out[0], out[1], out[2], out[3]


def weiszfeld_step_sums(layout: BucketedEdges, y_lat, y_lon, mlat3, mlon3,
                        ok3):
    """One Weiszfeld step's four per-row sums over every chunk. See the
    module docstring."""
    _check(layout, y_lat, y_lon, mlat3, mlon3, ok3, None)
    dev = layout.device
    if layout.n_chunks == 0:
        return _zeros(layout)
    if dev.type == "cpu":
        return weiszfeld_step_sums_plain(layout, y_lat, y_lon, mlat3, mlon3,
                                         ok3)
    if dev.type != "cuda":
        raise ValueError(f"no Weiszfeld-step kernel for device {dev}")
    return _launch(layout, y_lat, y_lon, mlat3, mlon3, ok3, None, None,
                   "weiszfeld_step_sums")


def weiszfeld_step_sums_sparse(layout: BucketedEdges, y_lat, y_lon, mlat3,
                               mlon3, ok3, undone):
    """The same sums over the chunks whose row sub-blocks hold an
    ``undone`` (bool[V]) vertex; rows none of them reaches are 0."""
    _check(layout, y_lat, y_lon, mlat3, mlon3, ok3, undone)
    dev = layout.device
    if layout.n_chunks == 0:
        return _zeros(layout)
    if dev.type == "cpu":
        return weiszfeld_step_sums_sparse_plain(layout, y_lat, y_lon, mlat3,
                                                mlon3, ok3, undone)
    if dev.type != "cuda":
        raise ValueError(f"no Weiszfeld-step kernel for device {dev}")
    _, queue, count = chunk_activity(layout, torch.ones_like(undone), undone)
    return _launch(layout, y_lat, y_lon, mlat3, mlon3, ok3, queue, count,
                   "weiszfeld_step_sums_sparse")


def _plain(layout: BucketedEdges, y_lat, y_lon, mlat3, mlon3, ok3, ch_act):
    V = layout.n_vertices
    row, _, slot = slot_indices(layout, ch_act)
    keep = ok3.reshape(-1)[slot] > 0.0
    row, slot = row[keep], slot[keep]
    mlat, mlon = mlat3.reshape(-1)[slot], mlon3.reshape(-1)[slot]
    d = haversine(mlat, mlon, y_lat[row], y_lon[row])
    nz = d != 0.0
    dinv = torch.where(nz, 1.0 / torch.clamp(d, min=1e-30), 0.0)
    terms = torch.stack([nz.float(), dinv, dinv * mlat, dinv * mlon])
    out = torch.zeros((4, V), dtype=torch.float32, device=y_lat.device)
    out.index_add_(1, row, terms)
    return out[0], out[1], out[2], out[3]


def weiszfeld_step_sums_plain(layout: BucketedEdges, y_lat, y_lon, mlat3,
                              mlon3, ok3):
    """Plain PyTorch version of :func:`weiszfeld_step_sums`."""
    if layout.n_chunks == 0:
        return _zeros(layout)
    return _plain(layout, y_lat, y_lon, mlat3, mlon3, ok3, None)


def weiszfeld_step_sums_sparse_plain(layout: BucketedEdges, y_lat, y_lon,
                                     mlat3, mlon3, ok3, undone):
    """Plain PyTorch version of :func:`weiszfeld_step_sums_sparse`."""
    if layout.n_chunks == 0:
        return _zeros(layout)
    ch_act, _, _ = chunk_activity_plain(layout, torch.ones_like(undone),
                                        undone)
    return _plain(layout, y_lat, y_lon, mlat3, mlon3, ok3, ch_act)
