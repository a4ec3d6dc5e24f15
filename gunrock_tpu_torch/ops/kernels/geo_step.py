"""Geolocation's Weiszfeld step over the bucketed layout: the dense pass
and the chunk-skipping pass.

Ports of ``gunrock_tpu/ops/pallas/geo_step.py``:

- :func:`weiszfeld_step_sums` (kernel ``_make_wstep_kernel``): every slot
  of every chunk;
- :func:`weiszfeld_step_sums_sparse` (kernel ``_make_wstep_sparse_kernel``):
  every slot of the chunks whose row sub-blocks hold an ``undone`` vertex
  (``chunkplan.chunk_activity`` with ``active=None``, every source active,
  and ``undone`` as the row mask). Rows that no such chunk reaches come
  back 0; the geo loop never reads them.

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

On the card both are one template of two passes (dense, or over the
active chunks): a chunk-parallel pass sums each run of one row within a
tile and leaves the sums at the run's last slot, and a row-parallel pass
adds each row's runs in chunk order (:func:`run_table`). Every sum has a
fixed order: two calls on the same inputs give bit-equal sums.

CUDA source: ``csrc/geo_step.cu``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import weakref

import torch

from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.chunkplan import chunk_activity, chunk_activity_plain
from gunrock_tpu_torch.ops.kernels.layout import BucketedEdges, slot_indices

_RUN_BLOCKS_PER_SM = 8
_GROUP_RUNS = (4, 32)  # the most runs of a row taken by 1 lane, by 4 lanes
_TILE = 256  # gr::kThreads: the slots a block of the run pass takes at once
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gr_weiszfeld_step": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _I, _I, _I, _P, _I, _I, _I, _P],
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


@dataclasses.dataclass(frozen=True)
class RunTable:
    """Where the run pass leaves each run's sums and in which order the row
    pass adds them. A run is a maximal sequence of one row on consecutive
    real slots of a tile (``_TILE`` slots from a chunk's start); its sums
    sit at its last slot. ``group_rows`` lists the rows of at most
    ``_GROUP_RUNS[0]`` runs (``rows1`` of them), then of at most
    ``_GROUP_RUNS[1]`` (``rows4``), then the rest, which the row pass takes
    with 1, 4 and 32 lanes a row; row ``group_rows[p]``'s runs end at
    ``tail_slot[run_start[p]:run_start[p + 1]]``, in slot (chunk) order."""

    group_rows: torch.Tensor  # int32[n_vertices]
    run_start: torch.Tensor  # int32[n_vertices + 1]
    tail_slot: torch.Tensor  # int32[n_tails]
    rows1: int
    rows4: int


def run_table(layout: BucketedEdges) -> RunTable:
    """The layout's :class:`RunTable`, built on its device (cached)."""
    key = id(layout)
    hit = _RUN_TABLES.get(key)
    if hit is not None and hit[0]() is layout:
        return hit[1]
    W, C, V = layout.window, layout.chunk, layout.n_vertices
    rl = layout.row_local.long()
    pos = torch.arange(rl.numel(), device=rl.device) % C
    nxt = torch.cat([rl[1:], rl.new_full((1,), W)])
    tile_end = (pos % _TILE == _TILE - 1) | (pos == C - 1)
    slot = torch.nonzero((rl != W) & (tile_end | (nxt != rl))).flatten()
    row = layout.chunk_rb.long()[slot // C] * W + rl[slot]
    counts = torch.bincount(row, minlength=V)
    group = (counts > _GROUP_RUNS[0]).long() + (counts > _GROUP_RUNS[1]).long()
    group_rows = torch.argsort(group, stable=True)
    rank = torch.empty_like(group_rows)  # each row's place in group order
    rank[group_rows] = torch.arange(V, device=rl.device)
    run_start = torch.zeros(V + 1, dtype=torch.int64, device=rl.device)
    run_start[1:] = torch.cumsum(counts[group_rows], 0)
    order = torch.argsort(rank[row], stable=True)  # slots stay ascending
    table = RunTable(group_rows=group_rows.int(), run_start=run_start.int(),
                     tail_slot=slot[order].int(),
                     rows1=int((group == 0).sum()),
                     rows4=int((group == 1).sum()))
    _RUN_TABLES[key] = (weakref.ref(layout), table)
    weakref.finalize(layout, _RUN_TABLES.pop, key, None)
    return table


_RUN_TABLES: dict = {}  # id(layout): (weakref to it, its RunTable)


def _launch(layout: BucketedEdges, y_lat, y_lon, mlat3, mlon3, ok3, ch_act,
            what: str):
    dev, V = layout.device, layout.n_vertices
    table = run_table(layout)
    out = torch.empty((4, V), dtype=torch.float32, device=dev)  # written whole
    run_sums = torch.empty((layout.n_chunks * layout.chunk, 4),
                           dtype=torch.float32, device=dev)
    blocks = min(layout.n_chunks, _RUN_BLOCKS_PER_SM * _build.sm_count(dev))
    lib = _build.load("geo_step", _SIGNATURES)
    err = lib.gr_weiszfeld_step(
        _build.ptr(ch_act), blocks, layout.n_chunks,
        _build.ptr(layout.chunk_rb), _build.ptr(layout.row_local),
        _build.ptr(mlat3), _build.ptr(mlon3), _build.ptr(ok3),
        _build.ptr(y_lat), _build.ptr(y_lon), _build.ptr(run_sums),
        _build.ptr(table.group_rows), _build.ptr(table.run_start),
        _build.ptr(table.tail_slot), table.tail_slot.numel(),
        table.rows1, table.rows4, _build.ptr(out), layout.window,
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
    return _launch(layout, y_lat, y_lon, mlat3, mlon3, ok3, None,
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
    ch_act = chunk_activity(layout, None, undone, queue=False)[0]
    return _launch(layout, y_lat, y_lon, mlat3, mlon3, ok3, ch_act,
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
    ch_act = chunk_activity_plain(layout, None, undone, queue=False)[0]
    return _plain(layout, y_lat, y_lon, mlat3, mlon3, ok3, ch_act)
