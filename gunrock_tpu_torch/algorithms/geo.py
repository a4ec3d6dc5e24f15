"""Geolocation: predict lat/long for unlabeled vertices from neighbors.

Port of ``gunrock_tpu/algorithms/geo.py`` (role of reference
``algorithms/geo.hxx``): per outer iteration, every still-unlabeled vertex
computes a "spatial center" of its *labeled* out-neighbors
(geo.hxx:300-379):

- 1 labeled neighbor  -> copy its coordinates,
- 2 labeled neighbors -> spherical midpoint (geo.hxx:71-98),
- >2                  -> spatial median: Weiszfeld iteration under the
  haversine metric, starting from the neighborhood mean, with the
  reference's zero-distance / rinv correction (geo.hxx:131-238),

for a fixed number of outer iterations (geo.hxx:392-402). Invalid
coordinates are NaN.

As in the JAX package the per-vertex neighbor scans are per-edge masks and
per-vertex sums, and all unlabeled vertices run the Weiszfeld loop in
lockstep with per-vertex done-masking. On the main path (``layout``) a
step's four sums are one kernel pass over the push layout
(``ops/kernels/geo_step.py``): the chunk-skipping pass, which drops the
chunks whose rows have all converged. Otherwise the sums are a gather by
source and a scatter sum.
Both loops are Python loops here; the inner one reads the count of
vertices that still iterate back to the host after every step.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gunrock_tpu_torch.device import DEFAULT
from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.configs import LoadBalance, Options, default_options
from gunrock_tpu_torch.ops.kernels.geo_step import (
    haversine,
    weiszfeld_step_sums_sparse,
)
from gunrock_tpu_torch.ops.kernels.layout import push_layout
from gunrock_tpu_torch.utils.timer import timed

__all__ = ["Param", "Result", "geo_kernel", "haversine", "midpoint", "run"]


@dataclasses.dataclass
class Param:
    total_iterations: int = 10
    spatial_iterations: int = 1000


@dataclasses.dataclass
class Result:
    latitude: torch.Tensor  # float32[V]; NaN if undetermined
    longitude: torch.Tensor  # float32[V]
    elapsed_ms: float
    steps: list = dataclasses.field(default_factory=list)  # per outer iteration


def midpoint(lat1, lon1, lat2, lon2):
    """Spherical midpoint in degrees (reference geo.hxx:71-98)."""
    rad = math.pi / 180.0
    lat1, lon1, lat2, lon2 = lat1 * rad, lon1 * rad, lat2 * rad, lon2 * rad
    bx = torch.cos(lat2) * torch.cos(lon2 - lon1)
    by = torch.cos(lat2) * torch.sin(lon2 - lon1)
    mlat = torch.atan2(
        torch.sin(lat1) + torch.sin(lat2),
        torch.sqrt((torch.cos(lat1) + bx) ** 2 + by**2),
    )
    mlon = lon1 + torch.atan2(by, torch.cos(lat1) + bx)
    deg = 180.0 / math.pi
    return mlat * deg, mlon * deg


def _seg_sum(offsets, *vals):
    """Per-vertex sums of each of ``vals`` (f32[E], edges in CSR order) over
    the vertices' edge ranges ``offsets`` (int64[V + 1]): one segment
    reduction each, whose order of addition is fixed, so that two runs on
    the card give the same bits (a scatter by atomics does not). Not the
    cumulative-sum difference, whose f32 prefix over millions of
    coordinates has a degrees-scale ulp."""
    return tuple(torch.segment_reduce(v, "sum", offsets=offsets) for v in vals)


def _weiszfeld_update(sums, n_valid, y_lat, y_lon, out_lat, out_lon, done,
                      eps: float):
    """One Weiszfeld step from its four per-vertex sums (nonzero count,
    sum of 1/d, of lat/d, of lon/d), with the reference's correction for
    neighbors at distance zero (geo.hxx:139-238). Returns the new (y_lat,
    y_lon, out_lat, out_lon, done)."""
    nonzeros, dinvs, wlat, wlon = sums
    dsafe = torch.clamp(dinvs, min=1e-30)
    t_lat, t_lon = wlat / dsafe, wlon / dsafe
    num_zeros = n_valid - nonzeros
    all_zero = num_zeros == n_valid
    r_lat = (t_lat - y_lat) * dinvs
    r_lon = (t_lon - y_lon) * dinvs
    r = torch.sqrt(r_lat**2 + r_lon**2)
    rinv = torch.where(r == 0, 0.0, num_zeros / torch.clamp(r, min=1e-30))
    keep, move = torch.clamp(1 - rinv, min=0.0), torch.clamp(rinv, max=1.0)
    y1_lat = torch.where(num_zeros == 0, t_lat, keep * t_lat + move * y_lat)
    y1_lon = torch.where(num_zeros == 0, t_lon, keep * t_lon + move * y_lon)
    step = torch.sqrt((y_lat - y1_lat) ** 2 + (y_lon - y1_lon) ** 2)
    newly_done = ~done & (all_zero | (step < eps))
    out_lat = torch.where(newly_done, torch.where(all_zero, y_lat, y1_lat),
                          out_lat)
    out_lon = torch.where(newly_done, torch.where(all_zero, y_lon, y1_lon),
                          out_lon)
    done = done | newly_done
    return (torch.where(done, y_lat, y1_lat), torch.where(done, y_lon, y1_lon),
            out_lat, out_lon, done)


def geo_kernel(
    graph: Graph,
    latitude,
    longitude,
    total_iterations: int = 10,
    spatial_iterations: int = 1000,
    eps: float = 1e-3,
    layout=None,
    slot_dst=None,  # int64[n_chunks*C] global dst per layout slot
    slot_valid=None,  # bool[n_chunks*C] real (non-pad) slot
    steps_out: list | None = None,
):
    """Pure geolocation. Returns (latitude, longitude) f32[V].

    With ``layout`` (the push-oriented bucketed layout and its slot
    tables), the Weiszfeld step's sums run through the kernel of
    ``ops/kernels/geo_step.py``; otherwise through a gather by source and
    a scatter sum. ``steps_out`` receives the Weiszfeld steps of each
    outer iteration."""
    V, E, dev = graph.n_vertices, graph.n_edges, graph.device
    lat = torch.as_tensor(latitude, dtype=torch.float32, device=dev).clone()
    lon = torch.as_tensor(longitude, dtype=torch.float32, device=dev).clone()
    if E == 0:
        return lat, lon
    src = graph.edge_src.long()
    dst = graph.col_indices.long()
    offsets = graph.row_offsets.long()
    eid = torch.arange(E, dtype=torch.int32, device=dev)

    for _ in range(total_iterations):
        labeled = ~torch.isnan(lat)
        nb_ok = labeled[dst]
        unl = ~labeled

        # per-edge neighbor coordinates, fixed over the outer iteration,
        # 0 where the neighbor is unlabeled: its NaN stays out of the sums
        mlat = torch.where(nb_ok, lat[dst], 0.0)
        mlon = torch.where(nb_ok, lon[dst], 0.0)

        # count and mean of the valid neighbors (the median's start).
        # Counts in f32: exact while max degree < 2^24.
        n_valid, sum_lat, sum_lon = _seg_sum(offsets, nb_ok.float(), mlat,
                                             mlon)
        denom = torch.clamp(n_valid, min=1.0)
        y_lat, y_lon = sum_lat / denom, sum_lon / denom

        # first and last valid neighbor per vertex (the 1- and 2-cases)
        first_e = torch.full((V,), E, dtype=torch.int32, device=dev)
        first_e.scatter_reduce_(0, src, torch.where(nb_ok, eid, E),
                                reduce="amin", include_self=True)
        last_e = torch.full((V,), -1, dtype=torch.int32, device=dev)
        last_e.scatter_reduce_(0, src, torch.where(nb_ok, eid, -1),
                               reduce="amax", include_self=True)
        n1 = dst[torch.clamp(first_e, max=E - 1).long()]
        n2 = dst[torch.clamp(last_e, min=0).long()]
        n1_lat, n1_lon = lat[n1], lon[n1]
        mid_lat, mid_lon = midpoint(n1_lat, n1_lon, lat[n2], lon[n2])

        if layout is not None:
            # slot-space neighbor coordinates for the kernel step
            ok_slot = slot_valid & labeled[slot_dst]
            mlat3 = torch.where(ok_slot, lat[slot_dst], 0.0)
            mlon3 = torch.where(ok_slot, lon[slot_dst], 0.0)
            ok3 = ok_slot.float()

        # Weiszfeld under haversine, all vertices in lockstep; vertices
        # that will not take the median branch are done from step 0, so
        # that they cannot hold the early exit open
        needs_median = unl & (n_valid > 2)
        out_lat, out_lon, done = y_lat, y_lon, ~needs_median
        i = 0
        while i < spatial_iterations:
            if bool(done.all()):
                break
            if layout is not None:
                # chunk-skipping step: converged rows' chunks drop out
                sums = weiszfeld_step_sums_sparse(
                    layout, y_lat, y_lon, mlat3, mlon3, ok3, ~done)
            else:
                d = haversine(mlat, mlon, y_lat[src], y_lon[src])
                ok = nb_ok & (d != 0)
                dinv = torch.where(ok, 1.0 / torch.clamp(d, min=1e-30), 0.0)
                sums = _seg_sum(offsets, ok.float(), dinv, dinv * mlat,
                                dinv * mlon)
            y_lat, y_lon, out_lat, out_lon, done = _weiszfeld_update(
                sums, n_valid, y_lat, y_lon, out_lat, out_lon, done, eps)
            i += 1
        if steps_out is not None:
            steps_out.append(i)
        med_lat = torch.where(done, out_lat, y_lat)
        med_lon = torch.where(done, out_lon, y_lon)

        def pick(one, two, many, keep):
            return torch.where(
                unl & (n_valid == 1), one,
                torch.where(unl & (n_valid == 2), two,
                            torch.where(needs_median, many, keep)))

        lat = pick(n1_lat, mid_lat, med_lat, lat)
        lon = pick(n1_lon, mid_lon, med_lon, lon)
        # wrap longitudes into [-180, 180): coordinate-space means and
        # Weiszfeld steps near the date line produce values past 180, and
        # an unwrapped one would poison every later iteration that reads
        # it as a neighbor's label
        lon = torch.where(torch.isnan(lon), lon,
                          torch.remainder(lon + 180.0, 360.0) - 180.0)
    return lat, lon


def slot_tables(layout):
    """(slot_dst int64, slot_valid bool) of a layout: each slot's global
    column (0 on padding) and whether it is a real edge."""
    valid = layout.row_local != layout.window
    dst = (torch.repeat_interleave(layout.chunk_cb.long(), layout.chunk)
           * layout.window + layout.col_local)
    return torch.where(valid, dst, 0), valid


def run(
    graph: Graph,
    latitude,
    longitude,
    total_iterations: int = 10,
    spatial_iterations: int = 1000,
    options: Options | None = None,
    warmup: bool = True,
    device=DEFAULT,
) -> Result:
    """Role of reference ``geo::run`` (geo.hxx:417-447) on ``device``. With
    ``options.load_balance == PALLAS_MERGE_PATH`` (the default) the
    Weiszfeld steps run through the chunk-skipping kernel over the unit
    push layout, else through the scatter sums."""
    graph = graph.to(device)
    if options is None:
        options = default_options()
    layout = slot_dst = slot_valid = None
    if options.load_balance == LoadBalance.PALLAS_MERGE_PATH and graph.n_edges:
        # push orientation: rows = src, the vertex whose sums are taken
        layout = push_layout(graph, unit=True)
        if "geo_slots" not in graph.layouts:
            graph.layouts["geo_slots"] = slot_tables(layout)
        slot_dst, slot_valid = graph.layouts["geo_slots"]
    steps = []

    def fn():
        steps.clear()
        return geo_kernel(graph, latitude, longitude, total_iterations,
                          spatial_iterations, layout=layout,
                          slot_dst=slot_dst, slot_valid=slot_valid,
                          steps_out=steps)

    (lat, lon), elapsed_ms = timed(graph.device, fn, warmup)
    return Result(latitude=lat, longitude=lon, elapsed_ms=elapsed_ms,
                  steps=list(steps))
