"""Geolocation example CLI (role of reference
examples/algorithms/geo/geo.cu).

    python -m gunrock_tpu_torch.examples.geo --market datasets/chesapeake.mtx \\
        --validate [--labels FILE] [--total_iterations 10] \\
        [--spatial_iterations 1000] [--device cpu]

The reference example reads a labels file (``--labels``) with known
lat/long per vertex; without one, a deterministic 10% of the vertices get
random labels, so that the example runs on any graph. ``--devices N``
runs the sharded geolocation in N ranks.
"""

from __future__ import annotations

import sys

import numpy as np

from gunrock_tpu_torch.algorithms import geo
from gunrock_tpu_torch.examples import cpu_reference, runner
from gunrock_tpu_torch.io.parameters import parse
from gunrock_tpu_torch.utils.compare import to_numpy


def load_labels(path: str, n_vertices: int):
    """Reference labels file (geo.cu:12-100 semantics): ``%`` comments,
    then ONE size line ``N L L``, then ``node_id lat lon`` lines with
    0-BASED node ids; a line carrying only a node id means "coordinates
    missing" (left NaN)."""
    lat = np.full(n_vertices, np.nan, np.float32)
    lon = np.full(n_vertices, np.nan, np.float32)
    size_seen = False
    with open(path) as f:
        for line in f:
            if line.startswith("%") or not line.strip():
                continue
            if not size_seen:  # problem-description line: N L L
                size_seen = True
                continue
            parts = line.split()
            v = int(parts[0])
            if len(parts) >= 3 and 0 <= v < n_vertices:
                lat[v], lon[v] = float(parts[1]), float(parts[2])
    return lat, lon


def default_labels(n_vertices: int):
    """10% of the vertices (at least one), chosen and placed by
    ``default_rng(0)``: lat in [-60, 60], lon in [-180, 180]."""
    rng = np.random.default_rng(0)
    lat = np.full(n_vertices, np.nan, np.float32)
    lon = np.full(n_vertices, np.nan, np.float32)
    known = rng.choice(n_vertices, size=max(1, n_vertices // 10),
                       replace=False)
    lat[known] = rng.uniform(-60, 60, known.size).astype(np.float32)
    lon[known] = rng.uniform(-180, 180, known.size).astype(np.float32)
    return lat, lon


def main(argv=None) -> int:
    params = parse("geo", argv, extra_args=[
        (("--labels",), dict(default="", help="label file (vertex lat lon)")),
        (("--total_iterations",), dict(type=int, default=10)),
        (("--spatial_iterations",), dict(type=int, default=1000)),
    ])
    graph, _ = runner.load(params)
    V = graph.n_vertices
    if params.extra.labels:
        lat, lon = load_labels(params.extra.labels, V)
    else:
        lat, lon = default_labels(V)
    # labels are keyed by input vertex ids; permute into execution space
    lat = runner.to_relabeled(params, lat)
    lon = runner.to_relabeled(params, lon)
    times = []
    result = None
    out = runner.maybe_mesh(params, graph, "geo", [(
        [lat, lon], {"total_iterations": params.extra.total_iterations,
                     "spatial_iterations": params.extra.spatial_iterations})]
        * params.num_runs)
    if out is not None:
        times, results = out
        glat, glon = results[-1]
        result = geo.Result(latitude=glat, longitude=glon,
                            elapsed_ms=times[-1])
    else:
        for _ in range(params.num_runs):
            result = geo.run(
                graph, lat, lon,
                total_iterations=params.extra.total_iterations,
                spatial_iterations=params.extra.spatial_iterations,
                options=params.options, device=graph.device)
            times.append(result.elapsed_ms)
    glat, glon = to_numpy(result.latitude), to_numpy(result.longitude)
    located = int((~np.isnan(glat)).sum())
    print(f"located {located}/{V} vertices")
    runner.print_head(runner.to_original(params, result.latitude),
                      name="latitude")
    runner.finish(params, "geo", graph, times)
    if params.validate:
        n = cpu_reference.geo_invariants(graph, lat, lon, glat, glon)
        if n == 0:
            print("geo validation: PASSED")
        else:
            print(f"geo validation: FAILED ({n} invariant violations)")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
