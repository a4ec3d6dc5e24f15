"""Geolocation of the PyTorch port against the JAX package, on one R-MAT
graph carried across with ``Graph.from_arrays`` and one set of numpy
labels: both Weiszfeld paths (the kernel step over the push layout, the
scatter sums), the 1- and 2-neighbour closed forms, the date-line wrap,
the labels file reader, the invariants oracle, the CLI and the interop
wrapper on the CPU.

Tolerance: rtol 2e-3 / atol 2e-3 on the final coordinates with the same
located vertices, the JAX package's own limit between its two paths
(tests/test_algorithms_wave3.py): its kernel's arcsin is a polynomial, and
a Weiszfeld run amplifies last-bit differences over its steps."""

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from gunrock_tpu.algorithms import geo as jgeo
from gunrock_tpu.io.generators import rmat_graph as j_rmat_graph
from gunrock_tpu.ops.configs import LoadBalance as JLoadBalance
from gunrock_tpu.ops.configs import Options as JOptions

from gunrock_tpu_torch import interop
from gunrock_tpu_torch.algorithms import geo
from gunrock_tpu_torch.examples import cpu_reference
from gunrock_tpu_torch.examples import geo as geo_cli
from gunrock_tpu_torch.formats import Coo
from gunrock_tpu_torch.graph import Graph, GraphProperties, build_graph
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.io import load_graph_file
from gunrock_tpu_torch.ops.configs import LoadBalance, Options

CHESAPEAKE = str(Path(__file__).resolve().parent.parent / "datasets" / "chesapeake.mtx")
PATHS = {"kernels": "PALLAS_MERGE_PATH", "plain": "XLA_SEGMENT"}


@pytest.fixture(scope="module")
def case():
    """(JAX graph, port graph, lat, lon): undirected R-MAT scale 8, 40% of
    the vertices labeled."""
    jg = j_rmat_graph(scale=8, edge_factor=12, seed=5, undirected=True)
    tg = Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")
    rng = np.random.default_rng(0)
    V = jg.n_vertices
    lat = np.where(rng.random(V) < 0.4, rng.uniform(-60, 60, V), np.nan)
    lon = np.where(np.isnan(lat), np.nan, rng.uniform(-170, 170, V))
    return jg, tg, lat.astype(np.float32), lon.astype(np.float32)


def _assert_located_alike(got, want_lat, want_lon):
    a = np.asarray(want_lat)
    m = np.isfinite(a)
    np.testing.assert_array_equal(m, np.isfinite(got.latitude.numpy()))
    assert m.sum() > 100
    np.testing.assert_allclose(got.latitude.numpy()[m], a[m], rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(got.longitude.numpy()[m],
                               np.asarray(want_lon)[m], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("path", ["kernels", "plain"])
def test_geo_run_matches_jax(case, path):
    jg, tg, lat, lon = case
    kw = dict(total_iterations=2, spatial_iterations=25, warmup=False)
    want = jgeo.run(jg, lat, lon, options=JOptions(
        load_balance=getattr(JLoadBalance, PATHS[path])), **kw)
    got = geo.run(tg, lat, lon, options=Options(
        load_balance=getattr(LoadBalance, PATHS[path])), device="cpu", **kw)
    _assert_located_alike(got, want.latitude, want.longitude)
    assert len(got.steps) == 2 and 0 < got.steps[0] <= 25
    assert cpu_reference.geo_invariants(
        tg, lat, lon, got.latitude.numpy(), got.longitude.numpy()) == 0


def test_geo_paths_agree_and_every_step_is_chunk_skipping(case, monkeypatch):
    """The kernel path equals the scatter-sum path, and each of its
    Weiszfeld steps is one chunk-skipping pass, as in the JAX package."""
    _, tg, lat, lon = case
    calls = []
    fn = geo.weiszfeld_step_sums_sparse
    monkeypatch.setattr(geo, "weiszfeld_step_sums_sparse",
                        lambda *a: (calls.append(1), fn(*a))[1])
    kw = dict(total_iterations=3, spatial_iterations=200, warmup=False,
              device="cpu")
    a = geo.run(tg, lat, lon, **kw)
    assert len(calls) == sum(a.steps) > 0
    b = geo.run(tg, lat, lon, options=Options(), **kw)
    _assert_located_alike(a, b.latitude.numpy(), b.longitude.numpy())
    assert a.steps == b.steps


def _tiny(rows, cols, n):
    return build_graph(
        Coo(n, n, np.asarray(rows, np.int32), np.asarray(cols, np.int32),
            np.ones(len(rows), np.float32)),
        GraphProperties(directed=True, weighted=False), device="cpu")


@pytest.mark.parametrize("path", ["kernels", "plain"])
def test_geo_one_and_two_neighbours(path):
    """1 labeled neighbour: copy it; 2: the spherical midpoint (reference
    geo.hxx:345-366)."""
    g = _tiny([2, 3, 3], [0, 0, 1], 4)  # v2 -> v0; v3 -> v0, v1
    lat = np.array([10.0, 20.0, np.nan, np.nan], np.float32)
    lon = np.array([30.0, 40.0, np.nan, np.nan], np.float32)
    res = geo.run(g, lat, lon, total_iterations=2, spatial_iterations=5,
                  options=Options(load_balance=getattr(LoadBalance,
                                                       PATHS[path])),
                  warmup=False, device="cpu")
    out_lat, out_lon = res.latitude.numpy(), res.longitude.numpy()
    assert abs(out_lat[2] - 10.0) < 1e-4 and abs(out_lon[2] - 30.0) < 1e-4
    la1, lo1, la2, lo2 = map(math.radians, (10, 30, 20, 40))
    bx = math.cos(la2) * math.cos(lo2 - lo1)
    by = math.cos(la2) * math.sin(lo2 - lo1)
    want_lat = math.degrees(math.atan2(
        math.sin(la1) + math.sin(la2),
        math.sqrt((math.cos(la1) + bx) ** 2 + by ** 2)))
    want_lon = math.degrees(lo1 + math.atan2(by, math.cos(la1) + bx))
    assert abs(out_lat[3] - want_lat) < 1e-3
    assert abs(out_lon[3] - want_lon) < 1e-3
    assert cpu_reference.geo_invariants(g, lat, lon, out_lat, out_lon) == 0


def test_geo_median_cluster_chain_and_date_line():
    # spatial median: 4 neighbours near (50, 8), one outlier
    g = _tiny([0] * 5, range(1, 6), 6)
    lat = np.array([np.nan, 50.0, 50.1, 49.9, 50.05, -30.0], np.float32)
    lon = np.array([np.nan, 8.0, 8.1, 7.9, 8.05, 120.0], np.float32)
    res = geo.run(g, lat, lon, total_iterations=1, spatial_iterations=200,
                  warmup=False, device="cpu")
    want = jgeo.run(_jax_graph(g), lat, lon, total_iterations=1,
                    spatial_iterations=200, warmup=False)
    assert abs(float(res.latitude[0]) - 50.0) < 0.5
    assert abs(float(res.longitude[0]) - 8.0) < 0.5
    np.testing.assert_allclose(res.latitude.numpy(), np.asarray(want.latitude),
                               rtol=2e-3, atol=2e-3)
    # labels spread hop by hop along a chain 3 -> 2 -> 1 -> 0
    g = _tiny([1, 2, 3], [0, 1, 2], 4)
    lat = np.array([42.0, np.nan, np.nan, np.nan], np.float32)
    lon = np.array([7.0, np.nan, np.nan, np.nan], np.float32)
    res = geo.run(g, lat, lon, total_iterations=3, spatial_iterations=5,
                  warmup=False, device="cpu")
    np.testing.assert_allclose(res.latitude.numpy(), [42] * 4, atol=1e-3)
    two = geo.run(g, lat, lon, total_iterations=2, spatial_iterations=5,
                  warmup=False, device="cpu")
    assert np.isnan(float(two.latitude[3]))
    # three neighbours just west of the date line, one just east: the
    # result is wrapped into [-180, 180)
    g = _tiny([0] * 4, range(1, 5), 5)
    lat = np.array([np.nan, 10.0, 10.5, 9.5, 10.0], np.float32)
    lon = np.array([np.nan, 179.5, 179.9, 179.7, -179.8], np.float32)
    res = geo.run(g, lat, lon, total_iterations=1, warmup=False, device="cpu")
    want = jgeo.run(_jax_graph(g), lat, lon, total_iterations=1, warmup=False)
    assert -180.0 <= float(res.longitude[0]) < 180.0
    np.testing.assert_allclose(res.longitude.numpy(),
                               np.asarray(want.longitude), rtol=2e-3,
                               atol=2e-3)


def _jax_graph(tg):
    from gunrock_tpu.graph import build_graph_from_arrays
    from gunrock_tpu.graph.properties import GraphProperties as JProps

    h = tg.host
    return build_graph_from_arrays(
        tg.n_vertices, h["row_offsets"], h["col_indices"], h["values"],
        properties=JProps(**dataclasses.asdict(tg.properties)))


def test_haversine_and_midpoint_match_jax():
    rng = np.random.default_rng(3)
    a, b = rng.uniform(-80, 80, (2, 500)).astype(np.float32)
    c, d = rng.uniform(-180, 180, (2, 500)).astype(np.float32)
    ta, tb, tc, td = (torch.from_numpy(x) for x in (a, b, c, d))
    np.testing.assert_allclose(geo.haversine(ta, tc, tb, td).numpy(),
                               np.asarray(jgeo.haversine(a, c, b, d)),
                               rtol=1e-4, atol=1e-2)
    for got, want in zip(geo.midpoint(ta, tc, tb, td),
                         jgeo.midpoint(a, c, b, d)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-3)


def test_load_labels_reference_format(tmp_path):
    """0-based ids after one size line; an id alone leaves NaN."""
    path = tmp_path / "labels.txt"
    path.write_text("% comment\n5 5 3\n0 10.5 -20.25\n3 1.0 2.0\n4\n9 1 1\n")
    lat, lon = geo_cli.load_labels(str(path), 5)
    np.testing.assert_array_equal(np.isnan(lat), [False, True, True, False, True])
    assert (lat[0], lon[0], lat[3], lon[3]) == (10.5, -20.25, 1.0, 2.0)
    lat, lon = geo_cli.default_labels(39)
    assert np.isfinite(lat).sum() == 3 and (np.isfinite(lat) == np.isfinite(lon)).all()


def test_geo_invariants_counts_violations(case):
    _, tg, lat, lon = case
    res = geo.run(tg, lat, lon, total_iterations=1, spatial_iterations=5,
                  warmup=False, device="cpu")
    out_lat, out_lon = res.latitude.numpy().copy(), res.longitude.numpy().copy()
    labeled = np.flatnonzero(np.isfinite(lat))
    out_lat[labeled[0]] += 1.0  # a label moved
    out_lon[labeled[1]] = 200.0  # moved and out of range
    assert cpu_reference.geo_invariants(tg, lat, lon, out_lat, out_lon) == 3


@pytest.mark.parametrize("extra", [
    [], ["--reorder", "degree"],
    ["--total_iterations", "2", "--spatial_iterations", "50",
     "--advance_load_balance", "xla_segment"],
], ids=["default", "degree", "plain_short"])
def test_geo_cli_validates_on_cpu(extra, capsys):
    argv = ["--market", CHESAPEAKE, "--validate", "--device", "cpu", *extra]
    assert geo_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "geo validation: PASSED" in out and "located" in out


def test_geo_cli_reads_labels(tmp_path, capsys):
    path = tmp_path / "labels.txt"
    path.write_text("39 39 2\n0 10 20\n7 -5 30\n")
    assert geo_cli.main(["--market", CHESAPEAKE, "--validate", "--device",
                         "cpu", "--labels", str(path)]) == 0
    assert "geo validation: PASSED" in capsys.readouterr().out


def test_interop_geo_run_default_iterations():
    tg, _ = load_graph_file(CHESAPEAKE, device="cpu")
    lat, lon = geo_cli.default_labels(tg.n_vertices)
    res = interop.geo_run(tg, lat, lon, device="cpu")
    assert len(res.steps) == 3  # total_iterations defaults to 3 here
    assert cpu_reference.geo_invariants(
        tg, lat, lon, res.latitude.numpy(), res.longitude.numpy()) == 0
