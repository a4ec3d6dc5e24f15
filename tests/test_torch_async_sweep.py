"""The async sweep of the PyTorch port (``experimental/async_sweep.py`` on
``ops/kernels/async_sweep.py``'s plain versions) against the JAX
package's, on the CPU.

Tolerances: the min-plus sweeps are exact (the same f32 additions, a min
over the same candidates, block by block), so distances are bit-equal and
the sweep and block-pass counts equal. PageRank sums in another order, so
its ranks are held within rtol 1e-5 and its sweeps equal; where the last
sweep's largest change lands within rounding of ``tol`` the two may stop
one sweep apart (ROADMAP C), and only that case allows one."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csg
import torch

import gunrock_tpu.experimental.async_sweep as jasync
import gunrock_tpu.io.generators as jgen

import gunrock_tpu_torch.experimental.async_sweep as tasync
import gunrock_tpu_torch.io.generators as tgen
from gunrock_tpu_torch.examples import cpu_reference
from gunrock_tpu_torch.graph import Graph, GraphProperties
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.ops.kernels import async_sweep as kernels

ROOT = Path(__file__).resolve().parent.parent
CHESAPEAKE = str(ROOT / "datasets" / "chesapeake.mtx")


def _carry(jg):
    """The JAX graph's arrays as a port graph on the CPU (own copies)."""
    return Graph.from_arrays(
        {k: np.array(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")


def _odd():
    sys.path.insert(0, str(ROOT))
    from tests.test_fuzz import _odd_graph

    jg, _ = _odd_graph(7)
    return jg, _carry(jg)


def _pair(kind):
    """(JAX graph, port graph, source)."""
    if kind == "grid32":
        return (jgen.grid2d_graph(32, weighted=True),
                tgen.grid2d_graph(32, weighted=True, device="cpu"), 0)
    if kind == "rmat10":
        jg = jgen.rmat_graph(10, 8, seed=2)
        tg = tgen.rmat_graph(10, 8, seed=2, device="cpu")
        top = int(np.argmax(np.diff(tg.host["row_offsets"])))
        return jg, tg, top
    if kind == "delaunay512":
        return (jgen.delaunay_graph(512, seed=3),
                tgen.delaunay_graph(512, seed=3, device="cpu"), 5)
    jg, tg = _odd()
    return jg, tg, int(np.argmax(np.diff(tg.host["row_offsets"])))


SEARCHES = [
    ("grid32", "natural", 32), ("grid32", "rcm", 32),
    ("rmat10", "natural", 32), ("rmat10", "rcm", 32),
    ("delaunay512", "natural", 32), ("delaunay512", "rcm", 32),
    ("delaunay512", "natural", 7),
    ("odd", "natural", 8), ("odd", "natural", 1), ("odd", "natural", 1000),
    ("odd", "rcm", 8),
]


@pytest.mark.parametrize("fn", ["sssp_async", "bfs_async"])
@pytest.mark.parametrize("kind,ordering,n_blocks", SEARCHES)
def test_min_plus_sweeps_match_jax(kind, ordering, n_blocks, fn):
    """Distances bit-equal, sweeps and block passes equal."""
    jg, tg, src = _pair(kind)
    jd, js, jp = getattr(jasync, fn)(jg, src, n_blocks=n_blocks,
                                     ordering=ordering)
    td, ts, tp = getattr(tasync, fn)(tg, src, n_blocks=n_blocks,
                                     ordering=ordering)
    assert td.dtype == (torch.float32 if fn == "sssp_async" else torch.int32)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert (ts, tp) == (js, jp)


@pytest.mark.parametrize("max_sweeps", [0, 1, 2])
def test_min_plus_sweep_cap_matches_jax(max_sweeps):
    jg, tg, src = _pair("delaunay512")
    jd, js, jp = jasync.sssp_async(jg, src, max_sweeps=max_sweeps)
    td, ts, tp = tasync.sssp_async(tg, src, max_sweeps=max_sweeps)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert (ts, tp) == (js, jp) and ts == max_sweeps


def test_async_sssp_matches_dijkstra():
    for kind in ("grid32", "rmat10", "delaunay512"):
        _, tg, src = _pair(kind)
        h = tg.host
        A = sp.csr_matrix((h["values"], h["col_indices"], h["row_offsets"]),
                          shape=(tg.n_vertices,) * 2)
        d, sweeps, passes = tasync.sssp_async(tg, src)
        np.testing.assert_allclose(d.numpy(), csg.dijkstra(A, indices=src),
                                   rtol=1e-5, atol=1e-5)
        assert sweeps >= 1 and passes >= sweeps


def test_async_bfs_beats_bsp_levels_on_grids():
    """The JAX package's target (tests/test_async_sweep.py:33-48): the
    64x64 grid (126 BSP levels) in at most 4 sweeps and 15 full-pass
    equivalents of work."""
    g = tgen.grid2d_graph(64, weighted=True, device="cpu")
    depth, sweeps, passes = tasync.bfs_async(g, 0, n_blocks=32)
    want = cpu_reference.bfs(g, 0)
    np.testing.assert_array_equal(depth.numpy(), want)
    assert want[want < 2**31 - 1].max() == 126
    assert sweeps <= 4, sweeps
    assert passes / 32 <= 15, passes


def test_rcm_is_cached_and_takes_no_more_sweeps():
    """ordering='rcm' relabels once a graph (graph.layouts[("rcm",)]) and
    maps results back to input ids; on the mesh it takes no more sweeps
    than the natural order."""
    _, tg, src = _pair("delaunay512")
    d_nat, s_nat, _ = tasync.sssp_async(tg, src)
    d_rcm, s_rcm, _ = tasync.sssp_async(tg, src, ordering="rcm")
    cached = tg.layouts[("rcm",)]
    tasync.bfs_async(tg, src, ordering="rcm")
    assert tg.layouts[("rcm",)] is cached
    torch.testing.assert_close(d_rcm, d_nat, rtol=1e-5, atol=1e-5)
    assert s_rcm <= s_nat
    with pytest.raises(ValueError, match="ordering"):
        tasync.sssp_async(tg, src, ordering="bogus")
    with pytest.raises(ValueError, match="out of range"):
        tasync.bfs_async(tg, tg.n_vertices)


PR_CASES = [("rmat10", 16, 1e-6), ("rmat10", 32, 1e-6),
            ("grid32", 32, 1e-6), ("delaunay512", 32, 1e-7),
            ("odd", 8, 1e-7), ("rmat10", 16, 1e-7)]


@pytest.mark.parametrize("kind,n_blocks,tol", PR_CASES)
def test_pr_async_matches_jax(kind, n_blocks, tol):
    jg, tg, _ = _pair(kind)
    jp, js = jasync.pr_async(jg, tol=tol, n_blocks=n_blocks)
    tp, ts = tasync.pr_async(tg, tol=tol, n_blocks=n_blocks)
    if (kind, n_blocks, tol) == ("rmat10", 16, 1e-7):
        # rounding decides the stop here: JAX 31 sweeps, the port 32
        # (ROADMAP C); at the same cap the ranks agree
        assert abs(ts - js) <= 1
        tp, ts = tasync.pr_async(tg, tol=tol, n_blocks=n_blocks,
                                 max_sweeps=js)
    assert ts == js
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=0)


def test_pr_async_near_the_float64_fixed_point():
    """As the JAX test holds its own (tests/test_async_sweep.py:99-124):
    within rtol 1e-4 of the float64 fixed point at tol 1e-7, within the
    JAX bounds of pr.run, and n_blocks=1 is Jacobi: pr.run's iteration
    count."""
    from gunrock_tpu_torch.algorithms import pr

    _, g, _ = _pair("rmat10")
    h = g.host
    V = g.n_vertices
    A = sp.csr_matrix((h["values"].astype(np.float64), h["col_indices"],
                       h["row_offsets"]), shape=(V, V))
    outw = np.asarray(A.sum(axis=1)).ravel()
    iw = np.where(outw != 0, 1 / np.maximum(outw, 1e-300), 0.0)
    p = np.full(V, 1 / V)
    for _ in range(2000):
        pn = (1 - 0.85 + 0.85 * p[outw == 0].sum()) / V + 0.85 * A.T.dot(p * iw)
        if np.abs(pn - p).max() < 1e-13:
            break
        p = pn
    p_gs, _ = tasync.pr_async(g, tol=1e-7, n_blocks=16)
    assert float(np.max(np.abs(p_gs.numpy().astype(np.float64) - p) / p)) < 1e-4
    ref = pr.run(g, tol=1e-7, device="cpu")
    np.testing.assert_allclose(p_gs.numpy(), ref.p.numpy(), rtol=1e-2,
                               atol=1e-6)
    _, s1 = tasync.pr_async(g, tol=1e-6, n_blocks=1)
    assert s1 == pr.run(g, tol=1e-6, device="cpu").iterations


def _plan(tg, n_blocks):
    v_starts, e_starts = tasync._block_plan(tg, n_blocks)
    return tg.csc_rows, tg.csc_values, tg.csc_dst, v_starts, e_starts


@pytest.mark.parametrize("kind,n_blocks", [("rmat10", 1), ("rmat10", 3),
                                           ("rmat10", 32), ("odd", 1000)])
def test_block_plan_matches_jax(kind, n_blocks):
    jg, tg, _ = _pair(kind)
    jv, _, je, _ = jasync._block_plan(jg, n_blocks)
    tv, te = tasync._block_plan(tg, n_blocks)
    assert tv.dtype == te.dtype == torch.int32
    np.testing.assert_array_equal(jv, tv.numpy())
    np.testing.assert_array_equal(je, te.numpy())


def test_wrappers_check_their_inputs():
    _, tg, src = _pair("grid32")
    rows, vals, dst, vs, es = _plan(tg, 4)
    V = tg.n_vertices
    dist0 = torch.full((V,), float("inf"))
    with pytest.raises(ValueError, match="dist0"):
        kernels.gs_sweep_min(rows, vals, dst, vs, es, dist0.double(), 10)
    with pytest.raises(ValueError, match="e_starts"):
        kernels.gs_sweep_min(rows, vals, dst, vs, es[:-1], dist0, 10)
    with pytest.raises(ValueError, match="csc_values"):
        kernels.gs_sweep_pr(rows, vals.double(), dst, vs, es,
                            torch.ones(V), torch.zeros(V, dtype=torch.bool),
                            torch.full((V,), 1.0 / V), 0.85, 1e-6, 10)
    meta = [t.to("meta") for t in (rows, vals, dst, vs, es, dist0)]
    with pytest.raises(ValueError, match="no gs_sweep_min kernel"):
        kernels.gs_sweep_min(*meta, 10)


def test_edgeless_graph_costs_one_pass_a_block():
    jg = jgen.grid2d_graph(1)  # one vertex, no edge
    tg = tgen.grid2d_graph(1, device="cpu")
    assert tg.n_edges == 0
    jd, js, jp = jasync.sssp_async(jg, 0, n_blocks=4)
    td, ts, tp = tasync.sssp_async(tg, 0, n_blocks=4)
    assert (ts, tp) == (js, jp) == (1, 1)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    jp_, js_ = jasync.pr_async(jg)
    tp_, ts_ = tasync.pr_async(tg)
    assert ts_ == js_
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp_), rtol=1e-6)


@pytest.mark.parametrize("cli,extra", [("bfs", ["--mode", "async"]),
                                       ("bfs", ["--mode", "async", "--ordering",
                                                "rcm"]),
                                       ("sssp", ["--mode", "async",
                                                 "--ordering", "rcm"]),
                                       ("sssp", ["--mode", "async"])])
def test_async_clis_validate_and_match_jax(cli, extra, capsys):
    """--mode async (and --ordering) on the bfs and sssp CLIs with
    --validate on chesapeake: the same ``async: N sweeps, M block
    passes`` line as the JAX CLI, and search_depth = the sweeps."""
    import importlib

    argv = ["--market", CHESAPEAKE, "--src", "0", "--validate", *extra]
    jmod = importlib.import_module(f"gunrock_tpu.examples.{cli}")
    tmod = importlib.import_module(f"gunrock_tpu_torch.examples.{cli}")
    jmod.main(argv)
    jout = capsys.readouterr().out
    assert tmod.main(argv + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    line = [ln for ln in jout.splitlines() if ln.startswith("async:")]
    assert line and line == [ln for ln in tout.splitlines()
                             if ln.startswith("async:")]
    sweeps = int(line[0].split()[1])
    assert f"search depth {sweeps}" in tout
    assert f"{cli} validation: PASSED" in tout
