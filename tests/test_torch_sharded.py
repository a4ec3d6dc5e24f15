"""The port's distributed layer (``gunrock_tpu_torch/parallel``) against
the JAX package's (``gunrock_tpu/parallel/sharded.py``).

One seeded directed weighted graph of 103 vertices and its symmetric twin
(so Vs = 26 and the last of the four shards is padded) go to both: the JAX
functions on ``make_mesh(4)`` of the 8 virtual CPU devices (the layout
cases run the Pallas kernels in interpret mode), the port's in four gloo
CPU ranks started once for the module (``mesh.spawn`` of
``probes.mesh.run_cases``, every case in one set of ranks). Both
exchange modes, with and without kernel layouts (the port's also at W=32,
where most of a shard's row blocks are empty, against JAX's segment
path). Tolerances are ROADMAP C's: exact for BFS depths, k-cores, colors
and counts, rtol 1e-5 for SSSP, rtol 1e-4 for the plus_times results
(PageRank atol 1e-9; PageRank and HITS with one iteration of slack), and
the JAX layer's own tests' for PPR, BC, geo and MST; the partition's
arrays and byte counts equal.
"""

import dataclasses

import jax
import numpy as np
import pytest

from gunrock_tpu.parallel import sharded as jsharded
from gunrock_tpu.parallel.mesh import make_mesh as j_make_mesh
from gunrock_tpu_torch.formats import Coo, coo_to_csr
from gunrock_tpu_torch.graph import Graph, GraphProperties, build_graph
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.parallel import sharded as tsharded
from gunrock_tpu_torch.parallel.mesh import spawn
from gunrock_tpu_torch.probes.mesh import run_cases
from tests.conftest import random_graph

N = 4
V = 103
MODES = {"allgather": False, "halo": True}
# the JAX kernels take windows of 128 and more: one row block at V=103
WC = dict(window=128, chunk=128)
# the port's also small ones, so that a shard's layout spans several row
# blocks of which most hold none of its edges (held against JAX's
# segment-reduction path)
W32 = dict(window=32, chunk=32)


def port_graph(jg) -> Graph:
    return Graph.from_arrays(
        {k: np.array(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")


@pytest.fixture(scope="module")
def graphs():
    jd, _ = random_graph(None, n=V, p=0.06, weighted=True, seed_offset=60)
    js, _ = random_graph(None, n=V, p=0.07, weighted=True, symmetric=True,
                         seed_offset=61)
    return {"dir": jd, "sym": js}


def _inputs():
    rng = np.random.default_rng(5)
    x = rng.random(V).astype(np.float32)
    lat = np.where(rng.random(V) < 0.4, rng.uniform(-60, 60, V),
                   np.nan).astype(np.float32)
    lon = np.where(np.isnan(lat), np.nan,
                   rng.uniform(-170, 170, V)).astype(np.float32)
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(1), V))
    return x, lat, lon, perm


# (case id, graph, algo, args, kwargs, the port's layouts, JAX's layouts);
# args and kwargs as both packages take them after the sharded graph
def _cases():
    x, lat, lon, perm = _inputs()
    inf = float("inf")
    cases = [
        ("bfs", "dir", "bfs", [0], {}, None),
        ("bfs_layouts", "dir", "bfs", [0], {}, dict(side="d", **WC)),
        ("sssp", "dir", "sssp", [0], {}, None),
        ("sssp_layouts", "dir", "sssp", [0], {},
         dict(side="d", pad_value=inf, **WC)),
        ("pagerank", "dir", "pagerank", [], {"tol": 1e-6}, None),
        ("pagerank_layouts", "dir", "pagerank", [], {"tol": 1e-6},
         dict(side="d", **WC)),
        ("spmv", "dir", "spmv", [x], {}, None),
        ("spmv_layouts", "dir", "spmv", [x], {}, dict(side="s", **WC)),
        ("hits", "dir", "hits", [], {"max_iterations": 20}, None),
        ("hits_layouts", "dir", "hits", [], {"max_iterations": 20},
         [dict(side="s", unit=True, **WC), dict(side="d", unit=True, **WC)]),
        ("ppr", "dir", "ppr", [5], {"epsilon": 1e-5}, None),
        ("color_dir", "dir", "color", [], {"perm": perm}, None),
        ("color_greedy_dir", "dir", "color_greedy", [], {}, None),
        ("spgemm_count", "dir", "spgemm_count", [], {}, None),
        ("bfs_sym", "sym", "bfs", [2], {}, None),
        ("kcore", "sym", "kcore", [], {}, None),
        ("color", "sym", "color", [], {"perm": perm}, None),
        ("color_greedy", "sym", "color_greedy", [], {}, None),
        ("bc", "sym", "bc", [3], {}, None),
        ("geo", "sym", "geo", [lat, lon],
         {"total_iterations": 2, "spatial_iterations": 50}, None),
        ("mst", "sym", "mst", [], {}, None),
        ("tc_ring", "sym", "tc_ring", [], {}, None),
    ]
    out = [c + (c[5],) for c in cases]
    # the port's layout path at W=32 against JAX's segment path
    for cid, g, algo, args, kw, lay in cases:
        if lay is not None:
            small = ([dict(L, **W32) for L in lay] if isinstance(lay, list)
                     else dict(lay, **W32))
            out.append((cid + "_w32", g, algo, args, kw, small, None))
    return out


CASE_IDS = [c[0] for c in _cases()]


def _jax_run(jg, algo, args, kwargs, layouts, sg, mesh):
    if algo == "tc_ring":
        return jsharded.tc_ring(jg, mesh)
    if algo == "spgemm_count":
        return jsharded.spgemm_count(sg, jg, mesh)
    kw = dict(kwargs)
    if algo == "color":
        kw = {"seed": 1}  # the permutation the port is handed
    if layouts is not None:
        build = lambda L: jsharded.build_sharded_layouts(  # noqa: E731
            jg, N, interpret=True, **L)
        kw["layouts"] = (tuple(build(L) for L in layouts)
                         if isinstance(layouts, list) else build(layouts))
    return getattr(jsharded, algo)(sg, *args, mesh, **kw)


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return np.asarray(x) if hasattr(x, "shape") else x


@pytest.fixture(scope="module")
def runs(graphs):
    """Every case in both modes: (port results, JAX results, the port's
    run info). The port's four ranks start once."""
    tg = {k: port_graph(g) for k, g in graphs.items()}
    cases, want = [], {}
    mesh = j_make_mesh(N)
    for mode, halo in MODES.items():
        sgs = {k: jsharded.partition_sharded(g, N, mesh, use_halo=halo)
               for k, g in graphs.items()}
        for cid, gkey, algo, args, kwargs, lay, jlay in _cases():
            case = {"name": f"{cid}-{mode}", "algo": algo, "graph": gkey,
                    "use_halo": halo, "args": args, "kwargs": kwargs,
                    "layouts": lay}
            if algo == "spgemm_count":
                case["graph_b"] = gkey
            cases.append(case)
            want[case["name"]] = _np(_jax_run(graphs[gkey], algo, args,
                                              kwargs, jlay, sgs[gkey], mesh))
    info = spawn(run_cases, N, tg, cases, "cpu", device="cpu")
    got = {c["name"]: c for c in info["cases"]}
    return got, want, info


def test_ranks_import_no_jax(runs):
    _, _, info = runs
    assert info["ranks"] == N and info["backend"] == "gloo"
    assert not info["staged"] and info["device"] == "cpu"
    assert info["foreign_modules"] == [[]] * N


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, equal_nan=True)


def _check(cid, got, want):
    algo = cid.split("_layouts")[0].split("_w32")[0]
    if algo in ("bfs", "bfs_sym"):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    elif algo == "sssp":
        _close(got[0], want[0], 1e-5, 0)
        assert got[1] == want[1]
    elif algo == "pagerank":
        _close(got[0], want[0], 1e-4, 1e-9)
        assert abs(got[1] - want[1]) <= 1
    elif algo == "spmv":
        _close(got, want, 1e-4, 1e-5)
    elif algo == "hits":
        _close(got[0], want[0], 1e-4, 1e-6)
        _close(got[1], want[1], 1e-4, 1e-6)
        assert abs(got[2] - want[2]) <= 1
    elif algo == "ppr":
        _close(got[0], want[0], 1e-5, 1e-8)
        assert got[1] == want[1]
    elif algo in ("kcore", "color", "color_dir", "color_greedy",
                  "color_greedy_dir"):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    elif algo == "bc":
        _close(got, want, 1e-4, 1e-5)
    elif algo == "geo":
        _close(got[0], want[0], 1e-3, 1e-3)
        _close(got[1], want[1], 1e-3, 1e-3)
    elif algo == "mst":
        _close(got[0], want[0], 1e-5, 0)
        assert got[1] == want[1]
    elif algo == "tc_ring":
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    elif algo == "spgemm_count":
        assert got[0] == want[0]
        _close(got[1], want[1], 1e-4, 0)
    else:
        raise AssertionError(f"no check for {cid}")


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("cid", CASE_IDS)
def test_sharded_matches_jax(runs, cid, mode):
    got, want, _ = runs
    name = f"{cid}-{mode}"
    _check(cid, got[name]["result"], want[name])
    # tc_ring takes the graph itself: no partition, no exchange mode
    assert got[name]["mode"] == (None if cid == "tc_ring" else
                                 "halo" if MODES[mode] else "all_gather")


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("gkey", ["dir", "sym"])
def test_partition_matches_jax(graphs, gkey, mode):
    """Each shard's arrays are the real prefix of JAX's padded shard, the
    halo tables and row splits equal, the meta fields the same."""
    jg = graphs[gkey]
    js = jsharded.partition_sharded(jg, N, None, use_halo=MODES[mode])
    tg = port_graph(jg)
    Ed, Es, Vs = js.ed_per_shard, js.es_per_shard, js.v_per_shard
    for s in range(N):
        ts = tsharded.partition_sharded(tg, N, use_halo=MODES[mode], shard=s)
        for f in ("n_vertices", "n_shards", "v_per_shard", "ed_per_shard",
                  "es_per_shard", "d_halo", "s_halo", "use_halo"):
            assert getattr(ts, f) == getattr(js, f), f
        for side, per in (("d", Ed), ("s", Es)):
            valid = np.asarray(getattr(js, f"{side}_valid")).reshape(N, per)[s]
            names = (("d_src", "d_dst_local", "d_val", "d_src_pos")
                     if side == "d" else
                     ("s_dst", "s_src_local", "s_val", "s_dst_pos"))
            for f in names:
                want = np.asarray(getattr(js, f)).reshape(N, per)[s]
                k = int(valid.sum())
                assert valid[:k].all()
                np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                              want[:k], err_msg=f)
            H = getattr(js, f"{side}_halo")
            for f in (f"{side}_send_idx", f"{side}_send_valid"):
                want = np.asarray(getattr(js, f)).reshape(N, N, H)[s]
                np.testing.assert_array_equal(getattr(ts, f).numpy(), want,
                                              err_msg=f)
            f = f"{side}_row_splits"
            np.testing.assert_array_equal(
                getattr(ts, f).numpy(),
                np.asarray(getattr(js, f)).reshape(N, Vs + 1)[s], err_msg=f)


@pytest.mark.parametrize("gkey", ["dir", "sym"])
def test_partition_takes_jax_positional_form(graphs, gkey):
    """``partition_sharded(g, 4, None, "edges", False)``: JAX's fourth
    parameter is ``axis_name``, its fifth ``use_halo``; the port's shard 0
    equals the real prefix of JAX's, and ``shard`` is keyword-only."""
    jg = graphs[gkey]
    tg = port_graph(jg)
    js = jsharded.partition_sharded(jg, N, None, "edges", False)
    ts = tsharded.partition_sharded(tg, N, None, "edges", False)
    assert ts.use_halo is False and js.use_halo is False
    for f in ("n_vertices", "v_per_shard", "ed_per_shard", "es_per_shard"):
        assert getattr(ts, f) == getattr(js, f), f
    for f, per in (("d_src", js.ed_per_shard), ("s_dst", js.es_per_shard)):
        want = np.asarray(getattr(js, f)).reshape(N, per)[0]
        got = getattr(ts, f).numpy()
        np.testing.assert_array_equal(got, want[:got.size], err_msg=f)
    kw = tsharded.partition_sharded(tg, N, axis_name="edges", use_halo=False,
                                    shard=0)
    np.testing.assert_array_equal(kw.d_src.numpy(), ts.d_src.numpy())
    with pytest.raises(TypeError):
        tsharded.partition_sharded(tg, N, None, "edges", False, 0)


@pytest.mark.parametrize("mode", list(MODES))
def test_collective_bytes_match_jax(graphs, mode):
    for jg in graphs.values():
        js = jsharded.partition_sharded(jg, N, None, use_halo=MODES[mode])
        ts = tsharded.partition_sharded(port_graph(jg), N,
                                        use_halo=MODES[mode])
        assert (tsharded.collective_bytes_per_exchange(ts)
                == jsharded.collective_bytes_per_exchange(js))
        for hosts in (1, 2):
            assert (tsharded.collective_bytes_detail(ts, hosts)
                    == jsharded.collective_bytes_detail(js, hosts))


def test_exchange_mode_picked_as_jax(graphs):
    for jg in graphs.values():
        js = jsharded.partition_sharded(jg, N, None)
        ts = tsharded.partition_sharded(port_graph(jg), N)
        assert ts.use_halo == js.use_halo


def test_layout_of_a_shard_holds_its_own_edges(graphs):
    """A shard's layout covers every row block of [V] but holds only the
    shard's edges; the other row blocks are unoccupied, and an edgeless
    shard's layout has no chunk."""
    tg = port_graph(graphs["dir"])
    Vs = -(-V // N)
    dst = tg.host["col_indices"]
    total = 0
    for s in range(N):
        L = tsharded.build_sharded_layouts(tg, N, side="d", shard=s, **W32)
        lay = L.layout
        assert lay.n_row_blocks == -(-V // W32["window"])
        rows = (np.repeat(lay.chunk_rb.numpy(), lay.chunk) * lay.window
                + lay.row_local.numpy())
        real = lay.row_local.numpy() != lay.window
        assert ((rows[real] // Vs) == s).all()
        total += int(real.sum())
        occupied = lay.rb_occupied.numpy()
        blocks = np.arange(lay.n_row_blocks) * lay.window
        assert not occupied[(blocks + lay.window <= s * Vs)
                            | (blocks >= (s + 1) * Vs)].any()
        assert int(real.sum()) == int((dst // Vs == s).sum())
    assert total == tg.n_edges
    # every edge into shard 0: shard 3's layout has no chunk
    h = tg.host
    keep = h["col_indices"] < Vs
    into0 = build_graph(coo_to_csr(Coo(
        n_rows=V, n_cols=V, row_indices=h["edge_src"][keep],
        col_indices=h["col_indices"][keep], values=h["values"][keep])),
        tg.properties, "cpu")
    L = tsharded.build_sharded_layouts(into0, N, side="d", shard=3, **W32)
    assert L.layout.n_chunks == 0
