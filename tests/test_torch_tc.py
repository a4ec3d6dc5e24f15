"""Triangle counting of the PyTorch port against the JAX package and the
CPU oracle, on graphs carried across with ``Graph.from_arrays``: the DAG
constructions and host wedge enumerations (exact), the device wedge
enumeration of a slab against the host one, the sort-merge join, the
slabbed run, the probe kernel, a directed input, the total-only join, the
CLI and the interop wrapper on the CPU. Everything here is integer
arithmetic and is compared exactly."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrock_tpu.algorithms import tc as jtc
from gunrock_tpu.io.generators import rmat_graph as j_rmat_graph

from gunrock_tpu_torch import interop
from gunrock_tpu_torch.algorithms import tc
from gunrock_tpu_torch.examples import cpu_reference
from gunrock_tpu_torch.examples import tc as tc_cli
from gunrock_tpu_torch.formats import Coo
from gunrock_tpu_torch.graph import Graph, GraphProperties, build_graph
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.io import load_graph_file

CHESAPEAKE = str(Path(__file__).resolve().parent.parent / "datasets" / "chesapeake.mtx")


def _carry(jg):
    return Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")


@pytest.fixture(scope="module", params=["undirected", "directed"])
def graphs(request):
    """(JAX graph, port graph): R-MAT scale 9, symmetric or directed (the
    directed one is symmetrized inside)."""
    jg = j_rmat_graph(scale=9, edge_factor=10, seed=2,
                      undirected=request.param == "undirected")
    return jg, _carry(jg)


def test_build_dag_matches_jax(graphs):
    jg, tg = graphs
    for got, want in zip(tc.build_dag(tg), jtc.build_dag(jg)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_build_dag_ranked_and_wedges_match_jax(graphs):
    jg, tg = graphs
    got, want = tc.build_dag_ranked(tg), jtc.build_dag_ranked(jg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["n_wedges"] > 10_000 and got["max_deg"] > 8
    for t0, t1 in ((0, None), (777, 4321)):
        a = tc.build_wedges_ranked(got["wadj"], got["weu"], got["woff"], t0, t1)
        b = jtc.build_wedges_ranked(want["wadj"], want["weu"], want["woff"],
                                    t0, t1)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert (a[1] > a[0]).all()  # rank space: every wedge is oriented
        a = tc.build_wedges(*tc.build_dag(tg), t0, t1)
        b = jtc.build_wedges(*jtc.build_dag(jg), t0, t1)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("use_banded", [True, False])
def test_slab_wedges_match_host_enumeration(graphs, use_banded):
    """The device enumeration of every slab (cumulative sums and the
    banded gather) equals the host enumeration of the same wedge range;
    unused tail slots come back with wv == V."""
    _, tg = graphs
    rk = tc.build_dag_ranked(tg)
    V, T, B = tg.n_vertices, 256, 4096
    span_rows = tc.span_rows_for(rk["max_deg"], T)
    woff = torch.from_numpy(rk["woff"])
    args = (torch.from_numpy(rk["wadj"]), torch.from_numpy(rk["weu"]), woff,
            torch.from_numpy(np.diff(rk["woff"])))
    wtab2 = torch.from_numpy(tc.pad_table(rk["wadj"], span_rows))
    n = rk["n_wedges"]
    for w0 in (0, 3 * B, (n // B) * B):
        n_valid = min(n - w0, B)
        wv, ww, wu = tc._slab_wedges_ranked(
            *args, w0, n_valid, wtab2, V=V, B=B, T=T, span_rows=span_rows,
            use_banded=use_banded)
        hv, hw, hu = tc.build_wedges_ranked(rk["wadj"], rk["weu"], rk["woff"],
                                            w0, w0 + B)
        assert hv.size == n_valid
        np.testing.assert_array_equal(wv.numpy()[:n_valid], hv)
        np.testing.assert_array_equal(ww.numpy()[:n_valid], hw)
        np.testing.assert_array_equal(wu.numpy()[:n_valid], hu)
        assert (wv.numpy()[n_valid:] == V).all()
    assert n % B  # the last slab had a tail


def test_slab_banded_inputs_stay_in_their_windows(graphs):
    """The contract the banded kernel relies on: every real position lies
    inside its block's window, and every window inside the padded table.
    The JAX kernel gathers the same values from the same inputs."""
    from gunrock_tpu.ops.pallas.banded import banded_gather as j_banded

    _, tg = graphs
    rk = tc.build_dag_ranked(tg)
    T, B = 256, 8192
    span_rows = tc.span_rows_for(rk["max_deg"], T)
    wtab2 = tc.pad_table(rk["wadj"], span_rows)
    woff = torch.from_numpy(rk["woff"])
    off = torch.clamp(woff - B, 0, B)[:-1]
    skip = torch.minimum(torch.clamp(B - woff[:-1], min=0),
                         torch.from_numpy(np.diff(rk["woff"])))
    base = torch.arange(rk["wadj"].size) + 1 + skip
    _, adj_pos = tc._piecewise_expand(torch.from_numpy(rk["wadj"]), base, off, B)
    valid = torch.arange(B) < B - 100
    idx, block_lo = tc.banded_inputs(adj_pos, valid, wtab2.shape[0],
                                     span_rows, T)
    lo = np.repeat(block_lo.numpy().astype(np.int64) * 128, T)
    assert ((idx.numpy() >= lo) | ~valid.numpy()).all()
    assert ((idx.numpy() < lo + span_rows * 128) | ~valid.numpy()).all()
    assert (block_lo.numpy() + span_rows <= wtab2.shape[0]).all()
    got = tc.banded_gather(torch.from_numpy(wtab2), idx, block_lo,
                           span_rows=span_rows, block_t=T).numpy()
    want = np.asarray(j_banded(jnp.asarray(wtab2), jnp.asarray(idx.numpy()),
                               jnp.asarray(block_lo.numpy()),
                               span_rows=span_rows, block_t=T, interpret=True))
    np.testing.assert_array_equal(got, want)
    v = valid.numpy()
    np.testing.assert_array_equal(got[v], rk["wadj"][adj_pos.numpy()[v]])


def test_tc_kernel_by_keyword_matches_jax(graphs):
    """``tc_kernel`` called by JAX's parameter names; JAX's edges padded
    with -1 to a multiple of the chunk, as it requires."""
    jg, tg = graphs
    offsets, adj, eu, ev, _ = tc.build_dag(tg)
    D, chunk = int(np.diff(offsets).max()), 128
    pad = -eu.size % chunk
    jeu, jev = (np.concatenate([a, np.full(pad, -1, np.int32)]) for a in (eu, ev))
    want = jtc.tc_kernel(graph_n_vertices=jg.n_vertices,
                         dag_offsets=jnp.asarray(offsets),
                         dag_adj=jnp.asarray(adj), edge_u=jnp.asarray(jeu),
                         edge_v=jnp.asarray(jev), max_dag_degree=D, chunk=chunk)
    got = tc.tc_kernel(graph_n_vertices=tg.n_vertices,
                       dag_offsets=torch.from_numpy(offsets),
                       dag_adj=torch.from_numpy(adj), edge_u=torch.from_numpy(eu),
                       edge_v=torch.from_numpy(ev), max_dag_degree=D, chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) > 0


def test_sortjoin_kernels_match_jax(graphs):
    jg, tg = graphs
    rk = tc.build_dag_ranked(tg)
    wedges = tc.build_wedges_ranked(rk["wadj"], rk["weu"], rk["woff"])
    V = tg.n_vertices
    arrays = (rk["eu"], rk["ev"]) + wedges
    want = np.asarray(jtc.tc_kernel_sortjoin(V, *(jnp.asarray(a) for a in arrays)))
    got = tc.tc_kernel_sortjoin(V, *(torch.from_numpy(a) for a in arrays))
    np.testing.assert_array_equal(got.numpy(), want)
    total = tc.tc_total_sortjoin(*(torch.from_numpy(a) for a in arrays))
    assert int(total) == int(jtc.tc_total_sortjoin(
        *(jnp.asarray(a) for a in arrays))) == int(want.sum()) // 3 > 100


@pytest.mark.parametrize("kw", [
    {}, {"max_wedges": 500}, {"max_wedges": 100_000}, {"method": "probe"},
], ids=["one_sort", "slabs_of_500", "slabs_of_100000", "probe"])
def test_tc_run_matches_jax_and_oracle(graphs, kw):
    jg, tg = graphs
    want = jtc.run(jg, warmup=False)
    got = tc.run(tg, warmup=False, device="cpu", **kw)
    np.testing.assert_array_equal(got.vertex_triangles_count.numpy(),
                                  np.asarray(want.vertex_triangles_count))
    np.testing.assert_array_equal(got.vertex_triangles_count.numpy(),
                                  cpu_reference.tc(tg))
    assert got.n_triangles == want.n_triangles > 100
    assert got.total_triangles_count == 3 * got.n_triangles
    assert got.vertex_triangles_count.dtype == torch.int32


def test_tc_oracle_blocks_and_reference_unittest_graph():
    """The reference's unit-test graph (tc.cuh:50-61): counts {2,1,2,1},
    total 6 for 2 triangles. The oracle in several row blocks equals the
    oracle in one."""
    r = np.int32([0, 0, 0, 1, 1, 2, 2, 2, 3, 3])
    c = np.int32([1, 2, 3, 0, 2, 0, 1, 3, 0, 2])
    g = build_graph(Coo(4, 4, r, c, np.ones(10, np.float32)),
                    GraphProperties(directed=False, symmetric=True),
                    device="cpu")
    for method in ("sortjoin", "probe"):
        res = tc.run(g, method=method, warmup=False, device="cpu")
        assert res.vertex_triangles_count.tolist() == [2, 1, 2, 1]
        assert (res.total_triangles_count, res.n_triangles) == (6, 2)
    assert cpu_reference.tc(g).tolist() == [2, 1, 2, 1]
    off = tc.run(g, reduce_all_triangles=False, warmup=False, device="cpu")
    assert off.total_triangles_count == 0
    tg = _carry(j_rmat_graph(scale=8, edge_factor=8, seed=4))
    np.testing.assert_array_equal(cpu_reference.tc(tg, block_rows=37),
                                  cpu_reference.tc(tg))
    with pytest.raises(ValueError):
        tc.run(g, method="hash", device="cpu")


def test_tc_without_wedges_or_edges():
    path = build_graph(Coo(3, 3, np.int32([0, 1]), np.int32([1, 2]),
                           np.ones(2, np.float32)),
                       GraphProperties(directed=True), device="cpu")
    assert tc.build_dag_ranked(path)["n_wedges"] == 0
    assert tc.run(path, warmup=False, device="cpu").n_triangles == 0
    e = np.zeros(0, np.int32)
    empty = build_graph(Coo(2, 2, e, e, e.astype(np.float32)),
                        GraphProperties(directed=False, symmetric=True),
                        device="cpu")
    res = tc.run(empty, warmup=False, device="cpu")
    assert res.vertex_triangles_count.tolist() == [0, 0]


@pytest.mark.parametrize("extra", [["-r"], ["--reduce", "--reorder", "degree"],
                                   []], ids=["reduce", "degree", "plain"])
def test_tc_cli_validates_on_cpu(extra, capsys):
    argv = ["--market", CHESAPEAKE, "--validate", "--device", "cpu", *extra]
    assert tc_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "tc validation: PASSED" in out
    assert ("distinct triangles = " in out) == bool(extra)


def test_interop_tc_run():
    tg, _ = load_graph_file(CHESAPEAKE, device="cpu")
    res = interop.tc_run(tg, device="cpu")
    np.testing.assert_array_equal(res.vertex_triangles_count.numpy(),
                                  cpu_reference.tc(tg))
