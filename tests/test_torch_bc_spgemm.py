"""Betweenness centrality and SpGEMM of the PyTorch port against the JAX
package, scipy and the CPU oracles, on graphs carried across with
``Graph.from_arrays``; their CLIs and interop wrappers on the CPU.

Tolerances: BC within rtol 1e-4 (atol 1e-4 for values near zero): f32 sums
of positive terms in another order than the JAX package's (whose Pallas
kernels rebuild f32 from a bf16 hi+lo split). SpGEMM structure (nnz, rows,
columns) is exact; values within rtol 1e-4 of the JAX package's and of
scipy's (the per-run sums run in another order)."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gunrock_tpu.algorithms import bc as jbc
from gunrock_tpu.algorithms import spgemm as jspgemm
from gunrock_tpu.io.generators import grid2d_graph as j_grid2d_graph
from gunrock_tpu.io.generators import rmat_graph as j_rmat_graph
from gunrock_tpu.ops.configs import LoadBalance as JLoadBalance
from gunrock_tpu.ops.configs import Options as JOptions

from gunrock_tpu_torch import interop
from gunrock_tpu_torch.algorithms import bc, spgemm
from gunrock_tpu_torch.examples import bc as bc_cli
from gunrock_tpu_torch.examples import cpu_reference
from gunrock_tpu_torch.examples import spgemm as spgemm_cli
from gunrock_tpu_torch.formats import Coo
from gunrock_tpu_torch.graph import Graph, GraphProperties, build_graph
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.io import load_graph_file
from gunrock_tpu_torch.ops.configs import LoadBalance, Options
from gunrock_tpu_torch.ops.kernels.layout import pull_layout, push_layout

CHESAPEAKE = str(Path(__file__).resolve().parent.parent / "datasets" / "chesapeake.mtx")
PATHS = {"kernels": "PALLAS_MERGE_PATH", "plain": "XLA_SEGMENT"}


def _carry(jg):
    return Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")


@pytest.fixture(scope="module")
def graphs():
    """(JAX graph, port graph): directed R-MAT scale 8."""
    jg = j_rmat_graph(scale=8, edge_factor=8, seed=3)
    return jg, _carry(jg)


def _scipy(g):
    h = g.host
    return sp.csr_matrix((h["values"], h["col_indices"], h["row_offsets"]),
                         shape=(g.n_vertices, g.n_vertices))


# -- betweenness centrality --------------------------------------------------

@pytest.mark.parametrize("path", ["kernels", "plain"])
@pytest.mark.parametrize("source", [0, 3])
def test_bc_run_matches_jax_and_oracle(graphs, source, path):
    jg, tg = graphs
    want = jbc.run(jg, source, options=JOptions(
        load_balance=getattr(JLoadBalance, PATHS[path])), warmup=False)
    got = bc.run(tg, source, options=Options(
        load_balance=getattr(LoadBalance, PATHS[path])), warmup=False,
        device="cpu")
    np.testing.assert_allclose(got.bc_values.numpy(),
                               np.asarray(want.bc_values), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.bc_values.numpy(),
                               cpu_reference.bc(tg, source), rtol=1e-4,
                               atol=1e-4)
    assert float(got.bc_values[source]) == 0.0
    assert float(got.bc_values.max()) > 10


def test_bc_forward_and_kernels_match_jax(graphs):
    jg, tg = graphs
    labels, sigma, depth = bc.bc_forward(tg, 5)
    jl, js, jd = jbc.bc_forward(jg, 5)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_allclose(sigma.numpy(), np.asarray(js), rtol=1e-5)
    assert depth == int(jd) > 2
    np.testing.assert_allclose(bc.bc_kernel(tg, 5).numpy(),
                               np.asarray(jbc.bc_kernel(jg, 5)), rtol=1e-4,
                               atol=1e-4)
    lay = pull_layout(tg, unit=True), push_layout(tg, unit=True)
    np.testing.assert_allclose(bc.bc_kernel_pallas(tg, 5, *lay).numpy(),
                               bc.bc_kernel(tg, 5).numpy(), rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError):
        bc.run(tg, tg.n_vertices, device="cpu")


def test_bc_batch_kernel_matches_jax(graphs):
    jg, tg = graphs
    sources = [0, 5, 37, 200, 5]  # a repeated source counts twice
    want = np.asarray(jbc.bc_batch_kernel(jg, jnp.asarray(sources, jnp.int32)))
    got = bc.bc_batch_kernel(tg, sources).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got, sum(cpu_reference.bc(tg, s).astype(np.float64) for s in sources),
        rtol=1e-4, atol=1e-4)


def test_bc_all_sources_match_jax_and_each_other():
    jg = j_rmat_graph(scale=6, edge_factor=6, seed=7, undirected=True)
    tg = _carry(jg)
    want = np.asarray(jbc.run_all_sources(jg, chunk_size=10,
                                          warmup=False).bc_values)
    plain = bc.run_all_sources(tg, chunk_size=10, device="cpu")
    spmm = bc.run_all_sources_spmm(tg, chunk_size=16, device="cpu")
    np.testing.assert_allclose(plain.bc_values.numpy(), want, rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(spmm.bc_values.numpy(), want, rtol=1e-4,
                               atol=1e-3)
    oracle = sum(cpu_reference.bc(tg, s).astype(np.float64)
                 for s in range(tg.n_vertices))
    np.testing.assert_allclose(spmm.bc_values.numpy(), oracle, rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("path", ["kernels", "plain"])
def test_bc_deep_mesh_dynamic_range(path):
    """A 48 x 48 mesh: path counts reach ~2^94, so sigma spans 28 orders of
    magnitude; sums taken within each vertex's own edges hold rtol 1e-4
    where differences of a global prefix are off by orders of magnitude."""
    jg = j_grid2d_graph(48, weighted=True)
    tg = _carry(jg)
    want = cpu_reference.bc(tg, 0)
    got = bc.run(tg, 0, options=Options(
        load_balance=getattr(LoadBalance, PATHS[path])), warmup=False,
        device="cpu").bc_values.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(jbc.run(jg, 0, warmup=False).bc_values), rtol=1e-4,
        atol=1e-4)
    assert float(bc.bc_forward(tg, 0)[1].max()) > 1e25


def test_bc_oracle_is_brandes():
    """The vectorized oracle against the serial Brandes of the JAX
    package's tests, on a graph with unreachable vertices."""
    from gunrock_tpu.examples import cpu_reference as j_cpu_reference

    jg = j_rmat_graph(scale=7, edge_factor=3, seed=11)
    tg = _carry(jg)
    for s in (0, 9):
        np.testing.assert_allclose(cpu_reference.bc(tg, s),
                                   j_cpu_reference.bc(jg, s), rtol=1e-6)


# -- SpGEMM ------------------------------------------------------------------

def _result_csr(res, n):
    k = res.nnz
    return sp.coo_matrix(
        (res.values.numpy()[:k], (res.row_indices.numpy()[:k],
                                  res.col_indices.numpy()[:k])),
        shape=(n, n)).tocsr()


def _assert_same_product(res, want, rtol=1e-4):
    got = _result_csr(res, want.shape[0])
    want = want.tocsr()
    want.sort_indices()
    got.sort_indices()
    assert res.nnz == want.nnz
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=rtol, atol=1e-6)
    rows = res.row_indices.numpy()[: res.nnz]
    assert (np.diff(rows) >= 0).all()  # row-sorted, as to_csr needs


def test_piecewise_expand_matches_jax_and_gathers():
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 6, 40)
    counts[[3, 7, 8, 20]] = 0  # runs of empty segments
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    total = int(off[-1])
    rows = np.sort(rng.integers(0, 30, 40)).astype(np.int32)
    b_start = rng.integers(0, 1000, 40).astype(np.int32)
    a_id = np.searchsorted(off, np.arange(total), side="right") - 1
    i, b_e = spgemm._piecewise_expand(
        torch.from_numpy(rows), torch.from_numpy(b_start),
        torch.from_numpy(off[:-1]), total)
    ji, jb = jspgemm._piecewise_expand(
        jnp.asarray(rows), jnp.asarray(b_start), jnp.asarray(off[:-1]), total)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(b_e.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(i.numpy(), rows[a_id])
    np.testing.assert_array_equal(
        b_e.numpy(), b_start[a_id] + np.arange(total) - off[a_id])


def test_spgemm_kernel_matches_jax(graphs):
    jg, tg = graphs
    deg = np.diff(tg.host["row_offsets"]).astype(np.int64)
    eo = np.zeros(tg.n_edges + 1, np.int64)
    np.cumsum(deg[tg.host["col_indices"]], out=eo[1:])
    total = int(eo[-1])
    want = jspgemm.spgemm_kernel(
        jg.edge_src, jg.col_indices, jg.values, jg.row_offsets,
        jg.col_indices, jg.values, jnp.asarray(eo.astype(np.int32)), total)
    got = spgemm.spgemm_kernel(
        tg.edge_src, tg.col_indices, tg.values, tg.row_offsets,
        tg.col_indices, tg.values, torch.from_numpy(eo), total)
    k = int(want[3])
    assert int(got[3]) == k > 1000 and got[0].shape == (total,)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy()[:k], np.asarray(want[2])[:k],
                               rtol=1e-4)
    assert (got[0].numpy()[k:] == -1).all()


@pytest.mark.parametrize("kw", [
    {"strategy": "esc"}, {"strategy": "esc", "block_products": 500},
    {"strategy": "dense"}, {"strategy": "auto"},
], ids=["esc", "esc_streaming", "dense", "auto"])
def test_spgemm_run_matches_jax_and_scipy(graphs, kw):
    jg, tg = graphs
    A = _scipy(tg)
    want = (A @ A).tocsr()
    res = spgemm.run(tg, tg, warmup=False, device="cpu", **kw)
    _assert_same_product(res, want)
    jres = jspgemm.run(jg, jg, warmup=False, **kw)
    assert res.nnz == jres.nnz
    jk = jres.nnz
    np.testing.assert_array_equal(res.row_indices.numpy()[:jk],
                                  np.asarray(jres.row_indices)[:jk])
    np.testing.assert_array_equal(res.col_indices.numpy()[:jk],
                                  np.asarray(jres.col_indices)[:jk])
    # the JAX dense path rebuilds f32 from a bf16 hi+lo split: rtol 1e-3,
    # its own limit (tests/test_algorithms_wave3.py)
    np.testing.assert_allclose(res.values.numpy()[:jk],
                               np.asarray(jres.values)[:jk],
                               rtol=1e-3 if kw["strategy"] != "esc" else 1e-4)
    cnt = spgemm.run(tg, tg, warmup=False, count_only=True, device="cpu", **kw)
    assert cnt.nnz == want.nnz and cnt.row_indices.numel() == 0
    np.testing.assert_allclose(float(cnt.values[0]), want.data.sum(), rtol=1e-4)
    C = res.to_csr(tg.n_vertices, tg.n_vertices)
    np.testing.assert_array_equal(C.row_offsets, want.indptr)
    assert cpu_reference.spgemm_errors(
        sp.csr_matrix((C.values, C.col_indices, C.row_offsets),
                      shape=want.shape), cpu_reference.spgemm(tg, tg)) == 0


def test_spgemm_two_matrices_and_mismatch():
    ja = j_rmat_graph(scale=7, edge_factor=5, seed=31)
    jb = j_rmat_graph(scale=7, edge_factor=7, seed=32)
    ta, tb = _carry(ja), _carry(jb)
    want = _scipy(ta) @ _scipy(tb)
    for strategy in ("esc", "dense"):
        _assert_same_product(
            spgemm.run(ta, tb, strategy=strategy, warmup=False, device="cpu"),
            want)
    small = _carry(j_rmat_graph(scale=5, edge_factor=4, seed=1))
    with pytest.raises(ValueError):
        spgemm.run(ta, small, device="cpu")
    with pytest.raises(ValueError):
        spgemm.run(ta, tb, strategy="hash", device="cpu")


def test_spgemm_streaming_oversized_row():
    """A hub row whose expansion alone exceeds the budget gets its own
    block and still contracts exactly."""
    n = 64
    rng = np.random.default_rng(7)
    rows = np.concatenate([np.zeros(n, np.int32),
                           rng.integers(1, n, 60).astype(np.int32)])
    cols = np.concatenate([np.arange(n, dtype=np.int32),
                           rng.integers(0, n, 60).astype(np.int32)])
    key = np.unique(rows.astype(np.int64) * n + cols)
    g = build_graph(
        Coo(n, n, (key // n).astype(np.int32), (key % n).astype(np.int32),
            rng.random(key.size).astype(np.float32)),
        GraphProperties(directed=True, weighted=True), device="cpu")
    A = _scipy(g)
    deg = np.diff(g.host["row_offsets"]).astype(np.int64)
    exp_row = np.concatenate([[0], np.cumsum(
        np.add.reduceat(deg[g.host["col_indices"]],
                        g.host["row_offsets"][:-1].astype(np.int64)))])
    blocks = spgemm._plan_blocks(exp_row, 100)
    assert blocks[0] == (0, 1) and exp_row[1] > 100
    assert blocks == jspgemm._plan_blocks(exp_row, 100)
    res = spgemm.run(g, g, strategy="esc", block_products=100, warmup=False,
                     device="cpu")
    _assert_same_product(res, A @ A)
    cnt = spgemm.run(g, g, strategy="esc", block_products=100,
                     count_only=True, device="cpu")
    assert cnt.nnz == (A @ A).nnz


def test_spgemm_auto_strategy_follows_the_env_knob(graphs, monkeypatch):
    _, tg = graphs
    want = (_scipy(tg) @ _scipy(tg)).nnz
    called = []
    dense = spgemm._run_dense
    monkeypatch.setattr(spgemm, "_run_dense",
                        lambda *a, **k: (called.append(1), dense(*a, **k))[1])
    monkeypatch.setenv("GUNROCK_SPGEMM_AUTO_K", "1e-9")  # everything dense
    assert spgemm.pick_strategy(tg, tg) == "dense"
    assert spgemm.run(tg, tg, count_only=True, device="cpu").nnz == want
    assert called == [1]
    monkeypatch.setenv("GUNROCK_SPGEMM_AUTO_K", "1e9")  # everything esc
    assert spgemm.pick_strategy(tg, tg) == "esc"
    assert spgemm.run(tg, tg, count_only=True, device="cpu").nnz == want
    assert called == [1]
    assert spgemm.product_count(tg, tg) == int(
        np.diff(tg.host["row_offsets"])[tg.host["col_indices"]].sum())


def test_spgemm_empty_product():
    e = np.zeros(0, np.int32)
    g = build_graph(Coo(3, 3, e, e, e.astype(np.float32)),
                    GraphProperties(directed=True), device="cpu")
    for strategy in ("esc", "dense"):
        res = spgemm.run(g, g, strategy=strategy, device="cpu")
        assert res.nnz == 0 and res.to_csr(3, 3).row_offsets.tolist() == [0] * 4


# -- CLIs and interop --------------------------------------------------------

@pytest.mark.parametrize("cli,extra", [
    (bc_cli, ["--src", "0"]),
    (bc_cli, ["--src", "3", "--reorder", "degree"]),
    (bc_cli, ["--all_sources"]),
    (bc_cli, ["--all_sources", "--advance_load_balance", "xla_segment"]),
    (spgemm_cli, ["--strategy", "esc"]),
    (spgemm_cli, ["--strategy", "dense"]),
    (spgemm_cli, ["--strategy", "auto", "--market_b", CHESAPEAKE]),
], ids=["bc", "bc_degree", "bc_all_sources", "bc_all_sources_plain",
        "spgemm_esc", "spgemm_dense", "spgemm_auto_b"])
def test_cli_validates_on_cpu(cli, extra, capsys):
    argv = ["--market", CHESAPEAKE, "--validate", "--device", "cpu", *extra]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "validation: PASSED" in out and "FAILED" not in out


@pytest.mark.parametrize("cli", [bc_cli, spgemm_cli])
def test_cli_devices_flag_still_exits(cli, capsys):
    """--devices 4 runs the CLI's sharded branch in four CPU ranks and
    exits 0 after its validation (it exited with a parser error before the
    distributed layer was ported)."""
    extra = ["--src", "3"] if cli is bc_cli else []
    assert cli.main(["--market", CHESAPEAKE, "--device", "cpu", "--devices",
                     "4", "--validate", *extra]) == 0
    out = capsys.readouterr().out
    assert "distributed: 4 ranks" in out
    assert "validation: PASSED" in out and "FAILED" not in out


def test_interop_runs():
    tg, _ = load_graph_file(CHESAPEAKE, device="cpu")
    res = interop.bc_run(tg, 0, device="cpu")
    np.testing.assert_allclose(res.bc_values.numpy(), cpu_reference.bc(tg, 0),
                               rtol=1e-4, atol=1e-4)
    res = interop.spgemm_run(tg, tg, device="cpu")
    assert res.nnz == (_scipy(tg) @ _scipy(tg)).nnz
