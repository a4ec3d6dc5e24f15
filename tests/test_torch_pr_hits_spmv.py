"""PageRank, HITS and SpMV of the PyTorch port against the JAX package
(Pallas in interpret mode) and the CPU oracles, plus the semiring family's
CLIs and interop fills, all on the CPU.

Tolerances: rtol 1e-4 against the JAX Pallas kernels, which rebuild f32
from a bf16 hi+lo split (``semiring.py:321-324``); for the same reason a
power iteration may stop one iteration apart near ``tol``, which the
PageRank tests allow. rtol 1e-5 against the plain-tensor JAX paths and
float64 oracles where both sum in f32 over a few terms."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrock_tpu.algorithms import hits as jhits
from gunrock_tpu.algorithms import pr as jpr
from gunrock_tpu.algorithms import spmv as jspmv
from gunrock_tpu.graph.reorder import degree_sort as j_degree_sort
from gunrock_tpu.io.generators import rmat_graph as j_rmat_graph
from gunrock_tpu.io.loader import load_graph_file as j_load_graph_file
from gunrock_tpu.ops.configs import Options as JOptions
from gunrock_tpu.ops.pallas.layout import build_auto_layout as j_build_auto_layout
from gunrock_tpu.ops.pallas.semiring import pull_layout as j_pull_layout
from gunrock_tpu.ops.pallas.semiring import push_layout as j_push_layout

from gunrock_tpu_torch import interop
from gunrock_tpu_torch.algorithms import hits, pr, spmv
from gunrock_tpu_torch.examples import cpu_reference
from gunrock_tpu_torch.examples import hits as hits_cli
from gunrock_tpu_torch.examples import pr as pr_cli
from gunrock_tpu_torch.examples import spmv as spmv_cli
from gunrock_tpu_torch.examples import sssp as sssp_cli
from gunrock_tpu_torch.formats import Coo
from gunrock_tpu_torch.graph import Graph, GraphProperties, build_graph
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.io.loader import load_graph_file
from gunrock_tpu_torch.ops.configs import Options
from gunrock_tpu_torch.ops.kernels.layout import (
    DATA_FIELDS,
    META_FIELDS,
    BucketedEdges,
)

CHESAPEAKE = str(Path(__file__).resolve().parent.parent / "datasets" / "chesapeake.mtx")
W = C = 128


def carry_graph(jg) -> Graph:
    return Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")


def carry_layout(jl) -> BucketedEdges:
    return BucketedEdges.from_arrays(
        {k: np.asarray(getattr(jl, k)) for k in DATA_FIELDS},
        **{k: getattr(jl, k) for k in META_FIELDS}, device="cpu")


@pytest.fixture(scope="module")
def graphs():
    """(JAX graph, port graph): R-MAT scale 9, degree-sorted, weighted,
    directed, with dangling vertices."""
    jg, _ = j_degree_sort(j_rmat_graph(scale=9, seed=2))
    tg = carry_graph(jg)
    assert (np.diff(tg.host["row_offsets"]) == 0).any()  # dangling mass
    return jg, tg


# -- PageRank ---------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["pr_kernel_pallas", "pr_kernel"])
def test_pr_kernels_match_jax(graphs, kernel):
    """B3 as plus_times over the valued pull layout, and the plain power
    iteration."""
    jg, tg = graphs
    if kernel == "pr_kernel":
        p_j, it_j = jpr.pr_kernel(jg, 0.85, 1e-6)
        p_t, it_t = pr.pr_kernel(tg, 0.85, 1e-6)
    else:
        jl = j_pull_layout(jg, window=W, chunk=C)
        p_j, it_j = jpr.pr_kernel_pallas(jg, 0.85, 1e-6, layout=jl,
                                         interpret=True)
        p_t, it_t = pr.pr_kernel_pallas(tg, 0.85, 1e-6,
                                        layout=carry_layout(jl))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-4,
                               atol=1e-7)
    assert abs(it_t - int(it_j)) <= 1


@pytest.mark.parametrize("options", [None, Options()], ids=["kernels", "enactor"])
def test_pr_run_matches_jax_and_oracle(graphs, options):
    jg, tg = graphs
    got = pr.run(tg, alpha=0.85, tol=1e-6, options=options, device="cpu")
    want = jpr.run(jg, alpha=0.85, tol=1e-6, options=JOptions())
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=1e-4,
                               atol=1e-7)
    assert abs(got.iterations - want.iterations) <= 1
    np.testing.assert_allclose(got.p.numpy(), cpu_reference.pr(tg), atol=1e-5)


def test_pr_batch_matches_jax(graphs):
    """run_batch over the SpMM (valued pull layout) against the JAX SpMM
    sweep, and each column against a single run at its alpha."""
    jg, tg = graphs
    alphas = (0.75, 0.85, 0.9)
    h = tg.host
    jl = j_build_auto_layout(h["col_indices"], h["edge_src"], h["values"],
                             tg.n_vertices, interpret=True)
    p_j, it_j = jpr.pr_batch_kernel_spmm(
        jg, jnp.asarray(alphas, jnp.float32), 1e-6, layout=jl, interpret=True)
    got = pr.run_batch(tg, alphas, tol=1e-6, device="cpu")
    np.testing.assert_allclose(got.p.numpy(), np.asarray(p_j), rtol=1e-4,
                               atol=1e-7)
    assert abs(got.iterations - int(it_j)) <= 1
    # the plain path's prefix-sum difference carries ulp(total) ~ 1e-7
    # absolute error per entry (ops/segment.py)
    p_x, _ = pr.pr_batch_kernel_xla(tg, alphas, 1e-6)
    np.testing.assert_allclose(p_x.numpy(), got.p.numpy(), atol=1e-6)
    for k, a in enumerate(alphas):
        single = pr.run(tg, alpha=a, tol=1e-6, device="cpu")
        np.testing.assert_allclose(got.p[:, k].numpy(), single.p.numpy(),
                                   atol=1e-5)


def test_pr_batch_stall_rule_stops(graphs):
    """A tol below the f32 floor stops by the stall rule, not at
    max_iterations."""
    _, tg = graphs
    p, it = pr.pr_batch_kernel_spmm(tg, (0.85,), tol=0.0,
                                    max_iterations=10_000)
    assert it < 10_000 and torch.isfinite(p).all()


# -- HITS -------------------------------------------------------------------

def test_hits_fused_run_matches_jax_and_oracle(graphs):
    """Directed graph: run() takes the fused sweep (B8); held against the
    JAX fused Pallas path (rtol 1e-4) and the float64 oracle."""
    jg, tg = graphs
    jpush = j_push_layout(jg, window=W, chunk=C, unit=True)
    a_j, h_j, it_j = jhits.hits_kernel_pallas(
        jg, 20, push_layout=jpush, pull_layout=jpush, interpret=True)
    got = hits.run(tg, max_iterations=20, device="cpu")
    np.testing.assert_allclose(got.auth.numpy(), np.asarray(a_j), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got.hub.numpy(), np.asarray(h_j), rtol=1e-4,
                               atol=1e-6)
    # the stop is an EXACT fixpoint, which rounding decides: the JAX
    # kernel's bf16 hi+lo rebuild may reach it an iteration earlier
    assert abs(got.iterations - int(it_j)) <= 1
    ref_a, ref_h = cpu_reference.hits(tg, got.iterations)
    np.testing.assert_allclose(got.auth.numpy(), ref_a, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.hub.numpy(), ref_h, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["symmetric", "xla"])
def test_hits_symmetric_and_xla_match_jax(mode):
    """Chesapeake is symmetric: the default options take one dense pass
    per iteration; Options() takes the plain segment sums."""
    jg, _ = j_load_graph_file(CHESAPEAKE)
    tg, _ = load_graph_file(CHESAPEAKE, device="cpu")
    assert tg.properties.symmetric
    options = None if mode == "symmetric" else Options()
    got = hits.run(tg, max_iterations=20, options=options, device="cpu")
    if mode == "symmetric":
        jl = j_pull_layout(jg, window=W, chunk=C, unit=True)
        a_j, h_j, it_j = jhits.hits_kernel_pallas(
            jg, 20, push_layout=jl, pull_layout=jl, interpret=True,
            symmetric=True)
    else:
        a_j, h_j, it_j = jhits.hits_kernel(jg, 20)
    np.testing.assert_allclose(got.auth.numpy(), np.asarray(a_j), rtol=1e-4)
    np.testing.assert_allclose(got.hub.numpy(), np.asarray(h_j), rtol=1e-4)
    assert abs(got.iterations - int(it_j)) <= 1
    ref_a, _ = cpu_reference.hits(tg, got.iterations)
    np.testing.assert_allclose(got.auth.numpy(), ref_a, rtol=1e-4, atol=1e-6)


def test_hits_stops_at_exact_fixpoint():
    """One edge 0 -> 1: auth = e1 and hub = e0 after one iteration, the
    same after the second, which ends the loop (as in the JAX package);
    an all-zero vector stays as it is under the normalization."""
    g = build_graph(Coo(3, 3, np.int32([0]), np.int32([1]), np.float32([1])),
                    device="cpu")
    for options in (None, Options()):
        got = hits.run(g, max_iterations=50, options=options, device="cpu")
        assert got.iterations == 2
        assert got.auth.tolist() == [0.0, 1.0, 0.0]
        assert got.hub.tolist() == [1.0, 0.0, 0.0]
    assert hits._l2_normalize(torch.zeros(4)).tolist() == [0.0] * 4


# -- SpMV -------------------------------------------------------------------

@pytest.mark.parametrize("options", [None, Options()], ids=["kernel", "plain"])
def test_spmv_run_matches_jax_and_scipy(graphs, options):
    jg, tg = graphs
    x = np.random.default_rng(3).random(tg.n_vertices).astype(np.float32)
    got = spmv.run(tg, x, options=options, device="cpu").y.numpy()
    want = np.asarray(jspmv.run(jg, x, options=JOptions()).y)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, cpu_reference.spmv(tg, x), rtol=1e-5,
                               atol=1e-6)
    pull = spmv.spmv_pull_kernel(tg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(pull, np.asarray(jspmv.spmv_pull_kernel(
        jg, jnp.asarray(x))), rtol=1e-5, atol=1e-6)


def test_spmv_edgeless_and_spmm(graphs):
    _, tg = graphs
    from gunrock_tpu_torch.ops.kernels.spmv import spmv as kspmv

    e = build_graph(Coo(4, 4, np.int32([]), np.int32([]), np.float32([])),
                    device="cpu")
    assert kspmv(e, torch.ones(4)).tolist() == [0.0] * 4
    X = np.random.default_rng(4).random((tg.n_vertices, 3)).astype(np.float32)
    Y = spmv.spmm_kernel(tg, X).numpy()
    for k in range(3):
        np.testing.assert_allclose(Y[:, k], cpu_reference.spmv(tg, X[:, k]),
                                   rtol=1e-5, atol=1e-6)


def test_dense_layouts_only_for_pr_and_hits(graphs, monkeypatch):
    """PageRank and HITS take the ``dense_window_chunk`` layout; SSSP and
    SpMV keep W=2048/C=256."""
    from gunrock_tpu_torch.algorithms import sssp

    _, tg = graphs
    tg = carry_graph(graphs[0])  # a fresh layout cache
    monkeypatch.setattr(pr, "dense_window_chunk", lambda n: (W, C))
    monkeypatch.setattr(hits, "dense_window_chunk", lambda n: (W, C))
    pr.run(tg, device="cpu")
    hits.run(tg, max_iterations=2, device="cpu")
    sssp.run(tg, 0, device="cpu")
    spmv.run(tg, np.ones(tg.n_vertices, np.float32), device="cpu")
    keys = {(kind, w, c, unit) for kind, w, c, _, unit in tg.layouts}
    assert keys == {("pull", W, C, False), ("push", W, C, True),
                    ("pull", 2048, 256, False), ("push", 2048, 256, False)}


# -- CLIs and interop -------------------------------------------------------

@pytest.mark.parametrize("cli,extra", [
    (sssp_cli, ["--src", "0"]),
    (sssp_cli, ["--src", "3", "--reorder", "degree"]),
    (pr_cli, []),
    (pr_cli, ["--alphas", "0.8,0.85"]),
    (hits_cli, []),
    (spmv_cli, ["--reorder", "degree"]),
], ids=["sssp", "sssp_degree", "pr", "pr_batch", "hits", "spmv_degree"])
def test_cli_validates_on_cpu(cli, extra, capsys):
    argv = ["--market", CHESAPEAKE, "--validate", "--device", "cpu", *extra]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "validation: PASSED" in out and "FAILED" not in out


def test_cli_unported_paths_exit_with_an_error(capsys):
    """--mode async and --devices, once unported, both run now
    (tests/test_torch_async_sweep.py, tests/test_torch_parallel.py); the
    two together exit with the JAX CLI's error."""
    argv = ["--market", CHESAPEAKE, "--device", "cpu", "--src", "0"]
    assert sssp_cli.main(argv + ["--mode", "async", "--validate"]) == 0
    assert "not ported" not in capsys.readouterr().out
    assert sssp_cli.main(argv + ["--devices", "4", "--mode", "async"]) == 1
    assert "--mode async is single-chip" in capsys.readouterr().out


def test_interop_fills_and_runs():
    tg, _ = load_graph_file(CHESAPEAKE, device="cpu")
    V = tg.n_vertices
    dist = torch.zeros(V, dtype=torch.float64)
    pred = np.zeros(V, np.int32)
    ms = interop.sssp(tg, 0, dist, pred, device="cpu")
    assert ms >= 0.0
    np.testing.assert_allclose(dist.numpy(), cpu_reference.sssp(tg, 0),
                               rtol=1e-6)
    assert pred[0] == -1 and (pred[1:] >= 0).all()
    assert interop.sssp_run(tg, 0, device="cpu").search_depth > 0
    batch = interop.pr_run(tg, alphas=[0.8, 0.85], device="cpu")
    single = interop.pr_run(tg, alpha=0.85, device="cpu")
    np.testing.assert_allclose(batch.p[:, 1].numpy(), single.p.numpy(),
                               atol=1e-6)
    res = interop.hits_run(tg, max_iterations=5, device="cpu")
    assert res.iterations <= 5
    x = np.ones(V, np.float32)
    np.testing.assert_allclose(interop.spmv_run(tg, x, device="cpu").y.numpy(),
                               cpu_reference.spmv(tg, x), rtol=1e-6)
