"""k-core and personalized PageRank of the PyTorch port against the JAX
package and the CPU oracles, on a degree-sorted R-MAT graph with self
loops carried across with ``Graph.from_arrays``; ``ops/sort.py`` against
``gunrock_tpu.ops.sort``; the four CLIs of this slice and its interop
wrappers on the CPU.

k-core is integer arithmetic: core numbers, degeneracy and round counts
are equal. PPR sums f32 residuals in another order than the JAX package
(its Pallas kernel rebuilds f32 from a bf16 hi+lo split): p within rtol
1e-4 (atol 1e-7 for entries near zero), iteration counts equal."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrock_tpu.algorithms import kcore as jkcore
from gunrock_tpu.algorithms import ppr as jppr
from gunrock_tpu.formats import Coo as JCoo
from gunrock_tpu.graph import build_graph as j_build_graph
from gunrock_tpu.graph.properties import GraphProperties as JGraphProperties
from gunrock_tpu.io.generators import rmat_coo as j_rmat_coo
from gunrock_tpu.ops import sort as jsort
from gunrock_tpu.ops.configs import LoadBalance as JLoadBalance
from gunrock_tpu.ops.configs import Options as JOptions

from gunrock_tpu_torch import interop
from gunrock_tpu_torch.algorithms import kcore, ppr
from gunrock_tpu_torch.examples import color as color_cli
from gunrock_tpu_torch.examples import cpu_reference
from gunrock_tpu_torch.examples import kcore as kcore_cli
from gunrock_tpu_torch.examples import mst as mst_cli
from gunrock_tpu_torch.examples import ppr as ppr_cli
from gunrock_tpu_torch.graph import Graph, GraphProperties
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.io import load_graph_file
from gunrock_tpu_torch.ops import sort
from gunrock_tpu_torch.ops.configs import LoadBalance, Options

CHESAPEAKE = str(Path(__file__).resolve().parent.parent / "datasets" / "chesapeake.mtx")
PATHS = {"kernels": "PALLAS_MERGE_PATH", "plain": "XLA_SEGMENT"}


def _options(path):
    name = PATHS[path]
    return (JOptions(load_balance=getattr(JLoadBalance, name)),
            Options(load_balance=getattr(LoadBalance, name)))


@pytest.fixture(scope="module")
def graphs():
    """(JAX graph, port graph): R-MAT scale 8 (directed, skewed) plus 12
    self loops."""
    coo = j_rmat_coo(8, 8, seed=2)
    V = coo.n_rows
    loops = np.arange(0, 120, 10, dtype=np.int32)
    rows = np.concatenate([coo.row_indices, loops]).astype(np.int32)
    cols = np.concatenate([coo.col_indices, loops]).astype(np.int32)
    key = np.unique(rows.astype(np.int64) * V + cols)
    jg = j_build_graph(
        JCoo(n_rows=V, n_cols=V, row_indices=(key // V).astype(np.int32),
             col_indices=(key % V).astype(np.int32),
             values=np.ones(key.size, np.float32)),
        JGraphProperties())
    tg = Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, V,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")
    assert (tg.host["edge_src"] == tg.host["col_indices"]).sum() >= 12
    return jg, tg


# -- k-core -----------------------------------------------------------------

@pytest.mark.parametrize("path", ["kernels", "plain"])
def test_kcore_matches_jax_and_oracle(graphs, path):
    jg, tg = graphs
    jopt, topt = _options(path)
    want = jkcore.run(jg, options=jopt, warmup=False)
    got = kcore.run(tg, options=topt, device="cpu")
    np.testing.assert_array_equal(got.k_cores.numpy(), np.asarray(want.k_cores))
    np.testing.assert_array_equal(got.k_cores.numpy(), cpu_reference.kcore(tg))
    assert got.degeneracy == want.degeneracy == int(got.k_cores.max()) > 2
    assert got.rounds == want.rounds > got.degeneracy


def test_kcore_kernel_and_self_loops(graphs):
    """kcore_kernel with the kernel decrement equals the enactor's run, and
    a self loop does not count towards a core number."""
    from gunrock_tpu_torch.formats import Coo
    from gunrock_tpu_torch.graph import build_graph
    from gunrock_tpu_torch.ops.kernels.layout import pull_layout

    _, tg = graphs
    cores, degeneracy, rounds = kcore.kcore_kernel(
        tg, kcore.kernel_decrement, pull_layout(tg, unit=True))
    res = kcore.run(tg, device="cpu")
    assert torch.equal(cores, res.k_cores)
    assert (int(degeneracy), rounds) == (res.degeneracy, res.rounds)
    # a triangle with a self loop on vertex 0, and an isolated vertex
    r = np.int32([0, 0, 1, 1, 2, 2, 0])
    c = np.int32([1, 2, 0, 2, 0, 1, 0])
    g = build_graph(Coo(4, 4, r, c, np.ones(7, np.float32)), device="cpu")
    for opt in _options("kernels")[1], _options("plain")[1]:
        assert kcore.run(g, options=opt, device="cpu").k_cores.tolist() == [
            2, 2, 2, 1]
    assert cpu_reference.kcore(g).tolist() == [2, 2, 2, 1]


# -- personalized PageRank --------------------------------------------------

@pytest.mark.parametrize("path", ["kernels", "plain"])
@pytest.mark.parametrize("seed", [0, 37])
def test_ppr_matches_jax_and_oracle(graphs, seed, path):
    jg, tg = graphs
    jopt, topt = _options(path)
    want = jppr.run(jg, seed, options=jopt, warmup=False)
    got = ppr.run(tg, seed, options=topt, device="cpu")
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=1e-4,
                               atol=1e-7)
    assert got.iterations == want.iterations > 3
    np.testing.assert_allclose(got.p.numpy(), cpu_reference.ppr(tg, seed),
                               rtol=1e-4, atol=1e-7)
    assert 0.5 < float(got.p.sum()) <= 1.0 + 1e-5


@pytest.mark.parametrize("use_spmm", [True, False])
def test_ppr_run_batch_matches_jax(graphs, use_spmm):
    jg, tg = graphs
    seeds = [0, 5, 37, 200]
    want, _ = jppr.run_batch(jg, seeds, warmup=False, use_spmm=use_spmm)
    got, ms = ppr.run_batch(tg, seeds, use_spmm=use_spmm, device="cpu")
    assert got.shape == (len(seeds), tg.n_vertices) and ms >= 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-7)
    for k, s in enumerate(seeds):
        np.testing.assert_allclose(got[k].numpy(), cpu_reference.ppr(tg, s),
                                   rtol=1e-4, atol=1e-7)


def test_ppr_run_batch_default_follows_the_device(graphs, monkeypatch):
    """use_spmm=None: false on the CPU (the seeds run one after another)."""
    _, tg = graphs
    monkeypatch.setattr(ppr, "ppr_batch_kernel_spmm", None)  # must not run
    got, _ = ppr.run_batch(tg, [0, 5], device="cpu")
    assert got.shape == (2, tg.n_vertices)
    with pytest.raises(ValueError):
        ppr.run(tg, tg.n_vertices, device="cpu")


# -- ops/sort.py ------------------------------------------------------------

def test_sort_matches_jax():
    rng = np.random.default_rng(0)
    k0 = rng.integers(0, 5, 300).astype(np.int32)
    k1 = rng.integers(0, 7, 300).astype(np.int32)
    v = np.arange(300, dtype=np.int32)
    t = [torch.from_numpy(a) for a in (k0, k1, v)]
    j = [jnp.asarray(a) for a in (k0, k1, v)]
    for num_keys in (1, 2):
        want = jsort.lex_sort(tuple(j), num_keys=num_keys)
        got = sort.lex_sort(tuple(t), num_keys=num_keys)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        want = jsort.stable_sort_by(*j, num_keys=num_keys)
        got = sort.stable_sort_by(*t, num_keys=num_keys)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_lex_sort_two_pass_matches_jax():
    """JAX's ``two_pass=True`` (its SpGEMM's lowering: two stable one-key
    sorts) on keys with ties in both keys; the port takes the argument
    and gives the same order."""
    rng = np.random.default_rng(3)
    k0 = rng.integers(0, 3, 400).astype(np.int32)
    k1 = rng.integers(0, 4, 400).astype(np.int32)
    v = rng.permutation(400).astype(np.int32)
    j = tuple(jnp.asarray(a) for a in (k0, k1, v))
    t = tuple(torch.from_numpy(a) for a in (k0, k1, v))
    for two_pass in (True, False, None):
        want = jsort.lex_sort(j, num_keys=2, two_pass=True)
        got = sort.lex_sort(t, 2, two_pass)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- CLIs and interop -------------------------------------------------------

@pytest.mark.parametrize("cli,extra", [
    (color_cli, []),
    (color_cli, ["--strategy", "luby", "--reorder", "degree"]),
    (color_cli, ["--strategy", "rank"]),
    (mst_cli, []),
    (mst_cli, ["--strategy", "contract"]),
    (kcore_cli, ["--reorder", "degree"]),
    (ppr_cli, ["--src", "0"]),
    (ppr_cli, ["--src", "3", "--reorder", "degree"]),
    (ppr_cli, ["--src", "0,3,5", "--reorder", "degree"]),
], ids=["color", "color_luby_degree", "color_rank", "mst", "mst_contract",
        "kcore_degree", "ppr", "ppr_degree", "ppr_batch_degree"])
def test_cli_validates_on_cpu(cli, extra, capsys):
    argv = ["--market", CHESAPEAKE, "--validate", "--device", "cpu", *extra]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "validation: PASSED" in out and "FAILED" not in out


def test_ppr_cli_runs_a_batch(capsys):
    argv = ["--market", CHESAPEAKE, "--device", "cpu", "--src", "0,3,5"]
    assert ppr_cli.main(argv) == 0
    assert "p[seed=0]" in capsys.readouterr().out


def test_interop_runs():
    tg, _ = load_graph_file(CHESAPEAKE, device="cpu")
    res = interop.color_run(tg, strategy="luby", device="cpu")
    assert cpu_reference.color_is_valid(tg, res.colors.numpy())
    res = interop.mst_run(tg, device="cpu")
    np.testing.assert_allclose(res.mst_weight, cpu_reference.mst_weight(tg),
                               rtol=1e-5)
    res = interop.kcore_run(tg, device="cpu")
    np.testing.assert_array_equal(res.k_cores.numpy(), cpu_reference.kcore(tg))
    res = interop.ppr_run(tg, 0, device="cpu")
    np.testing.assert_allclose(res.p.numpy(), cpu_reference.ppr(tg, 0),
                               rtol=1e-4, atol=1e-7)
