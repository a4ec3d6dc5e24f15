"""BFS of the PyTorch port against the JAX package, on a degree-sorted
R-MAT graph carried across with ``Graph.from_arrays`` and a unit pull
layout carried across with ``BucketedEdges.from_arrays``. Distances,
depths and predecessors are integers: every comparison is exact."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrock_tpu import interop as j_interop
from gunrock_tpu.algorithms import bfs as jbfs
from gunrock_tpu.graph.reorder import degree_sort as j_degree_sort
from gunrock_tpu.io.generators import rmat_graph as j_rmat_graph
from gunrock_tpu.io.loader import load_graph_file as j_load_graph_file
from gunrock_tpu.ops.pallas.semiring import pull_layout as j_pull_layout

from gunrock_tpu_torch import interop
from gunrock_tpu_torch.algorithms import bfs
from gunrock_tpu_torch.examples import bfs as bfs_cli
from gunrock_tpu_torch.examples import cpu_reference
from gunrock_tpu_torch.graph import Graph, GraphProperties
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.io.loader import load_graph_file
from gunrock_tpu_torch.ops.configs import Options
from gunrock_tpu_torch.ops.kernels.layout import (
    DATA_FIELDS,
    META_FIELDS,
    BucketedEdges,
)

CHESAPEAKE = str(Path(__file__).resolve().parent.parent / "datasets" / "chesapeake.mtx")


@pytest.fixture(scope="module")
def graphs():
    """(JAX graph, port graph, JAX layout, port layout): R-MAT scale 9,
    degree-sorted, unit pull layout at W=128/C=128."""
    jg, _ = j_degree_sort(j_rmat_graph(scale=9, seed=1))
    tg = Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")
    jl = j_pull_layout(jg, window=128, chunk=128, unit=True)
    return jg, tg, jl, _to_torch_layout(jl)


def _to_torch_layout(jl):
    return BucketedEdges.from_arrays(
        {k: np.asarray(getattr(jl, k)) for k in DATA_FIELDS},
        **{k: getattr(jl, k) for k in META_FIELDS}, device="cpu")


@pytest.mark.parametrize("mode", ["all_pull", "all_push", "mixed",
                                  "mixed_dense"])
def test_bfs_kernel_do_matches_jax(graphs, mode, monkeypatch):
    """``mixed_dense`` also passes ``layout_dense`` (W=256/C=256), which
    takes the levels whose frontier covers half the edges."""
    jg, tg, jl, tl = graphs
    budget = {"all_pull": 1, "all_push": tg.n_edges + tg.n_vertices + 1,
              "mixed": tg.n_edges // 40, "mixed_dense": tg.n_edges // 40}[mode]
    jl_dense = tl_dense = None
    if mode == "mixed_dense":
        jl_dense = j_pull_layout(jg, window=256, chunk=256, unit=True)
        tl_dense = _to_torch_layout(jl_dense)
    taken = []
    push, pull = bfs.bfs_push_step, bfs._pull
    monkeypatch.setattr(bfs, "bfs_push_step",
                        lambda *a: taken.append("push") or push(*a))
    monkeypatch.setattr(bfs, "_pull", lambda lay, *a: taken.append(
        "pull" if lay is tl else "pull_dense") or pull(lay, *a))
    for src in (0, 100, 511):
        d_j, it_j = jbfs.bfs_kernel_do(jg, src, edge_budget=budget, layout=jl,
                                       interpret=True, layout_dense=jl_dense)
        d_t, it_t = bfs.bfs_kernel_do(tg, src, edge_budget=budget, layout=tl,
                                      layout_dense=tl_dense)
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        assert it_t == int(it_j)
    # budget 1 never pushes: that needs a frontier of size < 1
    assert set(taken) == {"all_pull": {"pull"}, "all_push": {"push"},
                          "mixed": {"pull", "push"},
                          "mixed_dense": {"pull", "push", "pull_dense"}}[mode]


@pytest.mark.parametrize("max_iterations", [None, 2])
def test_bfs_kernel_without_predecessors_matches_jax(graphs, max_iterations):
    """``bfs_kernel(..., compute_predecessors=False)`` gives (dist, None,
    depth) in both packages, equal to the run with predecessors."""
    jg, tg, _, _ = graphs
    src = int(np.argmax(np.diff(tg.host["row_offsets"])))
    jd, jp, jdepth = jbfs.bfs_kernel(jg, src, max_iterations, False)
    td, tp, tdepth = bfs.bfs_kernel(tg, src, max_iterations, False)
    assert jp is None and tp is None
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tdepth == int(jdepth)
    full = bfs.bfs_kernel(tg, src, max_iterations,
                          compute_predecessors=True)
    np.testing.assert_array_equal(full[0].numpy(), td.numpy())
    assert full[1] is not None and full[2] == tdepth


def test_msbfs_matches_jax(graphs):
    jg, tg, jl, tl = graphs
    sources = np.array([0, 1, 77, 300], np.int32)
    d_j, it_j = jbfs.msbfs_kernel(jg, jnp.asarray(sources), pull_layout=jl,
                                  interpret=True)
    d_t, it_t = bfs.msbfs_kernel(tg, sources, pull_layout=tl)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert it_t == int(it_j)


@pytest.mark.parametrize("options", [None, Options()], ids=["do", "forward"])
def test_run_matches_jax(graphs, options):
    jg, tg, _, _ = graphs
    for src in (0, 42):
        want = jbfs.run(jg, src)
        got = bfs.run(tg, src, options=options, device="cpu")
        np.testing.assert_array_equal(got.distances.numpy(),
                                      np.asarray(want.distances))
        np.testing.assert_array_equal(got.predecessors.numpy(),
                                      np.asarray(want.predecessors))
        assert got.search_depth == want.search_depth


def test_run_rejects_out_of_range_source(graphs):
    _, tg, _, _ = graphs
    with pytest.raises(ValueError, match="out of range"):
        bfs.run(tg, tg.n_vertices, device="cpu")


def test_push_step_matches_cpu_oracle(graphs):
    """One push from a small frontier reaches exactly the unvisited
    out-neighbours, marking each once."""
    _, tg, _, _ = graphs
    dist = torch.full((tg.n_vertices,), bfs.UNREACHED, dtype=torch.int32)
    dist[:3] = 0
    front = torch.zeros(tg.n_vertices, dtype=torch.bool)
    front[:3] = True
    new, dist = bfs.bfs_push_step(tg, front, dist, 0, 0)
    offs, cols = tg.host["row_offsets"], tg.host["col_indices"]
    nbrs = set(cols[offs[0]:offs[3]].tolist()) - {0, 1, 2}
    assert set(torch.nonzero(new).flatten().tolist()) == nbrs
    assert set(torch.nonzero(dist == 1).flatten().tolist()) == nbrs


@pytest.mark.parametrize("extra", [[], ["--reorder", "degree"]],
                         ids=["natural", "degree"])
def test_cli_validates_on_cpu(extra, capsys):
    argv = ["--market", CHESAPEAKE, "--src", "0", "--validate",
            "--device", "cpu", *extra]
    assert bfs_cli.main(argv) == 0
    assert "bfs validation: PASSED" in capsys.readouterr().out


def test_interop_bfs_fills_tensors():
    jg, _ = j_load_graph_file(CHESAPEAKE)
    tg, _ = load_graph_file(CHESAPEAKE, device="cpu")
    V = tg.n_vertices
    want_d, want_p = torch.zeros(V, dtype=torch.int32), torch.zeros(V, dtype=torch.int32)
    j_interop.bfs(jg, 0, want_d, want_p)
    dist = torch.full((V,), -7, dtype=torch.int64)
    pred = np.zeros(V, np.int32)
    ms = interop.bfs(tg, 0, dist, pred, device="cpu")
    assert ms >= 0.0
    np.testing.assert_array_equal(dist.numpy(), want_d.numpy())
    np.testing.assert_array_equal(pred, want_p.numpy())
    np.testing.assert_array_equal(dist.numpy(), cpu_reference.bfs(tg, 0))
