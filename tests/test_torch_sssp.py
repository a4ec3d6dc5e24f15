"""SSSP of the PyTorch port against the JAX package, on a degree-sorted
weighted R-MAT graph carried across with ``Graph.from_arrays`` and a
``pad_value=_BIG`` pull layout carried across with
``BucketedEdges.from_arrays`` (W=128/C=128, the JAX Pallas kernels in
interpret mode).

Tolerances: the push step is exact (the same f32 additions, a min over
the same candidates). Distances are held within rtol 1e-5, as the JAX
package holds its own DO-SSSP (``tests/test_pallas.py:389-401``); depths
are equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrock_tpu.algorithms import sssp as jsssp
from gunrock_tpu.graph.reorder import degree_sort as j_degree_sort
from gunrock_tpu.io.generators import rmat_graph as j_rmat_graph
from gunrock_tpu.ops.pallas.semiring import _BIG
from gunrock_tpu.ops.pallas.semiring import pull_layout as j_pull_layout

from gunrock_tpu_torch.algorithms import sssp
from gunrock_tpu_torch.examples import cpu_reference
from gunrock_tpu_torch.formats import Coo
from gunrock_tpu_torch.graph import Graph, GraphProperties, build_graph
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.ops.configs import AdvanceDirection, LoadBalance, Options
from gunrock_tpu_torch.ops.kernels.layout import (
    DATA_FIELDS,
    META_FIELDS,
    BucketedEdges,
)


@pytest.fixture(scope="module")
def graphs():
    """(JAX graph, port graph, JAX layout, port layout): R-MAT scale 9,
    degree-sorted, weights in [0.1, 1.1], min_plus pull layout."""
    jg, _ = j_degree_sort(j_rmat_graph(scale=9, seed=1))
    tg = Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")
    jl = j_pull_layout(jg, window=128, chunk=128, pad_value=_BIG)
    return jg, tg, jl, _to_torch_layout(jl)


def _to_torch_layout(jl):
    return BucketedEdges.from_arrays(
        {k: np.asarray(getattr(jl, k)) for k in DATA_FIELDS},
        **{k: getattr(jl, k) for k in META_FIELDS}, device="cpu")


def _frontiers(tg, src):
    """(frontier, distances) before each iteration of a search."""
    dist, front = sssp._start(tg, src)
    out = []
    while bool(front.any()):
        out.append((front, dist))
        front, dist = sssp.sssp_step(tg, front, dist)
    return out


def test_push_step_matches_jax(graphs):
    """The push step on every frontier of a real search: improved masks
    and distances exact."""
    jg, tg, _, _ = graphs
    states = _frontiers(tg, 0)
    assert len(states) >= 3
    for front, dist in states:
        imp_j, new_j = jsssp.sssp_push_step(
            jg, jnp.asarray(front.numpy()), jnp.asarray(dist.numpy()),
            tg.n_edges)
        imp_t, new_t = sssp.sssp_push_step(tg, front, dist, tg.n_edges)
        np.testing.assert_array_equal(imp_t.numpy(), np.asarray(imp_j))
        np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))


def test_push_step_is_jacobi():
    """Path 0 -> 1 -> 2 with both 0 and 1 on the frontier: 2 takes the
    distance of 1 from before the step (5 + 1), not the one this step
    gives 1 (0 + 1 + 1), as the JAX package's step does."""
    g = build_graph(Coo(3, 3, np.int32([0, 1]), np.int32([1, 2]),
                        np.float32([1, 1])), device="cpu")
    dist = torch.tensor([0.0, 5.0, float("inf")])
    front = torch.tensor([True, True, False])
    improved, new = sssp.sssp_push_step(g, front, dist, 16)
    assert new.tolist() == [0.0, 1.0, 6.0]
    assert improved.tolist() == [False, True, True]
    assert dist.tolist() == [0.0, 5.0, float("inf")]  # not written


@pytest.mark.parametrize("mode", ["all_pull", "all_push", "mixed",
                                  "mixed_dense"])
def test_sssp_kernel_do_matches_jax(graphs, mode, monkeypatch):
    """``mixed_dense`` also passes ``layout_dense`` (W=256/C=256), which
    takes the waves whose frontier covers half the edges."""
    jg, tg, jl, tl = graphs
    budget = {"all_pull": 1, "all_push": tg.n_edges + tg.n_vertices + 1,
              "mixed": tg.n_edges // 40, "mixed_dense": tg.n_edges // 40}[mode]
    jl_dense = tl_dense = None
    if mode == "mixed_dense":
        jl_dense = j_pull_layout(jg, window=256, chunk=256, pad_value=_BIG)
        tl_dense = _to_torch_layout(jl_dense)
    taken = []
    push, pull = sssp.sssp_push_step, sssp._pull
    monkeypatch.setattr(sssp, "sssp_push_step",
                        lambda *a: taken.append("push") or push(*a))
    monkeypatch.setattr(sssp, "_pull", lambda lay, *a: taken.append(
        "pull" if lay is tl else "pull_dense") or pull(lay, *a))
    for src in (0, 300):
        d_j, it_j = jsssp.sssp_kernel_do(jg, src, edge_budget=budget,
                                         layout=jl, interpret=True,
                                         layout_dense=jl_dense)
        d_t, it_t = sssp.sssp_kernel_do(tg, src, edge_budget=budget, layout=tl,
                                        layout_dense=tl_dense)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5)
        assert it_t == int(it_j)
    assert set(taken) == {"all_pull": {"pull"}, "all_push": {"push"},
                          "mixed": {"pull", "push"},
                          "mixed_dense": {"pull", "push", "pull_dense"}}[mode]


def test_sssp_kernel_pallas_matches_jax(graphs):
    """The dense min_plus pass (B3) per wave."""
    jg, tg, jl, tl = graphs
    d_j, it_j = jsssp.sssp_kernel_pallas(jg, 5, layout=jl, interpret=True)
    d_t, it_t = sssp.sssp_kernel_pallas(tg, 5, layout=tl)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5)
    assert it_t == int(it_j)


@pytest.mark.parametrize("kernel", ["sssp_kernel_delta", "sssp_kernel"])
def test_plain_kernels_match_jax(graphs, kernel):
    """Delta-stepping and the plain Bellman-Ford wave loop."""
    jg, tg, _, _ = graphs
    d_j, it_j = getattr(jsssp, kernel)(jg, 7)
    d_t, it_t = getattr(sssp, kernel)(tg, 7)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5)
    if kernel == "sssp_kernel":
        assert it_t == int(it_j)


def _tight_predecessors(tg, dist, pred, src):
    """Every reached vertex but the source has pred on an in-edge with
    dist[pred] + w close to dist[v]; the rest have -1."""
    h = tg.host
    u, v, w = h["csc_rows"], h["csc_dst"], h["csc_values"]
    ok = (pred[v] == u) & np.isclose(dist[u] + w, dist[v])
    has = np.zeros(tg.n_vertices, bool)
    has[v[ok]] = True
    need = np.isfinite(dist)
    need[src] = False
    np.testing.assert_array_equal(has, need)
    assert (pred[~need] == -1).all()


@pytest.mark.parametrize("options", [
    None,
    Options(),
    Options(load_balance=LoadBalance.BUCKETING),
    Options(load_balance=LoadBalance.PALLAS_MERGE_PATH),
    Options(advance_direction=AdvanceDirection.OPTIMIZED),
], ids=["do_kernels", "enactor", "delta", "dense_min_plus", "do_plain"])
def test_run_matches_cpu_oracle(graphs, options):
    """Each dispatch branch of ``run`` against Dijkstra (rtol 1e-5) and
    the JAX package's ``run``; predecessors equal the JAX package's and
    lie on tight in-edges."""
    jg, tg, _, _ = graphs
    for src in (0, 42):
        got = sssp.run(tg, src, options=options, device="cpu")
        dist = got.distances.numpy()
        np.testing.assert_allclose(dist, cpu_reference.sssp(tg, src),
                                   rtol=1e-5)
        want = jsssp.run(jg, src)
        np.testing.assert_allclose(dist, np.asarray(want.distances), rtol=1e-5)
        pred = got.predecessors.numpy()
        np.testing.assert_array_equal(pred, np.asarray(want.predecessors))
        _tight_predecessors(tg, dist, pred, src)
        assert got.search_depth > 0 and got.elapsed_ms >= 0.0


def test_run_rejects_out_of_range_source(graphs):
    _, tg, _, _ = graphs
    with pytest.raises(ValueError, match="out of range"):
        sssp.run(tg, -1, device="cpu")
