"""Minimum spanning tree/forest of the PyTorch port against the JAX
package and scipy, on a connected, a disconnected and a directed graph
with heavily tied weights, carried across with ``Graph.from_arrays``.

``mst_edges`` and ``n_components`` are compared exactly for each of the
three strategies against the JAX package's same strategy (its Pallas
min-cut kernel in interpret mode): ties are broken by the (weight,
canonical id) rank in both. The weight is a float32 sum taken in another
order: rtol 1e-5. The edge counts stay far below 2**24, where the JAX
package's f32 ranks are exact."""

import dataclasses

import numpy as np
import pytest
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components, minimum_spanning_tree

from gunrock_tpu.algorithms import mst as jmst
from gunrock_tpu.formats import Coo as JCoo
from gunrock_tpu.graph import build_graph as j_build_graph
from gunrock_tpu.graph.properties import GraphProperties as JGraphProperties

from gunrock_tpu_torch.algorithms import mst
from gunrock_tpu_torch.examples import cpu_reference
from gunrock_tpu_torch.graph import Graph, GraphProperties
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.ops.kernels.layout import DATA_FIELDS, META_FIELDS
from gunrock_tpu_torch.ops.kernels.mst_min import NO_CUT

V = 400


def _edges(kind: str):
    """(rows, cols, weights, symmetric). Weights come from {1, 2, 3, 4}
    (plus a few self loops), so most choices are ties. "connected" and
    "disconnected" store both directions with one weight; "directed"
    stores one direction, and some pairs both ways with two weights."""
    rng = np.random.default_rng({"connected": 1, "disconnected": 2,
                                 "directed": 3}[kind])
    n = 1600
    a = rng.integers(0, V, n)
    b = rng.integers(0, V, n)
    if kind == "connected":  # a ring under the random edges
        a = np.concatenate([a, np.arange(V)])
        b = np.concatenate([b, (np.arange(V) + 1) % V])
    elif kind == "disconnected":  # three islands, vertex 0 isolated
        island = rng.integers(0, 3, n)
        a = 1 + island * 133 + a % 133
        b = 1 + island * 133 + b % 133
    a[:8] = b[:8]  # self loops
    if kind == "directed":
        back = rng.random(a.size) < 0.2
        a, b = np.concatenate([a, b[back]]), np.concatenate([b, a[back]])
        w = rng.integers(1, 5, a.size)
        key, first = np.unique(a * V + b, return_index=True)
        return ((key // V).astype(np.int32), (key % V).astype(np.int32),
                w[first].astype(np.float32), False)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    key = np.unique(lo * V + hi)
    lo, hi = key // V, key % V
    w = 1 + (lo * 7 + hi * 13) % 4  # one weight per unordered pair
    both = lo != hi
    rows = np.concatenate([lo, hi[both]]).astype(np.int32)
    cols = np.concatenate([hi, lo[both]]).astype(np.int32)
    return rows, cols, np.concatenate([w, w[both]]).astype(np.float32), True


def _make(kind: str):
    """(kind, JAX graph, port graph, number of components)."""
    rows, cols, w, symmetric = _edges(kind)
    jg = j_build_graph(
        JCoo(n_rows=V, n_cols=V, row_indices=rows, col_indices=cols, values=w),
        JGraphProperties(directed=not symmetric, weighted=True,
                         symmetric=symmetric))
    tg = Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, V,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")
    und = csr_matrix((np.ones(rows.size), (rows, cols)), shape=(V, V))
    n_comp = connected_components(und, directed=False)[0]
    return kind, jg, tg, n_comp


@pytest.fixture(scope="module", params=["connected", "disconnected",
                                        "directed"])
def graphs(request):
    return _make(request.param)


def test_rank_tables_and_layout_match_jax(graphs):
    _, jg, tg, _ = graphs
    for a, b in zip(mst._rank_tables_np(tg), jmst._rank_tables_np(jg)):
        np.testing.assert_array_equal(a, np.asarray(b))
    jl = jmst._mst_rank_layout(jg, True)  # W=128/C=256 in interpret mode
    tl, ranks = mst._mst_rank_layout(tg, window=jl.window, chunk=jl.chunk)
    for k in META_FIELDS:
        assert getattr(tl, k) == getattr(jl, k), k
    for k in DATA_FIELDS:
        if k == "values":  # the port's ranks ride beside the layout, below
            continue
        want = np.asarray(getattr(jl, k))
        if k in ("src_bits", "dst_bits"):
            want = want.astype(np.uint32).view(np.int32)
        np.testing.assert_array_equal(getattr(tl, k).numpy(), want, err_msg=k)
    # the int32 slot ranks are the JAX layout's f32 ranks; NO_CUT on padding
    pad = (tl.row_local == tl.window).numpy()
    assert pad.any() and (ranks.numpy()[pad] == NO_CUT).all()
    np.testing.assert_array_equal(
        ranks.numpy()[~pad], np.asarray(jl.values)[~pad].astype(np.int32))


@pytest.mark.parametrize("strategy", ["pallas", "contract", "loop"])
def test_run_matches_jax_and_scipy(graphs, strategy):
    kind, jg, tg, n_comp = graphs
    want = jmst.run(jg, strategy=strategy, warmup=False)
    got = mst.run(tg, strategy=strategy, device="cpu")
    np.testing.assert_array_equal(got.mst_edges.numpy(),
                                  np.asarray(want.mst_edges))
    assert got.n_components == want.n_components == n_comp
    np.testing.assert_allclose(got.mst_weight, want.mst_weight, rtol=1e-5)
    np.testing.assert_allclose(got.mst_weight, cpu_reference.mst_weight(tg),
                               rtol=1e-5)
    # a forest: V - components edges, each a CSR edge between two vertices
    mask = got.mst_edges.numpy()
    assert mask.sum() == V - n_comp
    assert (tg.host["edge_src"][mask] != tg.host["col_indices"][mask]).all()
    assert got.rounds >= 2 and got.jump_passes >= got.rounds - 1
    if kind == "connected":
        assert n_comp == 1
    else:
        assert n_comp > 1 or kind == "directed"


def test_auto_takes_the_kernel_path(graphs, monkeypatch):
    _, _, tg, _ = graphs
    calls = []
    real = mst.bucketed_min_rank_cut
    monkeypatch.setattr(mst, "bucketed_min_rank_cut",
                        lambda *a: calls.append(1) or real(*a))
    res = mst.run(tg, warmup=False, device="cpu")
    assert len(calls) == res.rounds


def test_scipy_weight_is_the_undirected_minimum(graphs):
    """The oracle itself: scipy reads an asymmetric matrix as undirected
    with the smaller of two weights, the canonical edge set's rule."""
    _, _, tg, _ = graphs
    lo, hi, w, _ = mst._canonical_edges(tg)
    sym = csr_matrix((w, (lo, hi)), shape=(V, V))
    np.testing.assert_allclose(minimum_spanning_tree(sym).sum(),
                               cpu_reference.mst_weight(tg), rtol=1e-6)


def test_require_connected_raises(graphs):
    kind, _, tg, n_comp = graphs
    if n_comp == 1:
        assert mst.run(tg, require_connected=True,
                       device="cpu").n_components == 1
    else:
        with pytest.raises(RuntimeError, match="components remain"):
            mst.run(tg, require_connected=True, device="cpu")


@pytest.mark.parametrize("strategy", ["auto", "pallas", "contract", "loop"])
def test_edgeless_graph(strategy):
    from gunrock_tpu_torch.formats import Coo
    from gunrock_tpu_torch.graph import build_graph

    e = np.zeros(0, np.int32)
    g = build_graph(Coo(5, 5, e, e, e.astype(np.float32)), device="cpu")
    res = mst.run(g, strategy=strategy, device="cpu")
    assert res.mst_weight == 0.0 and res.n_components == 5
    assert res.mst_edges.shape == (0,)
    with pytest.raises(ValueError):
        mst.run(g, strategy="nope", device="cpu")


@pytest.mark.parametrize("kind", ["connected", "disconnected"])
def test_mst_kernel_edges_on_symmetric_storage(kind):
    """The (weight, id) Boruvka over two-copy storage as it stands: the
    ``src < dst`` cut test picks one copy of each edge, as in the JAX
    package's ``mst_kernel``."""
    _, jg, tg, n_comp = _make(kind)
    weight, in_mst, comps, _, _ = mst._mst_kernel_edges(
        tg.edge_src, tg.col_indices, tg.values, V)
    jw, jmask, jcomps = jmst.mst_kernel(jg)
    np.testing.assert_array_equal(in_mst.numpy(), np.asarray(jmask))
    assert comps == int(jcomps) == n_comp
    np.testing.assert_allclose(float(weight), float(jw), rtol=1e-5)
