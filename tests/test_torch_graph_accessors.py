"""Graph's accessors and degree statistics in the port against the JAX
package's, on the same graphs: the sample graphs, random symmetric graphs
of 30 and 80 vertices, R-MAT 10, an edgeless graph, a graph with a
repeated edge, and a graph whose degrees straddle every power of two up to
2^16. Scalar calls are held to the JAX method, tensor calls to
``jax.vmap`` of it; integers exactly, the float statistics within rtol
1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrock_tpu.graph.graph import Graph as JGraph
from gunrock_tpu.graph.properties import GraphProperties as JProps
from gunrock_tpu.io import sample as j_sample
from gunrock_tpu.io.generators import rmat_graph as j_rmat_graph

from gunrock_tpu_torch.graph import Graph, GraphProperties
from gunrock_tpu_torch.graph.graph import ARRAYS
from tests.conftest import random_graph


def to_port(jg) -> Graph:
    return Graph.from_arrays(
        {k: np.array(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")


def from_edges(V: int, src, dst, directed: bool = True):
    """(JAX graph, port graph) of the edge list as given, repeats kept:
    CSR sorted by (src, dst), CSC by (dst, src)."""
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    w = (np.arange(src.size, dtype=np.float32) % 7) + 0.5
    csc = np.lexsort((src, dst))

    def offsets(key):
        out = np.zeros(V + 1, np.int32)
        np.cumsum(np.bincount(key, minlength=V), out=out[1:])
        return out

    arrays = {
        "row_offsets": offsets(src), "col_indices": dst, "values": w,
        "edge_src": src, "csc_offsets": offsets(dst), "csc_rows": src[csc],
        "csc_dst": dst[csc], "csc_values": w[csc],
        "csc_edge_perm": csc.astype(np.int32),
    }
    props = dict(directed=directed, weighted=True, symmetric=not directed)
    jg = JGraph(**{k: jnp.asarray(a) for k, a in arrays.items()},
                n_vertices=V, n_edges=int(src.size), properties=JProps(**props))
    tg = Graph.from_arrays({k: a.copy() for k, a in arrays.items()}, V,
                           GraphProperties(**props), device="cpu")
    return jg, tg


def _repeated():
    # 0 -> 1 twice, 0 -> 2, 1 -> {0, 2}, 2 -> {0, 1, 1}, 3 -> 3
    return from_edges(4, [0, 0, 0, 1, 1, 2, 2, 2, 3],
                      [1, 1, 2, 0, 2, 0, 1, 1, 3])


def _graph(name):
    if name == "sample":
        jg = j_sample.graph()
    elif name == "small_connected":
        jg = j_sample.small_connected_graph()
    elif name == "random30_sym":
        jg = random_graph(None, n=30, p=0.2, symmetric=True, seed_offset=80)[0]
    elif name == "random80_sym":
        jg = random_graph(None, n=80, p=0.15, symmetric=True, seed_offset=21)[0]
    elif name == "rmat10":
        jg = j_rmat_graph(scale=10, seed=2)
    elif name == "repeated":
        return _repeated()
    return jg, to_port(jg)


GRAPHS = ["sample", "small_connected", "random30_sym", "random80_sym",
          "rmat10", "repeated"]


@pytest.fixture(scope="module", params=GRAPHS)
def pair(request):
    return _graph(request.param)


def same(got: torch.Tensor, want, dtype=torch.int32):
    assert isinstance(got, torch.Tensor) and got.dtype == dtype
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def pairs(jg, n_random: int, seed: int):
    """Every edge's (u, v), ``n_random`` seeded pairs, every (u, u), and
    (u, v) with v outside [0, V)."""
    V = jg.n_vertices
    rng = np.random.default_rng(seed)
    u = np.concatenate([np.asarray(jg.edge_src), rng.integers(0, V, n_random),
                        np.arange(V), rng.integers(0, V, 8)])
    v = np.concatenate([np.asarray(jg.col_indices), rng.integers(0, V, n_random),
                        np.arange(V), np.array([-1, V, V + 5, -3, V, 2 * V, -1, V])])
    return u.astype(np.int32), v.astype(np.int32)


def test_counts_and_degrees(pair):
    jg, tg = pair
    assert tg.get_number_of_vertices() == jg.get_number_of_vertices()
    assert tg.get_number_of_edges() == jg.get_number_of_edges()
    vs = np.arange(jg.n_vertices, dtype=np.int32)
    for name in ("get_number_of_neighbors", "get_in_degree", "get_starting_edge"):
        want = jax.vmap(getattr(jg, name))(jnp.asarray(vs))
        same(getattr(tg, name)(torch.from_numpy(vs)), want)
        for v in (0, jg.n_vertices - 1):
            same(getattr(tg, name)(v), getattr(jg, name)(v))
    same(tg.in_degrees(), jg.in_degrees())
    same(tg.out_degrees(), jg.out_degrees())


def test_edge_lookups(pair):
    jg, tg = pair
    es = np.arange(jg.n_edges, dtype=np.int32)
    for name, dtype in (("get_destination_vertex", torch.int32),
                        ("get_edge_weight", torch.float32)):
        same(getattr(tg, name)(torch.from_numpy(es)),
             jax.vmap(getattr(jg, name))(jnp.asarray(es)), dtype)
        same(getattr(tg, name)(jg.n_edges - 1), getattr(jg, name)(jg.n_edges - 1),
             dtype)
    # the row search, also outside [0, E)
    es = np.arange(-3, jg.n_edges + 3, dtype=np.int32)
    same(tg.get_source_vertex(torch.from_numpy(es)),
         jax.vmap(jg.get_source_vertex)(jnp.asarray(es)))
    for e in (-1, 0, jg.n_edges - 1, jg.n_edges):
        same(tg.get_source_vertex(e), jg.get_source_vertex(e))


def test_get_edge(pair):
    jg, tg = pair
    u, v = pairs(jg, 2000, seed=5)
    want = jax.vmap(jg.get_edge)(jnp.asarray(u), jnp.asarray(v))
    same(tg.get_edge(torch.from_numpy(u), torch.from_numpy(v)), want)
    # a 2-D batch and scalar calls, missing pairs among them
    same(tg.get_edge(torch.from_numpy(u[:12].reshape(3, 4)),
                     torch.from_numpy(v[:12].reshape(3, 4))),
         np.asarray(want)[:12].reshape(3, 4))
    for a, b in zip(u[-10:], v[-10:]):
        same(tg.get_edge(int(a), int(b)), jg.get_edge(int(a), int(b)))
    assert (np.asarray(want) == -1).any()


def test_get_edge_takes_the_first_of_repeats():
    jg, tg = _repeated()
    assert int(jg.get_edge(0, 1)) == int(tg.get_edge(0, 1)) == 0
    assert int(jg.get_edge(2, 1)) == int(tg.get_edge(2, 1)) == 6
    same(tg.get_edge(torch.tensor([3, 3, 1]), torch.tensor([3, 2, 1])),
         [8, -1, -1])


def test_get_intersection_count(pair):
    jg, tg = pair
    u, v = pairs(jg, 500, seed=7)
    keep = (v >= 0) & (v < jg.n_vertices)  # JAX reads any v's row clamped
    u, v = u[keep], v[keep]
    want = jax.vmap(jg.get_intersection_count)(jnp.asarray(u), jnp.asarray(v))
    same(tg.get_intersection_count(torch.from_numpy(u), torch.from_numpy(v)),
         want)
    for a, b in zip(u[:5], v[:5]):
        same(tg.get_intersection_count(int(a), int(b)),
             jg.get_intersection_count(int(a), int(b)))


def test_intersection_of_a_vertex_with_itself_is_its_degree(pair):
    jg, tg = pair
    vs = torch.arange(jg.n_vertices)
    same(tg.get_intersection_count(vs, vs), jg.out_degrees())


def test_intersection_counts_a_repeated_neighbour_as_jax():
    """The smaller row is walked, u's on a tie: 2 -> {0, 1, 1} against
    0 -> {1, 1, 2} counts 1 twice; 1 -> {0, 2} against 2 counts 0 once."""
    jg, tg = _repeated()
    u = np.array([2, 0, 1, 2, 0, 3, 2], np.int32)
    v = np.array([0, 2, 2, 1, 0, 3, 2], np.int32)
    want = jax.vmap(jg.get_intersection_count)(jnp.asarray(u), jnp.asarray(v))
    got = tg.get_intersection_count(torch.from_numpy(u), torch.from_numpy(v))
    same(got, want)
    assert got.tolist() == [2, 2, 1, 1, 3, 1, 3]


def test_intersection_streams_in_blocks(monkeypatch):
    import gunrock_tpu_torch.graph.graph as tgraph

    jg, tg = _graph("rmat10")
    u, v = pairs(jg, 300, seed=9)
    keep = (v >= 0) & (v < jg.n_vertices)
    u, v = torch.from_numpy(u[keep]), torch.from_numpy(v[keep])
    want = tg.get_intersection_count(u, v)
    monkeypatch.setattr(tgraph, "INTERSECT_BLOCK", 97)
    same(tg.get_intersection_count(u, v), want.numpy())


@pytest.mark.parametrize("fold", ["count", "sum", "tuple"])
def test_intersect_neighbors(pair, fold):
    jg, tg = pair
    fns = {
        "count": (lambda a, y: a + 1, lambda: jnp.int32(0),
                  lambda: torch.tensor(0, dtype=torch.int32)),
        "sum": (lambda a, y: a + y, lambda: jnp.int32(0),
                lambda: torch.tensor(0, dtype=torch.int32)),
        # a pytree: (count, sum of y * 3 + count, the last y)
        "tuple": (lambda a, y: (a[0] + 1, a[1] + y * 3 + a[0], y),
                  lambda: (jnp.int32(0), jnp.int32(0), jnp.int32(-1)),
                  lambda: tuple(torch.tensor(x, dtype=torch.int32)
                                for x in (0, 0, -1))),
    }
    fn, jinit, tinit = fns[fold]
    deg = np.asarray(jg.out_degrees())
    hubs = np.argsort(-deg, kind="stable")[:2]
    uv = [(int(hubs[0]), int(hubs[1])), (0, 1), (1, 0),
          (int(hubs[0]), int(hubs[0])), (jg.n_vertices - 1, 0)]
    for u, v in uv:
        want = jax.tree_util.tree_leaves(jg.intersect_neighbors(u, v, fn, jinit()))
        got = tg.intersect_neighbors(u, v, fn, tinit())
        got = list(got) if isinstance(got, tuple) else [got]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)


def test_degree_statistics(pair):
    jg, tg = pair
    for name in ("get_average_degree", "get_degree_standard_deviation"):
        got = getattr(tg, name)()
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(getattr(jg, name)()),
                                   rtol=1e-6)
    same(tg.build_degree_histogram(), jg.build_degree_histogram())


def test_degree_histogram_at_powers_of_two():
    """Degrees 0-4 and 2^k - 1, 2^k, 2^k + 1 up to 2^16: JAX's float32
    bin formula, bin for bin."""
    degs = [0, 1, 2, 3, 4]
    for k in range(1, 17):
        degs += [2**k - 1, 2**k, 2**k + 1]
    V = 2**16 + 2
    src = np.repeat(np.arange(len(degs)), degs)
    dst = np.concatenate([np.arange(d) for d in degs])
    jg, tg = from_edges(V, src, dst)
    want = np.asarray(jg.build_degree_histogram())
    same(tg.build_degree_histogram(), want)
    assert want.sum() == V and want[17] > 0
    for name in ("get_average_degree", "get_degree_standard_deviation"):
        np.testing.assert_allclose(float(getattr(tg, name)()),
                                   float(getattr(jg, name)()), rtol=1e-6)


def test_degree_histogram_bins_up_to_2_to_the_24():
    """The bin of each single degree around every power of two up to 2^24,
    and of a run of 2^20 degrees, against JAX's formula: both methods run
    on a stand-in graph whose ``out_degrees`` is the given vector."""
    from types import SimpleNamespace

    def hist(degrees):
        jg = SimpleNamespace(out_degrees=lambda: jnp.asarray(degrees))
        tg = SimpleNamespace(out_degrees=lambda: torch.from_numpy(degrees),
                             device=torch.device("cpu"))
        return (Graph.build_degree_histogram(tg).numpy(),
                np.asarray(JGraph.build_degree_histogram(jg)))

    for k in range(1, 25):
        for d in (2**k - 1, 2**k, 2**k + 1):
            got, want = hist(np.array([d], np.int32))
            np.testing.assert_array_equal(got, want, err_msg=str(d))
    got, want = hist(np.arange(2**21 - 2**19, 2**21 + 2**19, dtype=np.int32))
    np.testing.assert_array_equal(got, want)


def test_edgeless_graph():
    """JAX's get_edge, get_intersection_count and intersect_neighbors read
    index -1 of an empty array and raise; the port answers -1, 0 and the
    fold's ``init``. Everything else equals JAX's."""
    jg, tg = from_edges(5, [], [])
    vs = torch.arange(5)
    same(tg.get_number_of_neighbors(vs), np.zeros(5))
    same(tg.get_in_degree(vs), np.zeros(5))
    same(tg.get_source_vertex(torch.tensor([-1, 0, 3])),
         jax.vmap(jg.get_source_vertex)(jnp.array([-1, 0, 3])))
    same(tg.build_degree_histogram(), jg.build_degree_histogram())
    assert float(tg.get_average_degree()) == float(jg.get_average_degree()) == 0.0
    assert float(tg.get_degree_standard_deviation()) == 0.0
    for call in (lambda: jg.get_edge(1, 2),
                 lambda: jg.get_intersection_count(1, 2),
                 lambda: jg.intersect_neighbors(1, 2, lambda a, y: a + 1,
                                                jnp.int32(0))):
        with pytest.raises(IndexError):
            call()
    same(tg.get_edge(vs, vs.flip(0)), np.full(5, -1))
    same(tg.get_intersection_count(vs, vs.flip(0)), np.zeros(5))
    init = torch.tensor(7, dtype=torch.int32)
    assert tg.intersect_neighbors(1, 2, lambda a, y: a + 1, init) is init


def test_accessors_take_tensors_from_another_device_and_keep_the_graph():
    """An index tensor is moved to the graph's device, and no method adds
    a dataclass field."""
    _, tg = _graph("sample")
    fields = [f.name for f in dataclasses.fields(tg)]
    assert tg.get_edge(torch.tensor([1], dtype=torch.int16), 1).tolist() == [1]
    assert tg.get_intersection_count(np.int64(1), torch.tensor(1)).item() == 2
    assert [f.name for f in dataclasses.fields(tg)] == fields
