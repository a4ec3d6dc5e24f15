import numpy as np
import pytest

from portbench import graphs, manifest

CASES = [("kronecker", {"scale": 8, "edge_factor": 16, "a": 0.57, "b": 0.19,
                        "c": 0.19}),
         ("delaunay", {"log2_n": 8})]


def _gen(kind, params, seed):
    return graphs.generate(dict(params, generator=kind), seed, "cpu")


@pytest.mark.parametrize("kind,params", CASES)
def test_seed_determines_graph(kind, params):
    a, b = _gen(kind, params, 2**31 + 11), _gen(kind, params, 2**31 + 11)
    c = _gen(kind, params, 7)
    for f in ("rows", "cols", "weights"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.n_edges != c.n_edges or not np.array_equal(a.cols, c.cols)


@pytest.mark.parametrize("kind,params", CASES)
def test_symmetric_simple_sorted(kind, params):
    e = _gen(kind, params, 3)
    assert not np.any(e.rows == e.cols)
    keys = e.rows.astype(np.int64) * e.n + e.cols
    assert np.all(np.diff(keys) > 0)  # sorted, no duplicate
    rev = np.sort(e.cols.astype(np.int64) * e.n + e.rows)
    np.testing.assert_array_equal(rev, keys)
    # the weight of (u, v) is the weight of (v, u), and in (0, 1]
    w_rev = e.weights[np.searchsorted(keys, e.cols.astype(np.int64) * e.n
                                      + e.rows)]
    np.testing.assert_array_equal(w_rev, e.weights)
    assert e.weights.min() > 0 and e.weights.max() <= 1
    assert e.rows.dtype == np.int32 and e.weights.dtype == np.float32


def test_delaunay_is_a_connected_planar_mesh():
    e = _gen("delaunay", {"log2_n": 9}, 5)
    assert np.unique(graphs.components(e)).shape[0] == 1
    undirected = e.n_edges // 2
    assert undirected <= 3 * e.n - 6  # planar
    assert 5.0 < e.n_edges / e.n < 6.0  # mean degree of a triangulation


def test_kronecker_is_skewed():
    e = _gen("kronecker", CASES[0][1], 5)
    deg = e.degrees()
    assert deg.max() > 5 * deg[deg > 0].mean()
    assert (deg == 0).any()  # Kronecker graphs leave vertices isolated


def test_components_match_a_plain_union_find():
    e = _gen("kronecker", CASES[0][1], 9)
    parent = list(range(e.n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in zip(e.rows.tolist(), e.cols.tolist()):
        parent[find(u)] = find(v)
    roots = np.array([find(x) for x in range(e.n)])
    labels = graphs.components(e)
    # the same partition: each root maps to one label and back
    pairs = np.unique(np.stack([roots, labels]), axis=1)
    assert pairs.shape[1] == np.unique(roots).shape[0] == \
        np.unique(labels).shape[0]


def test_configs_name_their_generator():
    bench = manifest.benchmark()
    for c in bench["configs"]:
        cfg = manifest.config(c["name"])
        assert callable(manifest.generator(cfg["generator"]).generate)
