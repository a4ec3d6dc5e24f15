"""Each query's sources come from the seed as the query is issued."""

import numpy as np

from portbench.cell import Sources
from test_portbench_reference import PAIRS, _graph

EDGES = _graph(8, PAIRS)  # vertex 7 has no edge


def _draws(traffic, seed, n):
    src = Sources(EDGES, traffic, seed)
    return np.stack([src.next() for _ in range(n)])


def test_the_seed_gives_the_draws():
    t = {"sources": "nonzero_degree", "batch": 3}
    a, b = _draws(t, 2**31 + 3, 50), _draws(t, 2**31 + 3, 50)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (50, 3) and a.dtype == np.int64
    assert not np.array_equal(a, _draws(t, 4, 50))
    assert not (a == 7).any()  # never a vertex without an edge
    assert (_draws({"sources": "uniform"}, 1, 400) == 7).any()


def test_a_source_set_is_the_same_set_in_each_seed_order():
    t = {"sources": "uniform", "source_set": 5, "source_set_seed": 1}
    a, b = _draws(t, 11, 15)[:, 0], _draws(t, 12, 15)[:, 0]
    for draws in (a, b):
        # three whole permutations of one set
        cycles = [sorted(draws[i:i + 5].tolist()) for i in (0, 5, 10)]
        assert cycles[0] == cycles[1] == cycles[2]
    assert sorted(a[:5].tolist()) == sorted(b[:5].tolist())


def test_warmup_takes_the_top_degree_vertices_first():
    src = Sources(EDGES, {"sources": "nonzero_degree", "batch": 2}, 5)
    top, other = src.warmup()
    assert top.tolist() == [1, 0]  # degrees 3, 2 (0 before 2 and 4)
    assert other.shape == (2,)
