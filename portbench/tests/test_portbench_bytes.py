import numpy as np

from portbench import bytecount


def test_work_of_a_query_is_its_components():
    # components: {0, 1, 2} with degrees 1, 2, 1; {3, 4} with 1, 1; {5}
    labels = np.array([0, 0, 0, 1, 1, 2])
    deg = np.array([1, 2, 1, 1, 1, 0])
    comps = bytecount.Components(labels, deg)
    w = comps.work([0])
    assert (w.vertices, w.edges, w.edges_traversed) == (3, 4, 4)
    w = comps.work([1, 2, 4])
    assert (w.vertices, w.edges, w.edges_traversed) == (5, 6, 10)


def test_query_bytes():
    w = bytecount.Work(vertices=3, edges=4, edges_traversed=4)
    # offsets 8 x 3, indices 4 x 4, distance + predecessor 8 x 6 vertices
    assert bytecount.query_bytes(w, 6, 1, False, 2) == 24 + 16 + 48
    # weights add 4 a reached edge; k searches write k columns
    assert bytecount.query_bytes(w, 6, 1, True, 1) == 24 + 32 + 24
    assert bytecount.query_bytes(w, 6, 32, False, 1) == 24 + 16 + 4 * 6 * 32


def test_search_work_counts_each_query_from_the_edge_list():
    from test_portbench_reference import PAIRS, _graph

    e = _graph(8, PAIRS)  # components {0..4} (10 slots), {5, 6} (2), {7}
    works, nbytes = bytecount.search_work(e, [[0], [6], [7]], 1, True, 2)
    assert [w.edges_traversed for w in works] == [10, 2, 0]
    assert nbytes[0] == 8 * 5 + 8 * 10 + 4 * 2 * 8
    works, _ = bytecount.search_work(e, [[0, 5]], 2, False, 1)
    assert (works[0].vertices, works[0].edges_traversed) == (7, 12)
