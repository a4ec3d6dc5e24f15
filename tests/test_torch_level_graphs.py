"""The level graphs' CPU side (``framework/level_graphs.py``): the BFS push
step takes its level as an int or as a 0-d int32 tensor (a level graph's
counter) with the same answer, in the wrapper and in its plain version;
the state given off the card, without a layout or in the checked build is
fresh and uncached; each layout has its own table of states, dropped with
the layout; a started eager state reads the frontier's out-edge sum and
size, before and after a level; the one direction rule picks among the
steps its caller passes, and SSSP passes no dense pull without a pull."""

import dataclasses
import gc

import pytest
import torch

from gunrock_tpu_torch.algorithms import bfs, sssp
from gunrock_tpu_torch.framework.level_graphs import (
    TABLES,
    Levels,
    level_graphs,
    run_levels,
    table,
)
from gunrock_tpu_torch.graph.reorder import degree_sort
from gunrock_tpu_torch.io.generators import rmat_graph
from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.layout import pull_layout
from gunrock_tpu_torch.ops.kernels.semiring import _BIG
from gunrock_tpu_torch.utils import profiler
from gunrock_tpu_torch.utils.limits import UNREACHED


@pytest.fixture(scope="module")
def graph():
    g, _ = degree_sort(rmat_graph(scale=9, seed=4, device="cpu"))
    return g


def _state(g, level: int):
    """Distances with vertices 0-4 at ``level`` (0-2 on the frontier) and
    the rest unreached."""
    dist = torch.full((g.n_vertices,), UNREACHED, dtype=torch.int32)
    dist[:5] = level
    front = torch.zeros(g.n_vertices, dtype=torch.bool)
    front[:3] = True
    return front, dist


@pytest.mark.parametrize("level", [0, 3, 40])
@pytest.mark.parametrize("fn", ["wrapper", "plain"])
def test_push_step_takes_an_int_or_a_level_tensor(graph, fn, level):
    def push(front, dist, it):
        if fn == "wrapper":
            return bfs.bfs_push_step(graph, front, dist, it, 0)
        return bfs.bfs_push_step_plain(graph, front, dist, it)

    front, dist = _state(graph, level)
    new_int, d_int = push(front, dist.clone(), level)
    new_t, d_t = push(front, dist.clone(),
                      torch.tensor(level, dtype=torch.int32))
    assert torch.equal(new_int, new_t) and torch.equal(d_int, d_t)
    assert new_int.any()
    assert torch.equal(new_int, d_int == level + 1)


@pytest.mark.parametrize("case", ["cpu", "no_layout", "checked"])
def test_no_entry_where_the_levels_run_eagerly(graph, case):
    layout = None if case == "no_layout" else pull_layout(graph, unit=True)
    _build.use_checked(case == "checked")
    try:
        levels = level_graphs("bfs", graph, layout, None, torch.int32)
    finally:
        _build.use_checked(False)
    assert isinstance(levels, Levels) and levels.sources is None
    assert levels is not level_graphs("bfs", graph, layout, None,
                                      torch.int32)
    if layout is not None:
        assert id(layout) not in TABLES


def test_a_table_goes_with_its_layout(graph):
    lay = pull_layout(graph, unit=True)
    other = lay.with_span_chunks(3)
    copy = dataclasses.replace(lay)
    table(other)["bfs"] = "entry"
    assert table(copy) == {} and table(other) == {"bfs": "entry"}
    assert table(other) is table(other)
    keys = {id(other), id(copy)}
    del other, copy
    gc.collect()
    assert not keys & TABLES.keys()
    assert id(lay) not in TABLES


@pytest.mark.parametrize("source", [0, 5, 100])
def test_eager_levels_read_sum_and_size(graph, source):
    levels = level_graphs("bfs", graph, None, None, torch.int32)
    levels.start(source, UNREACHED)
    deg = graph.out_degrees()
    assert levels.read() == [int(deg[source]), 1]
    assert torch.equal(levels.dist == 0, levels.front)
    how = levels.step("push", 0, lambda f, d, i: bfs.bfs_push_step(
        graph, f, d, i, 0))
    assert how == "eager"
    layer = levels.dist == 1
    assert torch.equal(levels.front, layer)
    assert levels.read() == [int(deg[layer].sum()), int(layer.sum())]


ALL = ("push", "pull_dense", "pull", "step")


@pytest.mark.parametrize("present,budget,front,want", [
    (ALL, 1 << 30, "one", "push"),  # both numbers under the budget
    (ALL, 1 << 30, "all", "push"),
    (ALL, 1, "all", "pull_dense"),  # the frontier covers half the edges
    (ALL, 1, "one", "pull"),
    (("push", "pull", "step"), 1, "all", "pull"),
    (("push", "pull_dense", "step"), 1, "all", "pull_dense"),
    (("push", "pull_dense", "step"), 1, "one", "step"),
    (("push", "step"), 1, "all", "step"),
])
def test_the_direction_rule_picks_among_the_present_steps(
        graph, present, budget, front, want):
    taken = []

    def fake(name):
        def step(f, d, i):
            taken.append(name)
            return torch.zeros_like(f), d
        return step

    levels = level_graphs("bfs", graph, None, None, torch.int32)
    if front == "one":
        levels.start(0, UNREACHED)
    else:
        full = torch.ones(graph.n_vertices, dtype=torch.bool)
        levels.resume(0, full, torch.zeros(graph.n_vertices,
                                           dtype=torch.int32))
    steps = {name: fake(name) for name in present}
    with profiler.recording() as rec:
        assert run_levels(graph, levels, steps, 0, 5, budget) == 1
    assert taken == [want]
    span, = [x for x in rec.spans if x.name == "bfs.level"]
    assert span.attrs["direction"] == want and span.attrs["graph"] == "eager"


@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_a_dense_layout_alone(graph, kind):
    """Without a pull layout, BFS takes ``layout_dense`` on the levels
    whose frontier covers half the edges; SSSP takes ``sssp_step``, as
    its dense pull comes only with a pull."""
    dense = (pull_layout(graph, unit=True) if kind == "bfs"
             else pull_layout(graph, pad_value=_BIG))
    search = bfs.bfs_kernel_do if kind == "bfs" else sssp.sssp_kernel_do
    with profiler.recording() as rec:
        got, depth = search(graph, 0, edge_budget=1, layout_dense=dense)
    want, wdepth = search(graph, 0, edge_budget=1)
    assert torch.equal(got, want) and depth == wdepth
    levels = [x.attrs for x in rec.spans if x.name == f"{kind}.level"]
    big = [x["out_edges"] >= graph.n_edges // 2 for x in levels]
    assert any(big) and not all(big)
    dense_step = "pull_dense" if kind == "bfs" else "step"
    assert [x["direction"] for x in levels] == [
        dense_step if b else "step" for b in big]
