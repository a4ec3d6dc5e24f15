"""The level graphs' CPU side (``framework/level_graphs.py``): the BFS push
step takes its level as an int or as a 0-d int32 tensor (a level graph's
counter) with the same answer, in the wrapper and in its plain version;
no entry is made off the card, without a layout or in the checked build;
each layout has its own table of level graphs, dropped with the layout;
the eager levels read the frontier's out-edge sum and size."""

import dataclasses
import gc

import pytest
import torch

from gunrock_tpu_torch.algorithms import bfs
from gunrock_tpu_torch.framework.level_graphs import (
    TABLES,
    Levels,
    level_graphs,
    table,
)
from gunrock_tpu_torch.graph.reorder import degree_sort
from gunrock_tpu_torch.io.generators import rmat_graph
from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.layout import pull_layout
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
        assert level_graphs("bfs", graph, layout, None, torch.int32) is None
    finally:
        _build.use_checked(False)
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
    front = torch.zeros(graph.n_vertices, dtype=torch.bool)
    front[source] = True
    dist = torch.where(front, 0, UNREACHED).to(torch.int32)
    levels = Levels("bfs", graph, None, front, dist, 0)
    deg = graph.out_degrees()
    assert levels.read() == [int(deg[source]), 1]
    how = levels.step("push", 0, lambda f, d, i: bfs.bfs_push_step(
        graph, f, d, i, 0))
    assert how == "eager"
    layer = levels.distances() == 1
    assert torch.equal(levels.frontier(), layer)
    assert levels.read() == [int(deg[layer].sum()), int(layer.sum())]
