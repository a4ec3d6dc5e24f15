"""The level graphs of the direction-optimizing searches
(``framework/level_graphs.py``) on the card: ``bfs.run`` and ``sssp.run``
replaying captured CUDA graphs give the distances and depth of the same
search on the CPU bit for bit, on a degree-sorted undirected R-MAT graph
and on ``probes/predecessor_cases.py``'s graphs, eight sources each, from
a source whose frontier empties at level 0, and through
``sssp_do_slabbed`` resumed across slabs; a direction runs eagerly, is
captured, then replayed; a search on a warm layout only replays, and
each replay counts its kernels' launches; the checked build runs every
level eagerly.

Marked ``card``: each skips without a CUDA device. The file imports no
JAX, so that on the card it runs without the test tree's configuration:

    python -m pytest tests/test_torch_level_graphs_card.py --noconftest -q
"""

import collections

import pytest
import torch

from gunrock_tpu_torch.algorithms import bfs, sssp
from gunrock_tpu_torch.graph.reorder import degree_sort
from gunrock_tpu_torch.io.generators import rmat_graph
from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.layout import pull_layout
from gunrock_tpu_torch.ops.kernels.semiring import _BIG
from gunrock_tpu_torch.probes import predecessor_cases
from gunrock_tpu_torch.utils import profiler

RUNS = {"bfs": bfs.run, "sssp": sssp.run}
GRAPHS = ["rmat", "hub", "directed", "unreached", "ties"]


@pytest.fixture(scope="module")
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _graph(name: str, device):
    if name == "rmat":
        return degree_sort(rmat_graph(14, 16, seed=5, undirected=True,
                                      device=device))[0]
    if name == "hub":
        return predecessor_cases.hub_graph(device)[0]
    return getattr(predecessor_cases, f"{name}_graph")(device)


def _sources(g) -> list:
    """Eight sources: the top-degree vertex, six of nonzero degree drawn
    from a seed, and one of degree 0 where there is one (its frontier
    empties at level 0), else an eighth drawn one."""
    deg = g.out_degrees().cpu()
    gen = torch.Generator().manual_seed(11)
    live = torch.nonzero(deg > 0).flatten()
    picks = live[torch.randperm(live.numel(), generator=gen)[:7]].tolist()
    out = [int(deg.argmax())] + picks[:6]
    dead = torch.nonzero(deg == 0).flatten()
    out.append(int(dead[0]) if dead.numel() else picks[6])
    return out


@pytest.fixture(scope="module")
def graphs(card):
    return {name: _graph(name, card) for name in GRAPHS}


def _levels(run, g, s, device):
    """(result, the search's level spans) of one recorded call."""
    with profiler.recording() as rec:
        res = run(g, s, warmup=False, device=device)
    return res, [x for x in rec.spans if x.name.endswith(".level")]


@pytest.mark.card
@pytest.mark.parametrize("kind", ["bfs", "sssp"])
@pytest.mark.parametrize("name", GRAPHS)
def test_replayed_searches_equal_the_cpu(graphs, kind, name):
    g = graphs[name]
    cpu = g.to("cpu")
    hows = collections.Counter()
    for s in _sources(g) * 2:  # the second round replays the first's captures
        got, levels = _levels(RUNS[kind], g, s, g.device)
        want = RUNS[kind](cpu, s, warmup=False, device="cpu")
        assert got.search_depth == want.search_depth
        assert torch.equal(got.distances.cpu(), want.distances)
        assert len(levels) == got.search_depth
        hows.update(x.attrs["graph"] for x in levels)
    assert hows["replay"] > hows["capture"] + hows["eager"]


@pytest.mark.card
def test_empty_frontier_at_level_zero(graphs):
    g = graphs["unreached"]
    s = int(torch.nonzero(g.out_degrees() == 0).flatten()[0])
    for kind, run in RUNS.items():
        res = run(g, s, warmup=False, device=g.device)
        assert res.search_depth == 1
        assert int((res.predecessors >= 0).sum()) == 0


@pytest.mark.card
@pytest.mark.parametrize("rounds", [1, 2, 5])
def test_slabbed_sssp_resumes_on_the_graph_path(graphs, rounds):
    g = graphs["rmat"]
    lay = pull_layout(g, pad_value=_BIG)
    cpu = g.to("cpu")
    cpu_lay = pull_layout(cpu, pad_value=_BIG)
    before = _build.LAUNCHES["level_graph_replay"]
    for s in _sources(g)[:3]:
        dist, depth = sssp.sssp_do_slabbed(g, s, rounds, layout=lay)
        want, wdepth = sssp.sssp_do_slabbed(cpu, s, rounds, layout=cpu_lay)
        assert depth == wdepth
        assert torch.equal(dist.cpu(), want)
        whole, _ = sssp.sssp_kernel_do(g, s, layout=lay)
        assert torch.equal(whole, dist)
    assert _build.LAUNCHES["level_graph_replay"] > before


@pytest.mark.card
@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_a_direction_runs_eagerly_then_is_captured_then_replayed(card, kind):
    g = _graph("rmat", card)  # a fresh layout: nothing captured yet
    s = _sources(g)[0]
    seen = {}
    for _ in range(3):
        _, levels = _levels(RUNS[kind], g, s, g.device)
        for x in levels:
            seen.setdefault(x.attrs["direction"], []).append(x.attrs["graph"])
    for hows in seen.values():
        assert hows[:2] == ["eager", "capture"]
        assert set(hows[2:]) == {"replay"}


@pytest.mark.card
@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_a_warm_layout_only_replays(graphs, kind):
    g = graphs["rmat"]
    kernel = f"{kind}_push_step"
    for s in _sources(g)[:2] * 2:
        RUNS[kind](g, s, warmup=False, device=g.device)
    for s in _sources(g)[:2]:
        before = collections.Counter(_build.LAUNCHES)
        res, levels = _levels(RUNS[kind], g, s, g.device)
        grew = _build.LAUNCHES - before
        push = sum(x.attrs["direction"] == "push" for x in levels)
        assert {x.attrs["graph"] for x in levels} == {"replay"}
        assert grew["level_graph_capture"] == 0
        assert grew["level_graph_replay"] == res.search_depth
        assert grew[kernel] == push
        assert grew["bucketed_semiring_spmv_sparse"] == len(levels) - push


@pytest.mark.card
@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_the_checked_build_runs_every_level_eagerly(graphs, kind):
    """The checked build waits for the card after each launch, which a
    capture forbids: its levels run eagerly, with the same answer."""
    g = graphs["rmat"]
    s = _sources(g)[1]
    want = RUNS[kind](g, s, warmup=False, device=g.device)
    _build.use_checked(True)
    try:
        got, levels = _levels(RUNS[kind], g, s, g.device)
    finally:
        _build.use_checked(False)
    assert {x.attrs["graph"] for x in levels} == {"eager"}
    assert torch.equal(got.distances, want.distances)
