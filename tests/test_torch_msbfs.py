"""Bit-parallel multi-source BFS on the CPU (``ops/kernels/msbfs.py``,
``csrc/msbfs.cu``, ``algorithms/bfs.msbfs_kernel``).

- The plain bit pass against the JAX package's ``msbfs_kernel`` (B4 in
  interpret mode): distances and depth equal, on a directed and an
  undirected R-MAT graph, for K of 1, 3, 32, 33 and 64 (one word, a part
  word, two words); duplicate sources, a source of no out-edge and a
  ``max_iterations`` cut.
- The counters and spans against counts made by hand on a six-vertex
  graph, and the level spans' ``n_front`` against the distances.
- A numpy model of the kernel's schedule (a lane, a warp or a block a run
  by its length, strides and rounds in slot order, the covering slot found
  by counting the lanes or threads that do not cover; its constants read
  from the source) against the plain pass, level by level, on a graph with
  a planted hub past the block threshold.
- The CPU dispatch: the plain versions, no CUDA library loaded, no launch
  counted, the ``kernel.*`` spans inside the query's span.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrock_tpu.algorithms import bfs as jbfs
from gunrock_tpu.graph.reorder import degree_sort as j_degree_sort
from gunrock_tpu.io.generators import rmat_graph as j_rmat_graph
from gunrock_tpu.ops.pallas.semiring import pull_layout as j_pull_layout

from gunrock_tpu_torch.algorithms import bfs
from gunrock_tpu_torch.formats import Coo
from gunrock_tpu_torch.graph import Graph, GraphProperties, build_graph
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels import msbfs as M
from gunrock_tpu_torch.probes import predecessor_cases
from gunrock_tpu_torch.utils import profiler
from gunrock_tpu_torch.utils.limits import UNREACHED

SOURCE = (_build.CSRC / "msbfs.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


C = {k: _const(k) for k in ("kThreads", "kLaneRun", "kBlockRun",
                            "kLaneLoads", "kLaneLoadsAfter", "kWarpLoads",
                            "kWarpLoadsAfter", "kBlockLoads")}
KS = [1, 3, 32, 33, 64]


def _port(jg) -> Graph:
    return Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")


@pytest.fixture(scope="module")
def graphs():
    """{name: (JAX graph, port graph, JAX unit pull layout)}: a directed
    R-MAT graph (scale 8) in its natural order and an undirected one,
    degree-sorted."""
    out = {}
    for name, jg in (
            ("directed", j_rmat_graph(scale=8, seed=2)),
            ("undirected", j_degree_sort(j_rmat_graph(
                scale=8, seed=3, undirected=True))[0])):
        out[name] = (jg, _port(jg),
                     j_pull_layout(jg, window=128, chunk=128, unit=True))
    return out


@pytest.fixture(scope="module")
def hub():
    """An undirected R-MAT graph (scale 14) with a planted hub of
    ``predecessor_cases.HUB_LEAVES`` neighbours, past the kernel's block
    threshold and its first block round, degree-sorted: the hub is
    vertex 0."""
    return predecessor_cases.hub_graph("cpu")[0]


def _sources(V: int, K: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).choice(V, K, replace=K > V).astype(
        np.int32)


def _jax(jg, jl, sources, max_iterations=None):
    d, it = jbfs.msbfs_kernel(jg, jnp.asarray(sources), pull_layout=jl,
                              max_iterations=max_iterations, interpret=True)
    return np.asarray(d), int(it)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("name", ["directed", "undirected"])
def test_matches_jax(graphs, name, K):
    jg, tg, jl = graphs[name]
    sources = _sources(tg.n_vertices, K, K)
    d, depth = bfs.msbfs_kernel(tg, sources)
    want, want_depth = _jax(jg, jl, sources)
    assert d.dtype == torch.int32 and d.shape == (tg.n_vertices, K)
    np.testing.assert_array_equal(d.numpy(), want)
    assert depth == want_depth


def _odd_sources(tg):
    deg = tg.out_degrees().numpy()
    zero = int(np.flatnonzero(deg == 0)[0])
    top = int(np.argmax(deg))
    return {
        "duplicates": (np.array([5, 5, top, 5, 200, top, 5], np.int32), None),
        "zero_degree": (np.array([zero, top, zero, 7], np.int32), None),
        "max_iterations": (_sources(tg.n_vertices, 33, 9), 2),
    }


@pytest.mark.parametrize("case", ["duplicates", "zero_degree",
                                  "max_iterations"])
def test_odd_sources_match_jax_and_single_source(graphs, case):
    jg, tg, jl = graphs["directed"]
    sources, cut = _odd_sources(tg)[case]
    d, depth = bfs.msbfs_kernel(tg, sources, max_iterations=cut)
    want, want_depth = _jax(jg, jl, sources, max_iterations=cut)
    np.testing.assert_array_equal(d.numpy(), want)
    assert depth == want_depth
    for k, s in enumerate(sources.tolist()):
        col = bfs.bfs_kernel(tg, s, max_iterations=cut,
                             compute_predecessors=False)[0]
        np.testing.assert_array_equal(d[:, k].numpy(), col.numpy())
    if case == "zero_degree":
        assert int((d[:, 0] != UNREACHED).sum()) == 1
    if case == "max_iterations":
        assert depth == 2 and int(d[d != UNREACHED].max()) == 2


# six vertices: 0 -> 1, 0 -> 2, 1 -> 3, 2 -> 3, 3 -> 4, 5 -> 4; searches
# from 0 and 5. CSC runs: 1 [0], 2 [0], 3 [1, 2], 4 [3, 5]. By hand, level
# by level: the live searches, the scanned (vertex, slots) and the vertices
# gaining a search.
#   0: live {0, 1}: 0 (0), 1 (1), 2 (1), 3 (2), 4 (2), 5 (0) -> 1, 2, 4
#   1: live {0, 1}: the same, 6 slots                         -> 3
#   2: live {0} (search 1 has ended): 4 (1: slot 3 covers its one live
#      unseen search), 5 (0)                                  -> 4
#   3: live {0}: 5 (0)                                        -> none
HAND_FRONTS = [2, 3, 1, 1]
HAND_SLOTS = [6, 6, 1, 0]


def _hand_graph():
    src = np.array([0, 0, 1, 2, 3, 5], np.int32)
    dst = np.array([1, 2, 3, 3, 4, 4], np.int32)
    return build_graph(Coo(6, 6, src, dst, np.ones(6, np.float32)),
                       GraphProperties(directed=True, weighted=False), "cpu")


def test_counters_by_hand():
    g = _hand_graph()
    st = M.MsbfsState.empty(6, 2, "cpu")
    M.msbfs_start(g, torch.tensor([0, 5]), st)
    assert st.counts.tolist() == [2, 0, 0]
    assert st.front[:, 0].tolist() == [1, 0, 0, 0, 0, 2]
    assert st.aux.tolist() == [[3, 0b100001], [0, 0], [0, 0]]
    total = 0
    lives = [3, 1, 1, 0]
    for level, (n, s) in enumerate(zip(HAND_FRONTS[1:] + [0], HAND_SLOTS)):
        M.msbfs_pull(g, st, level)
        total += s
        assert st.counts[(level + 1) % 2] == n and st.counts[level % 2] == 0
        assert st.counts[2] == total
        assert st.aux[(level + 1) % 3, 0] == lives[level]
        assert st.aux[(level + 2) % 3].tolist() == [0, 0]
    assert st.dist.T.tolist() == [[0, 1, 1, 2, 3, UNREACHED],
                                  [UNREACHED] * 4 + [1, 0]]
    assert st.seen[:, 0].tolist() == [1, 1, 1, 1, 3, 2]


def test_spans_by_hand():
    g = _hand_graph()
    with profiler.recording() as rec:
        dist, depth = bfs.msbfs_kernel(g, [0, 5])
    spans = rec.spans
    query = spans[0]
    assert query.name == "msbfs" and depth == 4
    assert query.attrs["slots"] == sum(HAND_SLOTS)
    assert query.attrs["scan_share"] == sum(HAND_SLOTS) / (4 * 6)
    levels = [s for s in spans if s.name == "msbfs.level"]
    assert [s.attrs["n_front"] for s in levels] == HAND_FRONTS
    assert [s.attrs["level"] for s in levels] == [0, 1, 2, 3]
    assert {s.attrs["direction"] for s in levels} == {"pull"}
    pulls = [s for s in spans if s.name == "kernel.msbfs_pull"]
    assert [spans[s.parent] for s in pulls] == levels
    assert sum(s.name == "msbfs.sync" for s in spans) == depth + 1


@pytest.mark.parametrize("K", [3, 33])
@pytest.mark.parametrize("name", ["directed", "undirected"])
def test_level_spans_count_the_frontier(graphs, name, K):
    """``n_front`` of level L is the vertices some search reached at L;
    the query's ``slots`` and ``scan_share`` lie in their bounds."""
    tg = graphs[name][1]
    with profiler.recording() as rec:
        dist, depth = bfs.msbfs_kernel(tg, _sources(tg.n_vertices, K, 4))
    levels = [s for s in rec.spans if s.name == "msbfs.level"]
    assert len(levels) == depth
    for level, s in enumerate(levels):
        assert s.attrs["n_front"] == int((dist == level).any(1).sum())
    share = rec.spans[0].attrs["scan_share"]
    assert 0 < share <= 1
    assert rec.spans[0].attrs["slots"] == pytest.approx(
        share * depth * tg.n_edges * M.n_words(K))


# a numpy model of the kernel's schedule


def _mask(K: int, w: int) -> int:
    return (1 << min(32, K - 32 * w)) - 1


def _strided(f, need: int, width: int, first: int, after: int):
    """A warp (width 32) or a hub block's (width kThreads) scan: strides of
    width x loads slots (``first`` loads, then ``after``), slot s0 + width
    j + t the t-th thread's j-th; a stride's OR first, and in the covering
    stride a prefix OR in slot order, the covering slot counted as the
    threads that do not cover."""
    acc, n, s0, loads = 0, f.size, 0, first
    while s0 < n:
        step = width * loads
        tile = np.zeros(step, np.uint32)
        part = f[s0:s0 + step]
        tile[:part.size] = part
        tile = tile.reshape(loads, width)
        every = acc | int(np.bitwise_or.reduce(tile, axis=None))
        if every & need == need:
            for j in range(loads):
                p = acc | np.bitwise_or.accumulate(tile[j])
                cover = int(((p & need) == need).sum())
                if cover:
                    return every, s0 + width * j + (width - cover) + 1
                acc = int(p[-1])
        acc = every
        s0, loads = s0 + step, after
    return acc, n


def _lane(f, need: int):
    """A lane's scan: kLaneLoads slots, then kLaneLoadsAfter at a time."""
    acc, s0, loads = 0, 0, C["kLaneLoads"]
    while s0 < f.size:
        for j, x in enumerate(f[s0:s0 + loads].tolist()):
            acc |= x
            if acc & need == need:
                return acc, s0 + j + 1
        s0, loads = s0 + loads, C["kLaneLoadsAfter"]
    return acc, f.size


def model_pull(g, front, seen, K: int):
    """(next, seen, found, slots) of one level: ``front`` and ``seen``
    uint32 [V, nw]; the live searches, those with a frontier vertex."""
    off, rows = g.host["csc_offsets"], g.host["csc_rows"]
    V, nw = front.shape
    nxt, seen = np.zeros_like(front), seen.copy()
    live = np.bitwise_or.reduce(front, axis=0)
    masks = np.array([_mask(K, w) for w in range(nw)], np.uint32) & live
    todo = np.flatnonzero((~seen & masks).any(1))
    found = slots = 0
    for v in todo.tolist():
        beg, end = int(off[v]), int(off[v + 1])
        n, run = end - beg, rows[beg:end]
        for w in range(nw):
            need = int(~seen[v, w] & masks[w])
            if not need:
                continue
            f = front[run, w]
            if n <= C["kLaneRun"]:
                acc, used = _lane(f, need)
            elif n <= C["kBlockRun"]:
                acc, used = _strided(f, need, 32, C["kWarpLoads"],
                                     C["kWarpLoadsAfter"])
            else:
                acc, used = _strided(f, need, C["kThreads"],
                                     C["kBlockLoads"], C["kBlockLoads"])
            nxt[v, w] = acc & need
            seen[v, w] |= acc & need
            slots += used
        found += bool(nxt[v].any())
    return nxt, seen, found, slots


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("K", [3, 33])
@pytest.mark.parametrize("graph", ["hub", "undirected"])
def test_model_of_the_schedule_matches_the_plain_pass(graphs, hub, graph, K):
    g = hub if graph == "hub" else graphs[graph][1]
    if graph == "hub":  # runs for the lane, the warp and the hub block
        runs = np.diff(g.host["csc_offsets"])
        assert runs[0] > C["kThreads"] * C["kBlockLoads"]
        assert ((runs > C["kLaneRun"]) & (runs <= C["kBlockRun"])).any()
    sources = torch.from_numpy(_sources(g.n_vertices, K, 21)).long()
    st = M.MsbfsState.empty(g.n_vertices, K, "cpu")
    M.msbfs_start(g, sources, st)
    level = total = 0
    while st.counts[level % 2] > 0:
        want = model_pull(g, _u32(st.front), _u32(st.seen), K)
        M.msbfs_pull(g, st, level)
        total += want[3]
        np.testing.assert_array_equal(_u32(st.front), want[0])
        np.testing.assert_array_equal(_u32(st.seen), want[1])
        assert st.counts[(level + 1) % 2] == want[2]
        assert st.counts[2] == total
        bitmap = np.packbits(want[0].any(1), bitorder="little")
        np.testing.assert_array_equal(
            _u32(st.aux[(level + 1) % 3])[M.n_words(K):],
            np.pad(bitmap, (0, -bitmap.size % 4)).view(np.uint32))
        level += 1
    assert total < level * g.n_edges * M.n_words(K)  # some scan stopped early
    for k, s in enumerate(sources.tolist()[:3]):
        col = bfs.bfs_kernel(g, s, compute_predecessors=False)[0]
        assert torch.equal(st.dist[:, k], col)


def test_model_covering_slot_in_each_position():
    """The strided scans' count of the covering slot, for a bit placed at
    every slot of three strides of a warp and of a hub block, against its
    place."""
    for width, first, after in ((32, C["kWarpLoads"], C["kWarpLoadsAfter"]),
                                (C["kThreads"], 2, 2)):
        n = width * (first + 2 * after) + 5
        for at in range(0, n, 7):
            f = np.zeros(n, np.uint32)
            f[0] = 1
            f[at] |= 2
            assert _strided(f, 3, width, first, after) == (3, at + 1)
        assert _strided(np.zeros(n, np.uint32), 1, width, first,
                        after) == (0, n)


# the CPU dispatch and the source


def test_sources_and_build_list():
    """The kernel is in the build list, range-checks its indices and
    reports through gr::finish; its counters take one atomic a block each;
    the wrappers count their launches."""
    assert "msbfs" in _build.SOURCES
    assert "GR_IN_RANGE" in SOURCE and "gr::finish" in SOURCE
    body = SOURCE[SOURCE.index("__device__ void add_counts"):]
    body = body[:body.index("\n}\n")]
    assert body.count("atomicAdd(a.counts") == 2
    wrapper = Path(M.__file__).read_text()
    for name in ("msbfs_start", "msbfs_pull"):
        assert f'_build.LAUNCHES["{name}"] += 1' in wrapper
    assert set(M._SIGNATURES) == {"gr_msbfs_start", "gr_msbfs_pull"}
    assert "spmm" not in Path(bfs.__file__).read_text().split(
        "def msbfs_kernel")[1].split("\ndef ")[0]


def test_cpu_dispatch_never_loads_the_library(graphs, monkeypatch):
    def refuse(name, signatures):
        raise AssertionError(f"loaded {name} on the CPU")

    monkeypatch.setattr(_build, "load", refuse)
    tg = graphs["undirected"][1]
    before = dict(_build.LAUNCHES)
    with profiler.recording() as rec:
        dist, depth = bfs.msbfs_kernel(tg, _sources(tg.n_vertices, 32, 2))
    assert dict(_build.LAUNCHES) == before
    names = [s.name for s in rec.spans]
    assert names.count("kernel.msbfs_start") == 1
    assert names.count("kernel.msbfs_pull") == depth
    assert all(s.parent >= 0 for s in rec.spans[1:])


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_wrappers_refuse_a_wrong_state(bad):
    g = _hand_graph()
    st = M.MsbfsState.empty(6, 2, "cpu")
    if bad == "dtype":
        st.seen = st.seen.float()
    else:
        st.next = torch.zeros((6, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="seen" if bad == "dtype" else "next"):
        M.msbfs_pull(g, st, 0)
