"""The port's spans (``utils/profiler.py``), on the CPU: the off path makes
no ``record_function`` call and records nothing; a recording nests spans,
gives one query id to each outermost span and counts what its bound drops;
the search loops' level, sync, kernel and predecessor spans agree with
what the searches return, and off the card every level runs eagerly; a
span recorded under ``torch.profiler`` agrees with its twin in the
exported trace."""

import collections
import gc
import json
import types
from pathlib import Path

import pytest
import torch

from gunrock_tpu_torch.algorithms import bfs, sssp
from gunrock_tpu_torch.experimental import async_sweep
from gunrock_tpu_torch.framework import level_graphs
from gunrock_tpu_torch.graph.reorder import degree_sort
from gunrock_tpu_torch.io.generators import rmat_graph
from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels import async_sweep as async_kernels
from gunrock_tpu_torch.ops.kernels.layout import pull_layout
from gunrock_tpu_torch.ops.kernels.semiring import _BIG
from gunrock_tpu_torch.utils import profiler, timer
from gunrock_tpu_torch.utils.limits import UNREACHED

SOURCES = (0, 17, 300)


@pytest.fixture(scope="module")
def graph():
    """A degree-sorted R-MAT graph on which DO-BFS and DO-SSSP take both
    push and pull levels from source 0."""
    g, _ = degree_sort(rmat_graph(scale=10, seed=3, device="cpu"))
    pull_layout(g, unit=True)
    return g


def _bfs(g, s):
    r = bfs.run(g, s, warmup=False, device="cpu")
    return r.search_depth, r.distances


def _sssp(g, s):
    r = sssp.run(g, s, warmup=False, device="cpu")
    return r.search_depth, r.distances


def _msbfs(g, s):
    dist, depth = bfs.msbfs_kernel(g, torch.tensor([s, 5, 9]),
                                   pull_layout=pull_layout(g, unit=True))
    return depth, dist


def _async(g, s):
    dist, _, passes = async_sweep.sssp_async(g, s, n_blocks=8)
    return passes, dist


SEARCHES = {"bfs": _bfs, "sssp": _sssp, "msbfs": _msbfs, "async": _async}
# the search's outermost span and, where it has levels, their span
QUERY_SPAN = {"bfs": "bfs.run", "sssp": "sssp.run", "msbfs": "msbfs",
              "async": "async.sssp"}
LEVEL_SPAN = {"bfs": "bfs.level", "sssp": "sssp.level",
              "msbfs": "msbfs.level"}


def _raise(*args, **kwargs):
    raise AssertionError("record_function called with tracing off")


@pytest.mark.parametrize("search", sorted(SEARCHES))
def test_tracing_off_calls_no_record_function(graph, monkeypatch, search):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(profiler, "time",
                        types.SimpleNamespace(time_ns=_raise))
    assert profiler._recording is None
    assert profiler.annotate("a", x=1) is profiler.annotate("b")
    with profiler.annotate("a", x=1) as span:
        span.set(y=2)
    assert profiler.host_read("bfs", torch.tensor([3, 4])) == [3, 4]
    SEARCHES[search](graph, 0)


def test_recording_nests_spans_and_gives_one_query_id_each():
    with profiler.recording() as rec:
        with profiler.annotate("q", sources=1) as q:
            with profiler.annotate("q.level", level=0):
                with profiler.annotate("q.sync"):
                    pass
            q.set(depth=1)
        with profiler.annotate("q"):
            pass
        with pytest.raises(RuntimeError, match="already on"):
            with profiler.recording():
                pass
    names = [s.name for s in rec.spans]
    assert names == ["q", "q.level", "q.sync", "q"]
    assert [s.parent for s in rec.spans] == [-1, 0, 1, -1]
    assert [s.query for s in rec.spans] == [0, 0, 0, 1]
    assert rec.spans[0].attrs == {"sources": 1, "depth": 1}
    for s in rec.spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    with profiler.annotate("after"):  # recording is off again
        pass
    assert len(rec.spans) == 4


def test_recording_adds_no_object_the_collector_tracks():
    """A recording keeps its spans column by column: thousands of spans
    leave the garbage collector's object count where it was, so recording
    triggers no collection of its own."""
    with profiler.recording() as rec:
        gc.collect()
        before = len(gc.get_objects())
        for i in range(5000):
            with profiler.annotate("level", level=i, direction="push"):
                with profiler.annotate("kernel"):
                    pass
        after = len(gc.get_objects())
    assert len(rec) == 10_000 and after - before < 100
    assert rec.spans[-2].attrs == {"level": 4999, "direction": "push"}


def test_recording_bound_counts_dropped_spans():
    with profiler.recording(limit=3) as rec:
        for _ in range(2):
            with profiler.annotate("outer"):
                with profiler.annotate("inner"):
                    with profiler.annotate("innermost"):
                        pass
    assert [s.name for s in rec.spans] == ["outer", "inner", "innermost"]
    assert rec.dropped == 3 and all(s.end_ns for s in rec.spans)
    assert rec._open == []


def _recorded(graph, search, s):
    with profiler.recording() as rec:
        passes, dist = SEARCHES[search](graph, s)
    return rec.spans, passes, dist


@pytest.mark.parametrize("s", SOURCES)
@pytest.mark.parametrize("search", sorted(SEARCHES))
def test_one_query_id_a_search_and_levels_match_depth(graph, search, s):
    spans, depth, _ = _recorded(graph, search, s)
    assert spans[0].name == QUERY_SPAN[search] and spans[0].parent == -1
    assert spans[0].attrs["sources"] == (3 if search == "msbfs" else 1)
    assert {x.query for x in spans} == {spans[0].query}
    assert all(x.parent >= 0 for x in spans[1:])
    if search == "async":
        count = collections.Counter(x.name for x in spans)
        assert count["kernel.gs_sweep_min"] == 1 and count["async.sssp"] == 1
        return
    levels = [x for x in spans if x.name == LEVEL_SPAN[search]]
    assert len(levels) == depth
    assert [x.attrs["level"] for x in levels] == list(range(depth))
    if search == "msbfs":
        return
    search_span = next(x for x in spans if x.name.endswith(".search"))
    assert all(spans[x.parent] is search_span for x in levels)
    push = sum(x.attrs["direction"] == "push" for x in levels)
    pull = sum(x.attrs["direction"] in ("pull", "pull_dense", "step")
               for x in levels)
    assert push + pull == depth
    if s == 0:  # the hub: both directions
        assert push and pull
    pred = [x for x in spans if x.name == f"{search}.predecessors"]
    assert len(pred) == 1 and spans[pred[0].parent].name == f"{search}.run"


@pytest.mark.parametrize("s", SOURCES)
@pytest.mark.parametrize("search", ["bfs", "sssp"])
def test_cpu_levels_run_eagerly(graph, monkeypatch, search, s):
    """Off the card no level is captured or replayed: every level span
    says ``graph="eager"``, the level graph counters stay at zero and the
    layouts hold no level graphs."""
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())
    spans, depth, _ = _recorded(graph, search, s)
    levels = [x for x in spans if x.name == LEVEL_SPAN[search]]
    assert len(levels) == depth
    assert {x.attrs["graph"] for x in levels} == {"eager"}
    assert _build.LAUNCHES["level_graph_capture"] == 0
    assert _build.LAUNCHES["level_graph_replay"] == 0
    for layout in (pull_layout(graph, unit=True),
                   pull_layout(graph, pad_value=_BIG)):
        assert id(layout) not in level_graphs.TABLES


@pytest.mark.parametrize("s", SOURCES)
def test_bfs_level_sizes_are_the_distances_layers(graph, s):
    spans, depth, dist = _recorded(graph, "bfs", s)
    deg = graph.out_degrees()
    levels = [x for x in spans if x.name == "bfs.level"]
    for k, x in enumerate(levels):
        layer = dist == k
        assert x.attrs["n_front"] == int(layer.sum())
        assert x.attrs["out_edges"] == int(deg[layer].sum())
    assert int((dist == depth).sum()) == 0
    assert int((dist != UNREACHED).sum()) == sum(x.attrs["n_front"]
                                                 for x in levels)


@pytest.mark.parametrize("search", ["bfs", "sssp", "msbfs"])
def test_sync_spans_count_the_host_reads(graph, monkeypatch, search):
    """Every read of a tensor to the host (``tolist``, ``bool``) the search
    makes is one ``*.sync`` span: the level reads and the read of the
    empty frontier (the CPU's Timer waits for nothing)."""
    reads = collections.Counter()

    def counted(name):
        real = getattr(torch.Tensor, name)

        def read(self, *args):
            reads[name] += 1
            return real(self, *args)
        return read

    for name in ("tolist", "__bool__", "item"):
        monkeypatch.setattr(torch.Tensor, name, counted(name))
    spans, depth, _ = _recorded(graph, search, 0)
    syncs = [x for x in spans if x.name.endswith(".sync")]
    assert len(syncs) == sum(reads.values()) == depth + 1
    assert {x.name for x in syncs} == {f"{search}.sync"}


def test_async_sweep_reads_its_counts_once(monkeypatch):
    """The card path's one read of the kernel's counts (``_launched``,
    given a CPU tensor for the kernel's output) is one ``async.sync``."""
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())
    monkeypatch.setattr(async_kernels, "LAST_RUN", {})
    out = torch.tensor([3, 40, 41, 132, 1])
    with profiler.recording() as rec:
        with profiler.annotate("kernel.gs_sweep_min"):
            assert async_kernels._launched(0, "gs_sweep_min", out) == (3, 40)
    assert [x.name for x in rec.spans] == ["kernel.gs_sweep_min",
                                           "async.sync"]
    assert async_kernels.LAST_RUN["gs_sweep_min"]["grid_barriers"] == 41
    assert _build.LAUNCHES["gs_sweep_min"] == 1


def test_timer_waits_through_host_read(monkeypatch):
    class Event:
        def __init__(self, enable_timing=False):
            self.synced = 0

        def record(self):
            pass

        def synchronize(self):
            self.synced += 1

        def elapsed_time(self, other):
            return 2.5

    monkeypatch.setattr(torch.cuda, "Event", Event)
    t = timer.Timer("cuda")
    with profiler.recording() as rec:
        t.begin()
        assert t.end() == 2.5
    assert [x.name for x in rec.spans] == ["timer.sync"]
    with profiler.recording() as rec:
        t = timer.Timer("cpu")
        t.begin()
        t.end()
    assert rec.spans == []


def test_spans_agree_with_their_trace_twins(graph, tmp_path):
    """Under a CPU ``torch.profiler``, each recorded span's start and end
    on ``time.time_ns()`` come after its ``user_annotation``'s in the
    exported trace (``baseTimeNanoseconds`` + ``ts``; the span's stamps are
    taken after ``record_function`` is entered and after it is left), and
    the spans' median gap is under 50 us: the two clocks agree. A single
    span's gap is the time ``record_function`` takes to enter, which a
    loaded host can stretch."""
    from torch.profiler import ProfilerActivity, profile

    with profiler.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiler.annotate("warm"):  # the profiler's first span
                pass
            bfs.run(graph, 0, warmup=False, device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(Path(path).read_text())
    base = int(data["baseTimeNanoseconds"])
    twins = collections.defaultdict(list)
    for e in data["traceEvents"]:
        if e.get("cat") == "user_annotation":
            start = base + round(float(e["ts"]) * 1e3)
            end = start + round(float(e["dur"]) * 1e3)
            twins[e["name"]].append((start, end))
    seen = collections.Counter()
    gaps = []
    for x in rec.spans[1:]:
        start, end = sorted(twins[x.name])[seen[x.name]]
        seen[x.name] += 1
        gaps.append((x.start_ns - start, x.end_ns - end))
    assert len(gaps) >= 10
    assert all(d0 >= 0 and d1 >= 0 for d0, d1 in gaps), gaps
    assert sorted(max(g) for g in gaps)[len(gaps) // 2] < 50_000, gaps
