"""The join of the port's spans with a trace (``portbench/spans.py``): on a
synthetic trace with hand-placed spans, device events and gaps, and on the
card over each cell at a small size."""

import dataclasses
import json

import pytest

from conftest import small_configs
from portbench import manifest, profile, spans
from portbench.cell import Cell

BASE = 1_000_000_000_000  # the trace's baseTimeNanoseconds


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int
    parent: int
    query: int
    attrs: dict


def _span(name, t0_us, t1_us, parent, query, **attrs):
    return Span(name, BASE + int(t0_us * 1e3), BASE + int(t1_us * 1e3),
                parent, query, attrs)


# set-up: a graph build inside a relabeling, then a layout build; then
# one BFS query over [100, 200) us: two levels, a read before each and one
# after, the predecessor pass
SPANS = [
    _span("graph.degree_sort", 0, 30, -1, 0),
    _span("graph.build", 5, 20, 0, 0),
    _span("layout.pull", 40, 60, -1, 1),
    _span("layout.sort", 41, 50, 2, 1),
    _span("bfs.run", 100, 200, -1, 2, sources=1),          # 4
    _span("bfs.search", 101, 170, 4, 2),                   # 5
    _span("bfs.sync", 102, 110, 5, 2),                     # 6
    _span("bfs.level", 111, 130, 5, 2, level=0, direction="push",
          n_front=1, out_edges=10),                        # 7
    _span("kernel.bfs_push_step", 112, 120, 7, 2),         # 8
    _span("bfs.sync", 131, 140, 5, 2),                     # 9
    _span("bfs.level", 141, 160, 5, 2, level=1, direction="pull",
          n_front=10, out_edges=90),                       # 10
    _span("bfs.sync", 161, 168, 5, 2),                     # 11
    _span("bfs.predecessors", 171, 195, 4, 2),             # 12
]
WINDOW = 4


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    # launches on the host, device events on the card, joined by correlation
    _x("cuda_runtime", "cudaLaunchKernel", 103, 1, 1),   # in the read
    _x("kernel", "reduce_sum", 104, 2, 1),               # [104, 106)
    _x("cuda_runtime", "cudaLaunchKernel", 115, 1, 2),   # in the push kernel
    _x("kernel", "push_step", 118, 6, 2),                # [118, 124)
    _x("cuda_runtime", "cudaLaunchKernel", 145, 1, 3),   # in the pull level
    _x("kernel", "span_pass", 146, 10, 3),               # [146, 156)
    _x("cuda_driver", "cuLaunchKernel", 175, 1, 4),      # in predecessors
    _x("kernel", "scatter_min", 176, 20, 4),             # [176, 196)
    _x("cuda_runtime", "cudaMemcpyAsync", 250, 1, 5),    # outside the port
    _x("gpu_memcpy", "Memcpy DtoH", 251, 1, 5),          # [251, 252)
    # no launch in the trace: the device-side annotation names it
    _x("gpu_user_annotation", "bfs.predecessors", 196, 4),
    _x("kernel", "from_the_so", 197, 2, 99),             # [197, 199)
    _x("kernel", "nobody", 300, 1, 98),                  # [300, 301)
    # host operators and twins
    _x("cpu_op", "aten::sum", 102, 3),
    _x("user_annotation", "bfs.run", 100.01, 99.98),
    _x("user_annotation", "bfs.search", 101.02, 68.97),
    {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": BASE,
                                "traceEvents": EVENTS}))
    return str(path)


def test_device_events_go_to_the_span_that_launched_them(trace):
    out = spans.join(trace, SPANS, WINDOW)
    dev = dict(out["breakdown"]["device_spans"])
    assert dev == pytest.approx({
        "bfs.sync": 2e-6, "kernel.bfs_push_step": 6e-6, "bfs.level": 10e-6,
        "bfs.predecessors": 22e-6, spans.OUTSIDE: 1e-6,
        spans.UNATTRIBUTED: 1e-6})
    c = out["checks"]
    assert (c["attributed_by_correlation"],
            c["attributed_by_gpu_user_annotation"],
            c["unattributed"]) == (5, 1, 1)


def test_idle_gaps_go_to_the_span_open_at_their_middle(trace):
    out = spans.join(trace, SPANS, WINDOW)
    idle = dict(out["breakdown"]["idle_spans"])
    # gaps: [106, 118) mid 112 in the kernel span (which opens at 112, the
    # innermost), [124, 146) mid 135 and [156, 176) mid 166 in the reads,
    # [196, 197) in the query, [199, 251) and [252, 300) outside
    assert idle == pytest.approx({
        "kernel.bfs_push_step": 12e-6, "bfs.sync": 42e-6, "bfs.run": 1e-6,
        spans.OUTSIDE: 100e-6})
    m = out["metrics"]
    # idle inside bfs.search [101, 170): 12 + 22 + 14 (the third gap
    # clipped at 170)
    assert m["loop_idle_ms_per_query"] == pytest.approx(48e-3)
    assert m["predecessors_ms_per_query"] == pytest.approx(20e-3)
    assert m["host_syncs_per_query"] == 3
    assert m["pull_levels_per_query"] == 1
    assert m["build_span_s"] == pytest.approx(30e-6)
    assert m["layout_span_s"] == pytest.approx(20e-6)


def test_levels_by_direction(trace):
    levels = spans.join(trace, SPANS, WINDOW)["breakdown"]["levels"]
    assert set(levels) == {"bfs.push", "bfs.pull"}
    push, pull = levels["bfs.push"], levels["bfs.pull"]
    assert (push["levels"], push["mean_n_front"],
            push["mean_out_edges"]) == (1, 1, 10)
    assert push["device_ms_per_level"] == pytest.approx(6e-3)
    # idle inside [111, 130): [111, 118) and [124, 130)
    assert push["idle_ms_per_level"] == pytest.approx(13e-3)
    assert pull["device_ms_per_level"] == pytest.approx(10e-3)
    # idle inside [141, 160): [141, 146) and [156, 160)
    assert pull["idle_ms_per_level"] == pytest.approx(9e-3)


def test_twins_and_the_trace_clock(trace, tmp_path):
    out = spans.join(trace, SPANS, WINDOW)
    c = out["checks"]
    assert c["twins_matched"] == 2
    assert c["twin_gap_us_max"] == pytest.approx(0.02, abs=2e-3)
    assert c["twins_first"] == 0  # the twins here start after their spans
    assert c["queries"] == 1 and c["level_spans_per_query"] == 2
    # without the trace's base time there is no clock to join on
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"traceEvents": EVENTS}))
    with pytest.raises(ValueError, match="baseTimeNanoseconds"):
        spans.join(str(bare), SPANS, WINDOW)


def test_busy_and_idle_agree_with_read_trace(trace):
    """The join's busy time and gaps are ``read_trace``'s, whose outputs
    the join leaves as they are."""
    before = profile.read_trace(trace)
    out = spans.join(trace, SPANS, WINDOW)
    after = profile.read_trace(trace)
    assert before == after
    assert out["checks"]["busy_s"] == pytest.approx(before.busy_s)
    assert out["checks"]["idle_s"] == pytest.approx(
        sum(s for _, s in before.idle_gaps))


CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_spans_of_each_cell_on_the_card(card, cell):
    """Query spans are the window's queries; level spans a query are the
    passes the entry returned (push and pull levels together for the
    single-source searches); the sweep reads the card once a search;
    the spans' stamps agree with their trace twins."""
    c = Cell(cell, 2**31 + 11, card, config=small_configs()[cell])
    out, _ = spans.measure(c, 0.5)
    k = out["checks"]
    assert k["dropped"] == 0 and k["queries"] == k["window_queries"] > 0
    if cell.endswith("sssp-async"):
        assert out["metrics"]["host_syncs_per_query"] == 1
    else:
        assert (k["level_spans_per_query"]
                == pytest.approx(k["passes_per_query"]))
    if cell.endswith((".bfs", ".sssp")):
        assert (k["push_levels_per_query"]
                + out["metrics"]["pull_levels_per_query"]
                == pytest.approx(k["passes_per_query"]))
    # the clocks agree: each twin is stamped before its span's own stamps
    # (taken after record_function is entered and after it is left), and
    # most within a few microseconds; record_function's own entry sets the
    # tail (PERF.md)
    assert k["twins_first"] == k["twins_matched"] == k["spans_traced"]
    assert k["twin_gap_us_p99"] < 50
    assert k["unattributed"] == 0 and k["attributed_by_correlation"] > 0
