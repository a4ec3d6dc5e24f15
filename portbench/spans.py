"""The port's own spans joined with a ``torch.profiler`` trace: where the
device time and the device's idle time of a traced window go, by the
port's layers.

    python3 portbench/spans.py --workload <cell> --seed <n> [--seconds 3]

runs one cell as ``run.py --trace 1`` does, with the port's span recording
(``gunrock_tpu_torch/utils/profiler.recording``) on from before set-up,
and prints one JSON object: the span readings (``metrics``), the
breakdown (``idle_spans``, ``device_spans``, ``levels``) and the checks of
the join (``checks``). ``run.py`` does not call it: it reads what a
later benchmark change would report.

The join (:func:`join`). Recorded spans carry ``time.time_ns()`` stamps,
the clock of the trace's host events (``baseTimeNanoseconds`` + ``ts``).
A device event (kernel, copy, fill) goes to the innermost port span open
when the host launched it: the launching CUDA API call is found
by the trace's ``correlation`` id. A device event with no launching call
in the trace goes to the innermost ``gpu_user_annotation`` range (the
profiler's device-side copy of a span) around it; one with neither is
``unattributed``. An idle gap between device events goes to the innermost
port span open at its middle, or to ``outside the port``. Busy time and
gaps are the arithmetic of ``profile.summarize``.
"""

from __future__ import annotations

import bisect
import collections
import json

OUTSIDE = "outside the port"
UNATTRIBUTED = "unattributed"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# a query of each entry point, and the part of it that is the search loop
QUERY_SPANS = ("bfs.run", "sssp.run", "msbfs", "async.sssp")
LOOP_SPANS = ("bfs.search", "sssp.search", "msbfs")
LEVEL_SPANS = ("bfs.level", "sssp.level", "msbfs.level")


class _Index:
    """The innermost recorded span open at a time on the trace's clock."""

    def __init__(self, spans, base_ns: int):
        self.spans = spans
        self.start = [(s.start_ns - base_ns) / 1e3 for s in spans]
        self.end = [(s.end_ns - base_ns) / 1e3 if s.end_ns else float("inf")
                    for s in spans]

    def at(self, t_us: float) -> int:
        """The index of the innermost span open at ``t_us``, or -1. Spans
        nest, so it is the nearest ancestor of the last span started by
        then that is still open."""
        i = bisect.bisect_right(self.start, t_us) - 1
        while i >= 0 and self.end[i] < t_us:
            i = self.spans[i].parent
        return i

    def ancestor(self, i: int, names) -> int:
        while i >= 0 and self.spans[i].name not in names:
            i = self.spans[i].parent
        return i


def _events(path: str):
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    if not isinstance(data, dict) or "baseTimeNanoseconds" not in data:
        raise ValueError(f"{path}: no baseTimeNanoseconds, so no clock to "
                         "join the spans on")
    return events, int(data["baseTimeNanoseconds"])


def _pairs(spans, twins):
    """(span, twin (start us, end us)): the k-th span of a name with the
    k-th ``user_annotation`` of that name."""
    seen = collections.Counter()
    for s in spans:
        k = seen[s.name]
        seen[s.name] += 1
        if k < len(twins.get(s.name, ())):
            yield s, twins[s.name][k]


def _gaps(dev: list) -> tuple[float, list]:
    """(busy us, [(gap start, gap end)]) of sorted (ts, dur) intervals: the
    arithmetic of ``profile.summarize``."""
    busy, end, gaps = 0.0, None, []
    for ts, dur in dev:
        if end is None:
            busy, end = dur, ts + dur
        elif ts > end:
            gaps.append((end, ts))
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    return busy, gaps


def _overlap(a0, a1, b0, b1) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def join(path: str, spans: list, window: int, top: int = 12) -> dict:
    """The breakdown and readings of a trace at ``path`` against the
    recorded ``spans`` (objects with ``name``, ``start_ns``, ``end_ns``,
    ``parent``, ``query``, ``attrs``; ``parent`` indexes ``spans``).
    ``window`` is the index in ``spans`` of the first span recorded under
    the profiler: the queries counted are the outermost query spans from
    there on."""
    events, base = _events(path)
    dev, launches, twins, gpu_ann = [], {}, collections.defaultdict(list), []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in _DEVICE_CATS:
            dev.append((ts, dur, e["name"], corr))
        elif cat in _LAUNCH_CATS and corr is not None:
            launches[corr] = ts
        elif cat == "user_annotation":
            twins[e["name"]].append((ts, ts + dur))
        elif cat == "gpu_user_annotation":
            gpu_ann.append((ts, ts + dur, e["name"]))
    for v in twins.values():
        v.sort()
    traced = spans[window:]
    idx = _Index(spans, base)
    dev.sort()

    # device events: the span that launched each
    gpu_ann.sort()
    ann_starts = [a[0] for a in gpu_ann]
    owner = []  # per device event: span index, -1 outside, a name, None
    by_corr = by_ann = 0
    for ts, dur, _, corr in dev:
        t = launches.get(corr)
        if t is not None:
            owner.append(idx.at(t))
            by_corr += 1
            continue
        mid = ts + dur / 2
        j = bisect.bisect_right(ann_starts, mid)
        inside = [a for a in gpu_ann[max(0, j - 64):j] if mid <= a[1]]
        if inside:
            owner.append(min(inside, key=lambda a: a[1] - a[0])[2])
            by_ann += 1
        else:
            owner.append(None)
    device_spans = collections.Counter()
    for (_, dur, _, _), o in zip(dev, owner):
        device_spans[_name(spans, o)] += dur

    busy, gaps = _gaps([(d[0], d[1]) for d in dev])
    idle_spans = collections.Counter()
    for g0, g1 in gaps:
        idle_spans[_name(spans, idx.at((g0 + g1) / 2))] += g1 - g0

    queries = [i for i in range(window, len(spans))
               if spans[i].parent == -1 and spans[i].name in QUERY_SPANS]
    qids = {spans[i].query for i in queries}
    in_window = [s for s in traced if s.query in qids]
    n_q = len(queries) or None

    def per_query(x):
        return x / n_q if n_q else None

    loops = [s for s in in_window if s.name in LOOP_SPANS]
    loop_idle = _clipped(gaps, loops, base)
    pred = sum(dur for (_, dur, _, _), o in zip(dev, owner)
               if isinstance(o, int) and o >= 0
               and idx.ancestor(o, ("bfs.predecessors",
                                    "sssp.predecessors")) >= 0)
    levels = _levels(spans, in_window, dev, owner, gaps, idx, base)
    level_spans = [s for s in in_window if s.name in LEVEL_SPANS]
    setup = spans[:window]
    metrics = {
        "host_syncs_per_query": per_query(
            sum(s.name.endswith(".sync") for s in in_window)),
        "pull_levels_per_query": per_query(
            sum(s.attrs.get("direction") != "push" for s in level_spans
                if s.name != "msbfs.level")),
        "loop_idle_ms_per_query": per_query(loop_idle / 1e3),
        "predecessors_ms_per_query": per_query(pred / 1e3),
        "build_span_s": _outermost_s(setup, spans, "graph."),
        "layout_span_s": _outermost_s(setup, spans, "layout."),
    }
    # each span against its user_annotation twin: the gap, and whether
    # the twin's stamps come first (the span's are taken after
    # record_function is entered and after it is left)
    twin_gaps, twin_first = [], 0
    for s, (t0, t1) in _pairs(traced, twins):
        d0, d1 = s.start_ns - (base + t0 * 1e3), s.end_ns - (base + t1 * 1e3)
        twin_gaps.append(max(abs(d0), abs(d1)) / 1e3)
        twin_first += d0 >= 0 and d1 >= 0
    twin_gaps.sort()
    total_dev = sum(d[1] for d in dev)
    named = sum(v for k, v in device_spans.items()
                if k not in (OUTSIDE, UNATTRIBUTED))
    return {
        "metrics": metrics,
        "breakdown": {
            "idle_spans": _top(idle_spans, top),
            "device_spans": _top(device_spans, top),
            "levels": levels,
        },
        "checks": {
            "queries": len(queries),
            "level_spans_per_query": per_query(len(level_spans)),
            "push_levels_per_query": per_query(
                sum(s.attrs.get("direction") == "push" for s in level_spans)),
            "busy_s": busy / 1e6,
            "idle_s": sum(g1 - g0 for g0, g1 in gaps) / 1e6,
            "device_named_share": named / total_dev if total_dev else None,
            "attributed_by_correlation": by_corr,
            "attributed_by_gpu_user_annotation": by_ann,
            "unattributed": len(dev) - by_corr - by_ann,
            "twins_matched": len(twin_gaps),
            "spans_traced": len(traced),
            "twins_first": twin_first,
            "twin_gap_us_p50": _quantile(twin_gaps, 0.5),
            "twin_gap_us_p99": _quantile(twin_gaps, 0.99),
            "twin_gap_us_max": _quantile(twin_gaps, 1.0),
        },
    }


def _quantile(ordered: list, q: float):
    return ordered[round(q * (len(ordered) - 1))] if ordered else None


def _name(spans, o) -> str:
    if o is None:
        return UNATTRIBUTED
    if isinstance(o, str):  # a gpu_user_annotation's name
        return o
    return spans[o].name if o >= 0 else OUTSIDE


def _clipped(gaps, within, base) -> float:
    """Idle microseconds of ``gaps`` inside the spans ``within``, which
    do not overlap one another."""
    out = 0.0
    ivs = sorted(((s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3)
                 for s in within)
    starts = [a for a, _ in ivs]
    for g0, g1 in gaps:
        k = bisect.bisect_right(starts, g1) - 1
        while k >= 0 and ivs[k][1] > g0:
            out += _overlap(g0, g1, *ivs[k])
            k -= 1
    return out


def _levels(spans, in_window, dev, owner, gaps, idx, base) -> dict:
    """Per direction of ``*.level`` spans: the level count, mean frontier
    size and out-edges (where the loop holds them), device ms a level
    (device events launched inside the level) and idle ms a level (idle
    inside the level spans)."""
    pos = {id(s): i for i, s in enumerate(spans)}
    rows: dict = {}
    level_of = {}
    for s in in_window:
        if s.name in LEVEL_SPANS:
            key = f"{s.name.split('.')[0]}.{s.attrs.get('direction')}"
            row = rows.setdefault(key, {"levels": 0, "n_front": [],
                                        "out_edges": [], "device_us": 0.0,
                                        "spans": []})
            row["levels"] += 1
            for k in ("n_front", "out_edges"):
                if k in s.attrs:
                    row[k].append(s.attrs[k])
            row["spans"].append(s)
            level_of[pos[id(s)]] = key
    for (_, dur, _, _), o in zip(dev, owner):
        if isinstance(o, int) and o >= 0:
            lv = idx.ancestor(o, LEVEL_SPANS)
            if lv in level_of:
                rows[level_of[lv]]["device_us"] += dur
    out = {}
    for key, row in sorted(rows.items()):
        n = row["levels"]
        idle = _clipped(gaps, row["spans"], base)
        out[key] = {
            "levels": n,
            "mean_n_front": (sum(row["n_front"]) / len(row["n_front"])
                             if row["n_front"] else None),
            "mean_out_edges": (sum(row["out_edges"]) / len(row["out_edges"])
                               if row["out_edges"] else None),
            "device_ms_per_level": row["device_us"] / 1e3 / n,
            "idle_ms_per_level": idle / 1e3 / n,
        }
    return out


def _outermost_s(setup, spans, prefix: str):
    """Seconds in the set-up spans named ``prefix...`` that no such span
    encloses; None where there is none."""
    total, found = 0, False
    for s in setup:
        if not s.name.startswith(prefix):
            continue
        p = s.parent
        while p >= 0 and not spans[p].name.startswith(prefix):
            p = spans[p].parent
        if p < 0:
            total += s.end_ns - s.start_ns
            found = True
    return total / 1e9 if found else None


def _top(counter, top: int) -> list:
    rows = sorted(counter.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], us / 1e6] for name, us in rows]


def measure(cell, seconds: float):
    """Set-up and a traced window of ``cell`` with the port's recording on:
    (the :func:`join` of the window's trace, with the window's queries and
    passes under ``checks``; the sampler of its answers)."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from gunrock_tpu_torch.utils import profiler

    activities = [ProfilerActivity.CPU]
    if cell.cuda:
        activities.append(ProfilerActivity.CUDA)
    with profiler.recording() as rec:
        cell.setup()
        window = len(rec)
        with profile(activities=activities) as prof:
            queries, window_s, sampler = cell.window(seconds)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        out = join(path, rec.spans, window)
    out["checks"].update(
        window_queries=len(queries), window_s=window_s,
        passes_per_query=sum(q.passes for q in queries) / max(1, len(queries)),
        dropped=rec.dropped, spans_recorded=len(rec))
    return out, sampler


def main(argv=None) -> int:
    import argparse
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch

    from gunrock_tpu_torch.utils import profiler
    from portbench import check
    from portbench.cell import Cell

    if not hasattr(profiler, "recording"):
        print("spans: this port records no spans", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("spans: needs a CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload, args.seed, "cuda")
    out, sampler = measure(cell, args.seconds)
    cell.release()
    ok, _ = check.judge(cell.verify(sampler.answers()), cell.limits)
    out["checks"]["correct"] = bool(ok and cell.failed == 0
                                    and out["checks"]["window_queries"])
    out.update(workload=args.workload, seed=args.seed,
               device=torch.cuda.get_device_name(0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
