"""Reduction of a ``torch.profiler`` chrome trace to the traced window's
device numbers.

Device-side events are the kernels, copies and fills the card ran
(categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``), the same choice
as the port's ``utils/trace_stats.device_profile``. Busy time is the
length of the union of their intervals, so overlapping streams are not
counted twice. An idle gap is a stretch between two device events; it is
named by the innermost host operator (``cpu_op``) running at its middle,
or ``host (no operator)`` where none is.
"""

from __future__ import annotations

import bisect
import dataclasses
import json

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_NO_OP = "host (no operator)"


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    n_device_ops: int
    device_ops: list  # [[name, seconds], ...], most time first
    idle_gaps: list  # [[host op, seconds], ...], most idle time first


def read_trace(path: str, top: int = 10) -> TraceSummary:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        if cat in _DEVICE_CATS:
            dev.append((float(e["ts"]), float(e.get("dur", 0.0)), e["name"]))
        elif cat == "cpu_op":
            host.append((float(e["ts"]), float(e.get("dur", 0.0)), e["name"]))
    return summarize(dev, host, top)


def summarize(dev: list, host: list, top: int = 10) -> TraceSummary:
    """``dev`` and ``host``: (start us, duration us, name) tuples."""
    dev.sort()
    by_name: dict[str, float] = {}
    for _, dur, name in dev:
        by_name[name] = by_name.get(name, 0.0) + dur
    busy = 0.0
    gaps = []
    end = None
    for ts, dur, _ in dev:
        if end is None:
            busy, end = dur, ts + dur
        elif ts > end:
            gaps.append((end, ts))
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    host.sort()
    starts = [h[0] for h in host]
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        name = _host_op_at(host, starts, (g0 + g1) / 2)
        idle[name] = idle.get(name, 0.0) + (g1 - g0)
    return TraceSummary(
        busy_s=busy / 1e6,
        n_device_ops=len(dev),
        device_ops=_top(by_name, top),
        idle_gaps=_top(idle, top),
    )


def _host_op_at(host: list, starts: list, t: float, look_back: int = 256):
    """The innermost host operator running at ``t``: of those that started
    before ``t`` and end after it, the one that started last."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look_back, -1), -1):
        ts, dur, name = host[j]
        if ts + dur >= t:
            return name
    return _NO_OP


def _top(by_name: dict, top: int) -> list:
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], us / 1e6] for name, us in rows]
