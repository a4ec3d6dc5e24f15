"""Measured per-kernel device time from a ``torch.profiler`` trace.

Counterpart of ``gunrock_tpu/utils/trace_stats.py``, which reads the
xprof XPlane of a ``jax.profiler`` trace; here the chrome trace that
``utils.profiler.trace`` writes. Device-side events are the kernels,
copies and fills the card ran (categories ``kernel``, ``gpu_memcpy``,
``gpu_memset``); a trace with none (a CPU run) falls back to the host's
operator events (``cpu_op``), as the JAX version falls back to its host
plane. Bytes are not in the trace: joined with ``utils.roofline``'s byte
model they give a measured rate.

``device_profile`` times one warm call under the profiler and reports the
card's busy time and idle share.
"""

from __future__ import annotations

import glob
import json
import os
import time

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def latest_trace_file(log_dir: str) -> str | None:
    """The newest ``*.pt.trace.json`` under ``log_dir``."""
    hits = sorted(
        glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json"),
                  recursive=True),
        key=os.path.getmtime,
    )
    return hits[-1] if hits else None


def _events(path: str) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and e.get("dur", 0) > 0]


def _is_device(ev: dict) -> bool:
    return str(ev.get("cat", "")).lower() in _DEVICE_CATS


def device_busy_ms(log_dir: str) -> float | None:
    """Summed time of the device-side events of the newest trace in
    ``log_dir`` (one stream, so no overlap); None where it has none."""
    path = latest_trace_file(log_dir)
    events = [e for e in _events(path) if _is_device(e)] if path else []
    return sum(float(e["dur"]) for e in events) / 1e3 if events else None


def device_op_stats(log_dir: str, top: int = 15) -> list[dict]:
    """Per-op time from the newest trace in ``log_dir``: rows {name,
    occurrences, total_ms, avg_us} sorted by total_ms, largest first, from
    the device-side events, or from the host's operators where the trace
    has no device events."""
    path = latest_trace_file(log_dir)
    if path is None:
        return []
    events = _events(path)
    chosen = [e for e in events if _is_device(e)]
    if not chosen:
        chosen = [e for e in events if str(e.get("cat", "")).lower() == "cpu_op"]
    agg: dict[str, list[float]] = {}
    for ev in chosen:
        cur = agg.setdefault(ev["name"], [0, 0.0])
        cur[0] += 1
        cur[1] += float(ev["dur"])  # microseconds
    rows = [
        {"name": k[:120], "occurrences": int(n), "total_ms": us / 1e3,
         "avg_us": us / n}
        for k, (n, us) in agg.items()
    ]
    rows.sort(key=lambda r: -r["total_ms"])
    return rows[:top]


def measured_kernel_table(log_dir: str, model_bytes_total: float | None,
                          top: int = 10) -> dict:
    """Top ops by measured time, their summed time, and the measured rate
    of the whole pass when the roofline model's byte count is given."""
    rows = device_op_stats(log_dir, top=top)
    total_ms = sum(r["total_ms"] for r in rows)
    out = {"trace_top_ops": rows, "trace_device_ms": total_ms}
    if model_bytes_total and total_ms > 0:
        out["gbps_measured"] = model_bytes_total / (total_ms / 1e3) / 1e9
    return out


def device_profile(fn) -> dict:
    """One warm call of ``fn`` under torch.profiler on the card: wall time,
    the card's busy time (the sum of the device-side events' times:
    kernels, copies, fills; one stream, so no overlap) and its idle share,
    and the kernels that took the most device time. Host-side ops
    (``aten::*``) carry their kernels' device time as well and are left
    out, so nothing is counted twice. The profiler adds host time, so the
    idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0.0)

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in events)
    if busy_us == 0:
        return {"wall_us": wall_us, "device": "not measured"}
    top = sorted(events, key=dev_us, reverse=True)[:6]
    return {"wall_us": wall_us, "busy_us": busy_us,
            "idle_share": 1 - busy_us / wall_us,
            "top_us": {e.key[:60]: [dev_us(e), e.count] for e in top}}
