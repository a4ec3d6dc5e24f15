"""Performance-stats JSON export (counterpart of
``gunrock_tpu/utils/performance.py``).

The reference's measurement contract, ``util::stats::
export_performance_stats`` (schema "2022-10-28"): engine, primitive and
graph stats, per-run process times with avg/stdev/min/max, per-run MTEPS
(= edges_visited / time_ms / 1000), search depths, sources, tags, the
command line, git SHA, and device and system info. The keys are the JAX
package's; the engine is ``gunrock_tpu_torch``, the compiler "torch/CUDA"
with the torch and CUDA versions, and ``gpuinfo`` comes from
``device.properties``: the device's name, platform, count and power limit.

Default filename: ``<primitive>_<dataset>_<timestamp>.json``.
"""

from __future__ import annotations

import datetime
import json
import os
import platform
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from gunrock_tpu_torch.device.properties import get_device_properties

SCHEMA_VERSION = "2022-10-28"
ENGINE = "gunrock_tpu_torch"


def _git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)), timeout=5,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _device_info(device) -> dict:
    props = get_device_properties(device)
    return {
        "name": props.name,
        "platform": props.platform,
        "num_devices": props.num_devices,
        "power_limit": props.power_limit,
    }


def _sysinfo() -> dict:
    u = platform.uname()
    return {
        "sysname": u.system,
        "release": u.release,
        "version": u.version,
        "machine": u.machine,
        "nodename": u.node,
    }


def _stats(values):
    if not values:
        return 0.0, 0.0, 0.0, 0.0
    a = np.asarray(values, dtype=float)
    return float(a.mean()), float(a.std()), float(a.min()), float(a.max())


def export_performance_stats(
    primitive: str,
    process_times_ms: list[float],
    graph_file: str = "",
    num_vertices: int = 0,
    num_edges: int = 0,
    srcs: list[int] | None = None,
    search_depths: list[int] | None = None,
    edges_visited: int = 0,
    nodes_visited: int = 0,
    tags: list[str] | None = None,
    json_dir: str = ".",
    json_file: str = "",
    command_line: str | None = None,
    device="cuda",
) -> Path:
    """Write the stats JSON of a run on ``device``; returns the path."""
    avg_t, std_t, min_t, max_t = _stats(process_times_ms)
    mteps = [
        (edges_visited / t / 1000.0) if t > 0 else 0.0 for t in process_times_ms
    ]
    avg_m, _, min_m, max_m = _stats(mteps)
    depths = search_depths or []
    avg_d, _, min_d, max_d = _stats(depths)
    now = datetime.datetime.now()

    dataset = Path(graph_file).stem if graph_file else "unknown"
    jsn = {
        "engine": ENGINE,
        "schema": SCHEMA_VERSION,
        "primitive": primitive,
        "graph_file": str(graph_file),
        "graph_type": Path(graph_file).suffix.lstrip(".") if graph_file else "",
        "num_vertices": int(num_vertices),
        "num_edges": int(num_edges),
        "process_times": [float(t) for t in process_times_ms],
        "avg_process_time": avg_t,
        "stddev_process_time": std_t,
        "min_process_time": min_t,
        "max_process_time": max_t,
        "mteps": mteps,
        "avg_mteps": avg_m,
        "min_mteps": min_m,
        "max_mteps": max_m,
        "edges_visited": int(edges_visited),
        "nodes_visited": int(nodes_visited),
        "search_depths": [int(d) for d in depths],
        "avg_search_depth": avg_d,
        "min_search_depth": int(min_d),
        "max_search_depth": int(max_d),
        "srcs": [int(s) for s in (srcs or [])],
        "tags": list(tags or []),
        "command_line": command_line
        if command_line is not None
        else " ".join(sys.argv),
        "git_commit_sha": _git_sha(),
        "compiler": "torch/CUDA",
        "compiler_version": f"torch {torch.__version__}, CUDA {torch.version.cuda}",
        "gpuinfo": _device_info(device),
        "sysinfo": _sysinfo(),
        "time": now.strftime("%a %b %d %H:%M:%S %Y"),
    }

    if json_file:
        path = Path(json_dir) / json_file
    else:
        stamp = now.strftime("%a_%b_%d_%H%M%S_%Y")
        path = Path(json_dir) / f"{primitive}_{dataset}_{stamp}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(jsn, indent=2))
    return path
