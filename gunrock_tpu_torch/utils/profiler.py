"""Tracing hooks (counterpart of ``gunrock_tpu/utils/profiler.py``).

``trace`` records the host and the card with ``torch.profiler`` and
writes a chrome trace (``*.pt.trace.json``) into ``log_dir``, where the
JAX package writes an xprof ``.xplane.pb``; ``utils.trace_stats`` reads
it. ``annotate`` names a span in that trace. XLA's per-executable cost
model (``cost_analysis``) has no PyTorch counterpart and is left out.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


def default_log_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "gunrock_tpu_torch_trace")


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Trace a block on the host and, where there is one, the card::

        with profiler.trace(log_dir):
            bfs.run(graph, 0)

    Waits for the card before the trace closes, then writes
    ``<log_dir>/trace_<pid>_<ns>.pt.trace.json`` (open it in Perfetto or
    chrome://tracing). Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or default_log_dir()
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    name = f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def annotate(name: str):
    """Named span context (a ``user_annotation`` in the trace)."""
    return torch.profiler.record_function(name)
