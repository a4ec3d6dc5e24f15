"""The TPU probes of ``benchmarks/`` on the card: drivers that time the
kernels of ``ops/kernels/probes.py`` and print one JSON line per variant
with the JAX probe's keys, the device's name and power limit beside every
time.

    python -m gunrock_tpu_torch.probes.v5_floor [dma|gather|full|all]
    python -m gunrock_tpu_torch.probes.gather   [lane|sublane|flat|twolevel|bench|all]
    python -m gunrock_tpu_torch.probes.gather2  [wide|tall|big|bench|bench_sub|all]
    python -m gunrock_tpu_torch.probes.dma      [check|bench|all]

Each runs on the card (``--device cuda``, the default; it raises without
one) and runs every variant in one process: the JAX drivers' one
subprocess per variant guarded against a TPU fault the card does not
have. Times are CUDA-event means over warm calls; device times come from
a ``torch.profiler`` trace (``utils/profiler``, ``utils/trace_stats``).
"""

from __future__ import annotations

import tempfile

import torch

from gunrock_tpu_torch.device import resolve
from gunrock_tpu_torch.device.properties import NOT_MEASURED, get_device_properties
from gunrock_tpu_torch.utils import profiler, trace_stats
from gunrock_tpu_torch.utils.timer import Timer


def device_label(device) -> str:
    """The device's name and power limit, written beside every time."""
    return get_device_properties(device).name_power_limit


def time_ms(device, fn, n: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``n`` calls after one
    warm call: CUDA events on the card, the host clock on the CPU."""
    fn()
    timer = Timer(device)
    timer.begin()
    for _ in range(n):
        fn()
    return timer.end() / n


def device_ms(device, fn, n: int):
    """The card's busy milliseconds per call of ``fn``, summed over the
    device-side events of a trace of ``n`` calls; "not measured" on the
    CPU or where three traces in a row hold no device events (a trace
    taken right after another has come back without them on the card)."""
    if resolve(device).type != "cuda":
        return NOT_MEASURED
    fn()
    for _ in range(3):
        with tempfile.TemporaryDirectory() as log_dir:
            with profiler.trace(log_dir):
                for _ in range(n):
                    fn()
            busy = trace_stats.device_busy_ms(log_dir)
        if busy is not None:
            return busy / n
    return NOT_MEASURED


def bench_rates(device, fn, x, idx, axis, n: int) -> dict:
    """A gather's time and rate in Gelem/s (``fn``: the kernel's call),
    wall and device, beside ``torch.take_along_dim`` on the same inputs
    (its int64 indices made beforehand)."""
    rows = {}
    il = idx.long()
    for key, call in (("", fn),
                      ("take_along_dim_", lambda: torch.take_along_dim(x, il, dim=axis))):
        ms = time_ms(device, call, n)
        dev_ms = device_ms(device, call, n)
        rows[f"{key}ms"] = ms
        rows[f"{key}gelems_per_s"] = idx.numel() / ms / 1e6
        rows[f"{key}device_ms"] = dev_ms
        if not isinstance(dev_ms, str):
            rows[f"{key}gelems_per_s_device"] = idx.numel() / dev_ms / 1e6
    return rows
