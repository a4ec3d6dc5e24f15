"""The TPU probes of ``benchmarks/`` on the card: drivers that time the
kernels of ``ops/kernels/probes.py`` and print one JSON line per variant
with the JAX probe's keys, the device's name and power limit beside every
time.

    python -m gunrock_tpu_torch.probes.v5_floor [dma|gather|full|all]
    python -m gunrock_tpu_torch.probes.gather   [lane|sublane|flat|twolevel|bench|all]
    python -m gunrock_tpu_torch.probes.gather2  [wide|tall|big|bench|bench_sub|all]
    python -m gunrock_tpu_torch.probes.dma      [check|bench|all]
    python -m gunrock_tpu_torch.probes.pull     [--sweep 4,8,16,32]

(``pull`` has no TPU counterpart: it times the semiring pull's span
kernels, B1 and B3, and sweeps the span length. ``mesh`` is no driver:
it holds the distributed layer's rank worker, ``run_cases``.)

Each runs on the card (``--device cuda``, the default; it raises without
one) and runs every variant in one process: the JAX drivers' one
subprocess per variant guarded against a TPU fault the card does not
have. Times are CUDA-event means over warm calls; device times come from
a ``torch.profiler`` profile (``utils/trace_stats.device_profile``).
"""

from __future__ import annotations

import torch

from gunrock_tpu_torch.device import resolve
from gunrock_tpu_torch.device.properties import NOT_MEASURED, get_device_properties
from gunrock_tpu_torch.utils import trace_stats
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
    device-side events of a profile of ``n`` calls
    (``trace_stats.device_profile``, the kernel table's method); "not
    measured" on the CPU or where three profiles in a row hold no device
    events. (Summing a chrome trace's events instead read 0.63-0.65 of
    this for the same calls late in a long process, on an H100.)"""
    if resolve(device).type != "cuda":
        return NOT_MEASURED
    for _ in range(3):
        prof = trace_stats.device_profile(lambda: [fn() for _ in range(n)])
        if "busy_us" in prof:
            return prof["busy_us"] / n / 1e3
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
