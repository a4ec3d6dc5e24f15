"""Timer with the reference timer API: ``begin()`` / ``end() -> ms``.

On a CUDA device it records CUDA events on the current stream and waits
for the end event, so the time covers the device work and not only its
enqueue. On the CPU it reads the host clock.
"""

from __future__ import annotations

import time

import torch


class Timer:
    def __init__(self, device="cuda"):
        self._cuda = torch.device(device).type == "cuda"
        self._t0 = None

    def begin(self) -> None:
        if self._cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def end(self) -> float:
        """Wait for the work issued since ``begin()``; return milliseconds."""
        if self._cuda:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            stop.synchronize()
            return self._t0.elapsed_time(stop)
        return (time.perf_counter() - self._t0) * 1e3


def timed(device, fn, warmup: bool = True):
    """``(fn(), ms)``: one call of ``fn`` timed with :class:`Timer` on
    ``device``, after an untimed warm-up call when ``warmup``."""
    if warmup:
        fn()
    timer = Timer(device)
    timer.begin()
    out = fn()
    return out, timer.end()
