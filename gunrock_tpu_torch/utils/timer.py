"""Timer with the reference timer API: ``begin()`` / ``end() -> ms``,
``milliseconds()`` and ``reset()`` (reference util/timer.hxx:18-62).

On a CUDA device it records CUDA events on the current stream and waits
for the end event, so the time covers the device work and not only its
enqueue. On the CPU it reads the host clock. ``end(*arrays)`` also waits
for the devices of the CUDA tensors it is given, as the JAX package's
``end`` blocks on its arrays. Each wait is a ``timer.sync`` span
(``utils/profiler.host_read``).
"""

from __future__ import annotations

import time

import torch

from gunrock_tpu_torch.utils.profiler import host_read


def _cuda_devices(arrays) -> set:
    """The CUDA devices of the tensors in ``arrays`` (nested in tuples,
    lists and dicts)."""
    out = set()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            if a.is_cuda:
                out.add(a.device)
        elif isinstance(a, dict):
            out |= _cuda_devices(a.values())
        elif isinstance(a, (tuple, list)):
            out |= _cuda_devices(a)
    return out


class Timer:
    def __init__(self, device="cuda"):
        self._cuda = torch.device(device).type == "cuda"
        self._t0 = None
        self._ms = 0.0

    def begin(self) -> None:
        if self._cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def end(self, *arrays) -> float:
        """Wait for the work issued since ``begin()`` and for the devices
        of the CUDA tensors in ``arrays``; return milliseconds."""
        for dev in _cuda_devices(arrays):
            host_read("timer", dev)
        if self._cuda:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            host_read("timer", stop)
            self._ms = self._t0.elapsed_time(stop)
        else:
            self._ms = (time.perf_counter() - self._t0) * 1e3
        return self._ms

    def milliseconds(self) -> float:
        """The last ``end()``'s milliseconds (0.0 before any)."""
        return self._ms

    def reset(self) -> None:
        self._t0 = None
        self._ms = 0.0


def timed(device, fn, warmup: bool = True):
    """``(fn(), ms)``: one call of ``fn`` timed with :class:`Timer` on
    ``device``, after an untimed warm-up call when ``warmup``."""
    if warmup:
        fn()
    timer = Timer(device)
    timer.begin()
    out = fn()
    return out, timer.end()
