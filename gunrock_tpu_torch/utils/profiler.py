"""Tracing hooks (counterpart of ``gunrock_tpu/utils/profiler.py``).

``trace`` records the host and the card with ``torch.profiler`` and
writes a chrome trace (``*.pt.trace.json``) into ``log_dir``, where the
JAX package writes an xprof ``.xplane.pb``; ``utils.trace_stats`` reads
it. XLA's per-executable cost model (``cost_analysis``) has no PyTorch
counterpart and is left out.

Spans. ``annotate(name, **attrs)`` is the port's one span, placed at the
boundaries of its layers (a query, a search, a level, a host read, a
kernel wrapper, a graph load, a layout build). With no recording on and
no ``torch.profiler`` active it returns a shared no-op after two flag
checks: no ``record_function``, no timestamp, no allocation. While a
profiler is active it enters ``record_function(name)``, a
``user_annotation`` in the exported trace (and a ``gpu_user_annotation``
over the kernels launched inside it). Inside ``recording()`` it also
appends a :class:`Span` to the recording, stamped with ``time.time_ns()``:
the clock of the exported trace's host events (``baseTimeNanoseconds`` +
``ts``). The start is taken after ``record_function`` is entered and the
end after it is left, so a span agrees with its twin in the trace. An
outermost span opens a new query id, which every span inside it carries.
Spans nest per recording: the port's search paths run on one thread.

``host_read(owner, x)`` is how the port's search loops wait for the card:
it reads a tensor to the host, or synchronises an event or a device,
inside a span ``<owner>.sync``, so each host sync is counted where it
happens.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time

import torch
import torch.autograd.profiler as _autograd_profiler


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


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span. ``parent`` is the index of the enclosing span in
    ``Recording.spans`` (-1 for an outermost one); ``end_ns`` is 0 while
    the span is open; ``attrs`` are the keywords given to ``annotate``
    and those set on the span while it is open."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    query: int
    attrs: dict


class Recording:
    """The spans recorded while ``recording()`` is on, in the order they
    opened, kept column by column (names, stamps, parents, query ids,
    attrs) so that recording allocates no object the garbage collector
    tracks; ``spans`` builds the :class:`Span` list when read. Past
    ``limit`` spans, each further span is counted in ``dropped`` and not
    kept."""

    def __init__(self, limit: int):
        self.limit = limit
        self.dropped = 0
        self._names: list[str] = []
        self._starts: list[int] = []
        self._ends: list[int] = []
        self._parents: list[int] = []
        self._queries: list[int] = []
        self._attrs: list[dict] = []
        self._open: list[int] = []  # indices of the open spans, innermost last
        self._next_query = 0

    def __len__(self) -> int:
        return len(self._names)

    @property
    def spans(self) -> list[Span]:
        return [Span(*row) for row in zip(self._names, self._starts,
                                          self._ends, self._parents,
                                          self._queries, self._attrs)]

    def _enter(self, name: str, attrs: dict) -> int:
        stack, index = self._open, len(self._names)
        if index >= self.limit:
            self.dropped += 1
            stack.append(-1)
            return -1
        if stack and stack[-1] >= 0:
            parent = stack[-1]
            query = self._queries[parent]
        else:
            parent, query = -1, self._next_query
            self._next_query += 1
        stack.append(index)
        self._names.append(name)
        self._parents.append(parent)
        self._queries.append(query)
        self._attrs.append(attrs)
        self._ends.append(0)
        self._starts.append(time.time_ns())
        return index

    def _exit(self, index: int) -> None:
        if index >= 0:
            self._ends[index] = time.time_ns()
        self._open.pop()


_recording: Recording | None = None


class _Span:
    """A span while it is open: ``set(**attrs)`` adds attributes known
    only inside it (a kernel's counts)."""

    __slots__ = ("name", "attrs", "_fn", "_rec", "_index")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._fn = None
        if _autograd_profiler._is_profiler_enabled:
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        self._rec = _recording
        if self._rec is not None:
            self._index = self._rec._enter(self.name, self.attrs)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._fn is not None:
            self._fn.__exit__(exc_type, exc, tb)
        if self._rec is not None:
            self._rec._exit(self._index)
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


def annotate(name: str, **attrs):
    """The span ``name`` around a block (see the module docstring)::

        with profiler.annotate("bfs.level", level=3) as span:
            ...
            span.set(n_new=k)
    """
    if _recording is None and not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, attrs)


@contextlib.contextmanager
def recording(limit: int = 1 << 20):
    """Record every span opened inside the block; yields the
    :class:`Recording`. One recording at a time."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already on")
    rec = Recording(limit)
    _recording = rec
    try:
        yield rec
    finally:
        _recording = None


def _read(x):
    if callable(x):
        x = x()
    if isinstance(x, torch.Tensor):
        return x.item() if x.dim() == 0 else x.tolist()
    if isinstance(x, torch.device):
        torch.cuda.synchronize(x)
    else:
        x.synchronize()  # a torch.cuda.Event
    return None


def host_read(owner: str, x):
    """Wait for the card inside a span ``<owner>.sync``: ``x.tolist()``
    for a tensor (``x.item()`` for a 0-d one), else synchronise
    ``x``, a ``torch.cuda.Event`` or a CUDA ``torch.device`` (None). ``x``
    may be a function that makes the tensor, so that the ops computing
    what is read count to the read."""
    if _recording is None and not _autograd_profiler._is_profiler_enabled:
        return _read(x)
    with _Span(owner + ".sync", {}):
        return _read(x)
