"""One CUDA graph a level for the direction-optimizing search loops.

The loops of ``algorithms/bfs.py::bfs_kernel_do`` and
``algorithms/sssp.py::sssp_kernel_do`` read two numbers to the host each
level, the frontier's out-edge sum and size, which pick the next level's
direction and end the loop. Run eagerly, a level dispatches some twenty
torch ops and a kernel wrapper or two, and the card idles while the host
does that. No tensor of a level has a shape that depends on the data, so
on the card a level's whole device work is captured once into a
``torch.cuda.CUDAGraph`` and replayed for every later level that takes the
same direction, from any source: one launch and one wait a level.

:class:`Levels` runs one search's levels either way. It takes the graph
path where :func:`level_graphs` gives an entry: on a CUDA device, over a
pull layout, and outside the checked build, whose launches wait for the
card, which a capture forbids. Elsewhere (the CPU, a search without a
pull layout) every level runs eagerly. The entries of a layout live in
:data:`TABLES` under its ``id`` and are dropped when the layout is
collected, so the graphs' lifetime and captured addresses go with it.

On the graph path the search's state lives in the entry's static buffers:
the frontier, the distances, the out-degrees, a level counter on the
device and a pinned pair for the host read. A graph runs the level's
step, copies the frontier and distances it makes back into the buffers,
advances the level counter, and ends with the next read's sum and size,
copied into the pinned pair; the host then waits on one event. The pair
is one masked sum over the out-degrees stacked on ones: two device ops,
where the eager read takes four. A direction runs eagerly the first time
it comes (that loads its kernels' library, and is torch's warm-up before
a capture), is captured the second time, and is replayed from then on.
An entry's graphs share one memory pool: no tensor made inside a graph
outlives its replay, so replays may come in any order.

Counters (``ops/kernels/_build.LAUNCHES``): ``level_graph_capture`` and
``level_graph_replay``, the levels captured and replayed. A replay adds
the kernel launches its capture counted, so each kernel's count stays one
a launch. Each level's span gets ``graph``: ``"replay"``, ``"capture"`` or
``"eager"``.
"""

from __future__ import annotations

import collections
import weakref

import torch

from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.utils.profiler import host_read


class LevelGraphs:
    """The static buffers of one kind of search over one pull layout, and
    the level graphs captured over them, one a direction. ``sources`` are
    the tensors and layouts besides the buffers that the graphs read."""

    def __init__(self, graph, dist_dtype, sources: tuple):
        dev, V = graph.device, graph.n_vertices
        self.sources = sources
        self.front = torch.zeros(V, dtype=torch.bool, device=dev)
        self.dist = torch.zeros(V, dtype=dist_dtype, device=dev)
        # the out-degrees over ones: one masked sum gives both numbers read
        deg = graph.out_degrees()
        self.deg = torch.stack([deg, torch.ones_like(deg)])
        self.level = torch.zeros((), dtype=torch.int32, device=dev)
        self.stats = torch.zeros(2, dtype=torch.int64, pin_memory=True)
        self.done = torch.cuda.Event()
        self.pool = torch.cuda.graph_pool_handle()
        # direction -> (graph, the kernel launches one replay makes)
        self.graphs: dict = {}
        self.eager: set = set()  # directions run once eagerly

    def tail(self) -> None:
        """Copy the frontier's out-edge sum and size into the pinned pair."""
        self.stats.copy_(torch.where(self.front, self.deg, 0).sum(1),
                         non_blocking=True)

    def body(self, fn) -> None:
        """One level over the buffers: ``fn(front, dist, level)``, its
        results copied back, the level counter advanced, then the tail."""
        front, dist = fn(self.front, self.dist, self.level)
        if front is not self.front:
            self.front.copy_(front)
        if dist is not self.dist:
            self.dist.copy_(dist)
        self.level.add_(1)
        self.tail()

    def run(self, direction: str, fn) -> str:
        """Run one level in ``direction`` by replay, capture or eagerly;
        returns which, and records the event the host read waits on."""
        if direction in self.graphs:
            graph, launches = self.graphs[direction]
            graph.replay()
            _build.LAUNCHES.update(launches)
            _build.LAUNCHES["level_graph_replay"] += 1
            how = "replay"
        elif direction in self.eager:
            before = collections.Counter(_build.LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                self.body(fn)
            self.graphs[direction] = (graph, _build.LAUNCHES - before)
            graph.replay()
            _build.LAUNCHES["level_graph_capture"] += 1
            how = "capture"
        else:
            self.body(fn)
            self.eager.add(direction)
            how = "eager"
        self.done.record()
        return how

    def wait(self) -> torch.Tensor:
        """The pinned pair, once the card has written it."""
        self.done.synchronize()
        return self.stats


# id(layout) -> {kind of search: LevelGraphs}, for the layouts alive
TABLES: dict[int, dict] = {}


def table(layout) -> dict:
    """The entries of ``layout`` by kind of search, made empty on first
    use and dropped with the layout."""
    key = id(layout)
    if key not in TABLES:
        TABLES[key] = {}
        weakref.finalize(layout, TABLES.pop, key, None)
    return TABLES[key]


def level_graphs(kind: str, graph, layout, layout_dense,
                 dist_dtype) -> LevelGraphs | None:
    """The entry of searches of ``kind`` over ``layout`` (and
    ``layout_dense``) on ``graph``, made on first use; None where the
    levels run eagerly: off the card, without a layout, or in the checked
    build. An entry made over other graph arrays or another dense layout
    is replaced."""
    if layout is None or graph.device.type != "cuda" or _build.checked():
        return None
    sources = (graph.row_offsets, graph.col_indices, graph.values,
               layout_dense)
    entries = table(layout)
    entry = entries.get(kind)
    if entry is None or any(a is not b for a, b in zip(entry.sources,
                                                       sources)):
        entry = entries[kind] = LevelGraphs(graph, dist_dtype, sources)
    return entry


class Levels:
    """The levels of one search from the state (``front``, ``dist``) at
    level ``level``: on the graph path when ``entry`` is given, else
    eagerly. ``owner`` names the host read's span (``<owner>.sync``)."""

    def __init__(self, owner: str, graph, entry: LevelGraphs | None, front,
                 dist, level: int):
        self.owner = owner
        self.entry = entry
        if entry is None:
            self.deg = graph.out_degrees()
            self.front, self.dist = front, dist
            return
        entry.front.copy_(front)
        entry.dist.copy_(dist)
        entry.level.fill_(level)
        entry.tail()
        entry.done.record()

    def read(self) -> list:
        """[out-edge sum, size] of the frontier, read to the host."""
        if self.entry is not None:
            return host_read(self.owner, self.entry.wait)
        front, deg = self.front, self.deg
        return host_read(self.owner, lambda: torch.stack(
            [torch.where(front, deg, 0).sum(), front.sum()]))

    def step(self, direction: str, level: int, fn) -> str:
        """One level: ``fn(front, dist, level) -> (front, dist)``, with
        ``level`` eagerly and the device counter on the graph path. Returns
        how it ran: ``"replay"``, ``"capture"`` or ``"eager"``."""
        if self.entry is not None:
            return self.entry.run(direction, fn)
        self.front, self.dist = fn(self.front, self.dist, level)
        return "eager"

    def frontier(self) -> torch.Tensor:
        """The frontier (a copy on the graph path, whose buffer the next
        search overwrites)."""
        return self.front if self.entry is None else self.entry.front.clone()

    def distances(self) -> torch.Tensor:
        """The distances (a copy on the graph path)."""
        return self.dist if self.entry is None else self.entry.dist.clone()
