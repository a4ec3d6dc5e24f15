"""The direction-optimizing level loop of BFS and SSSP, and one CUDA graph a
level on the card.

:func:`run_levels` is the loop of ``algorithms/bfs.py::bfs_kernel_do`` and
``algorithms/sssp.py::sssp_kernel_do``. Each level reads two numbers to
the host, the frontier's out-edge sum and size, which end the loop and
pick the level's direction. Run eagerly, a level dispatches some twenty
torch ops and a kernel wrapper or two, and the card idles while the host
does that. No tensor of a level has a shape that depends on the data, so
on the card a level's device work is captured once into a
``torch.cuda.CUDAGraph`` and replayed for every later level that takes the
same direction, from any source: one launch and one wait a level.

:class:`Levels` is a search's state. :func:`level_graphs` gives one on the
graph path on a CUDA device, over a pull layout and outside the checked
build (whose launches wait for the card, which a capture forbids), cached
in :data:`TABLES` under the layout's ``id`` and dropped with the layout,
so the graphs' captured addresses go with it. Elsewhere it gives a fresh
state that runs every level eagerly. A graph runs the level's step, copies
the frontier and distances it makes back into the buffers, advances the
level counter, and ends with the next read's sum, copied into a pinned
pair; the host then waits on one event. A direction runs eagerly the first
time it comes (that loads its kernels' library, and is torch's warm-up
before a capture), is captured the second time, and is replayed from then
on. The graphs share one memory pool: no tensor made inside a graph
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
from gunrock_tpu_torch.utils.profiler import annotate, host_read


class Levels:
    """The frontier, distances and out-degrees of searches of ``owner``
    (``"bfs"`` or ``"sssp"``, which names the spans) on ``graph``.
    ``sources``: what the graphs read besides these; None for a state that
    runs every level eagerly. A graph path state serves every search of its
    kind: a search copies out what it returns."""

    def __init__(self, owner: str, graph, dist_dtype, sources=None):
        dev, V = graph.device, graph.n_vertices
        self.owner = owner
        self.sources = sources
        self.front = torch.empty(V, dtype=torch.bool, device=dev)
        self.dist = torch.empty(V, dtype=dist_dtype, device=dev)
        # the out-degrees over ones: one masked sum gives both numbers read
        deg = graph.out_degrees()
        self.deg = torch.stack([deg, torch.ones_like(deg)])
        if sources is None:
            return
        self.level = torch.zeros((), dtype=torch.int32, device=dev)
        self.stats = torch.zeros(2, dtype=torch.int64, pin_memory=True)
        self.done = torch.cuda.Event()
        self.pool = torch.cuda.graph_pool_handle()
        # direction -> (graph, the kernel launches one replay makes)
        self.graphs: dict = {}
        self.eager: set = set()  # directions run once eagerly

    def start(self, source: int, far) -> None:
        """A fresh search from ``source``: every distance ``far`` but the
        source's 0, the frontier the source alone, level 0."""
        self.front.zero_()
        self.front[source] = True
        self.dist.fill_(far)
        self.dist[source] = 0
        self._begin(0)

    def resume(self, level: int, front, dist) -> None:
        """Continue a search from its state at ``level``."""
        self.front.copy_(front)
        self.dist.copy_(dist)
        self._begin(level)

    def _begin(self, level: int) -> None:
        if self.sources is not None:
            self.level.fill_(level)
            self.stats.copy_(self._sum(), non_blocking=True)
            self.done.record()

    def _sum(self) -> torch.Tensor:
        """[out-edge sum, size] of the frontier, on its device."""
        return torch.where(self.front, self.deg, 0).sum(1)

    def read(self) -> list:
        """[out-edge sum, size] of the frontier, read to the host."""
        if self.sources is None:
            return host_read(self.owner, self._sum)
        host_read(self.owner, self.done)
        return self.stats.tolist()

    def _body(self, fn) -> None:
        """One level over the buffers and the level counter, its results
        copied back, the counter advanced, then the next read's sum."""
        front, dist = fn(self.front, self.dist, self.level)
        if front is not self.front:
            self.front.copy_(front)
        if dist is not self.dist:
            self.dist.copy_(dist)
        self.level.add_(1)
        self.stats.copy_(self._sum(), non_blocking=True)

    def step(self, direction: str, level: int, fn) -> str:
        """One level: ``fn(front, dist, level) -> (front, dist)``, with
        ``level`` eagerly and the device counter on the graph path. Returns
        how it ran: ``"replay"``, ``"capture"`` or ``"eager"``."""
        if self.sources is None:
            self.front, self.dist = fn(self.front, self.dist, level)
            return "eager"
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
                self._body(fn)
            self.graphs[direction] = (graph, _build.LAUNCHES - before)
            graph.replay()
            _build.LAUNCHES["level_graph_capture"] += 1
            how = "capture"
        else:
            self._body(fn)
            self.eager.add(direction)
            how = "eager"
        self.done.record()
        return how


def run_levels(graph, levels: Levels, steps: dict, level: int, limit: int,
               edge_budget: int) -> int:
    """The levels of one search from ``level`` until the frontier empties
    or ``limit``; returns the level it stopped at. Each level reads the
    frontier's out-edge sum and size, takes ``steps["push"]`` when both are
    under ``edge_budget``, else ``steps["pull_dense"]`` where given and the
    frontier covers half the edges, else ``steps["pull"]`` where given,
    else ``steps["step"]``, and runs it in a span ``<owner>.level``."""
    while level < limit:
        # the level's one host read
        out_edges, n_front = levels.read()
        if n_front == 0:
            break
        if out_edges < edge_budget and n_front < edge_budget:
            direction = "push"
        elif "pull_dense" in steps and out_edges >= graph.n_edges // 2:
            direction = "pull_dense"
        elif "pull" in steps:
            direction = "pull"
        else:
            direction = "step"
        with annotate(f"{levels.owner}.level", level=level,
                      direction=direction, n_front=n_front,
                      out_edges=out_edges) as span:
            span.set(graph=levels.step(direction, level, steps[direction]))
        level += 1
    return level


# id(layout) -> {kind of search: Levels}, for the layouts alive
TABLES: dict[int, dict] = {}


def table(layout) -> dict:
    """The states of ``layout`` by kind of search, made empty on first use
    and dropped with the layout."""
    key = id(layout)
    if key not in TABLES:
        TABLES[key] = {}
        weakref.finalize(layout, TABLES.pop, key, None)
    return TABLES[key]


def level_graphs(kind: str, graph, layout, layout_dense,
                 dist_dtype) -> Levels:
    """The state of searches of ``kind`` over ``layout`` (and
    ``layout_dense``) on ``graph``: on the graph path the layout's, made on
    first use and replaced when made over other graph arrays or another
    dense layout; a fresh eager one off the card, without a layout, or in
    the checked build."""
    if layout is None or graph.device.type != "cuda" or _build.checked():
        return Levels(kind, graph, dist_dtype)
    sources = (graph.row_offsets, graph.col_indices, graph.values,
               layout_dense)
    entries = table(layout)
    levels = entries.get(kind)
    if levels is None or any(a is not b for a, b in zip(levels.sources,
                                                        sources)):
        levels = entries[kind] = Levels(kind, graph, dist_dtype, sources)
    return levels
