"""One cell of the benchmark: set-up, the measured window, the check.

``Cell(name, seed, device)`` reads the cell's files by name
(``portbench/manifest.py``). :meth:`Cell.setup` generates the graph from
the seed, loads it through the port, builds the entry's layouts and warms
up the cell's shapes. :meth:`Cell.window` runs one client in a closed
loop, query after query, for the given seconds. :meth:`Cell.verify`
frees the port's graph and judges a sample of the window's answers
against the plain reference. ``run.py`` and ``control.py`` drive it.
"""

from __future__ import annotations

import dataclasses
import gc
import time
import traceback

import numpy as np
import torch

from portbench import check, graphs, manifest


@dataclasses.dataclass
class Query:
    sources: np.ndarray  # int64[k], input vertex ids
    passes: int  # levels, passes or block passes, as the port returned them
    latency_ms: float  # issue to completion, by CUDA events on the card


class Sampler:
    """A seeded reservoir of ``k`` answers (indices drawn from the seed,
    whatever the window's length), plus the slowest answer."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([abs(int(seed)), 2])
        self.kept: dict[int, tuple] = {}
        self.slowest: tuple | None = None  # (latency, index, sources, raw)

    def offer(self, i: int, sources, raw, latency_ms: float) -> None:
        if i < self.k:
            self.kept[i] = (sources, raw)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                victim = sorted(self.kept)[j]
                del self.kept[victim]
                self.kept[i] = (sources, raw)
        if self.slowest is None or latency_ms > self.slowest[0]:
            self.slowest = (latency_ms, i, sources, raw)

    def answers(self) -> list[tuple]:
        out = dict(self.kept)
        if self.slowest is not None:
            _, i, sources, raw = self.slowest
            out[i] = (sources, raw)
        return [out[i] for i in sorted(out)]


class Sources:
    """Each query's sources, drawn from the seed as the query is issued.

    ``sources``: "nonzero_degree" draws among vertices with an edge (the
    Graph500 search keys), "uniform" among all; ``batch`` sources a query.
    With ``source_set``, the queries are a fixed set of that many, drawn
    from ``source_set_seed`` and the same in every run, and the seed gives
    their order: one permutation of the set after another."""

    def __init__(self, edges: graphs.EdgeList, traffic: dict, seed: int):
        self.k = int(traffic.get("batch", 1))
        self.rng = np.random.default_rng([abs(int(seed)), 1])
        self.deg = edges.degrees()
        rule = traffic["sources"]
        if rule == "nonzero_degree":
            self.cand = np.flatnonzero(self.deg > 0)
        elif rule == "uniform":
            self.cand = np.arange(edges.n)
        else:
            raise ValueError(f"unknown source rule {rule!r}")
        self.qset = None
        if "source_set" in traffic:
            fixed = np.random.default_rng([int(traffic["source_set_seed"]), 1])
            self.qset = self._draw(fixed, int(traffic["source_set"]))
            self.perm, self.pos = np.empty(0, np.int64), 0
        self.warm_rng = np.random.default_rng([abs(int(seed)), 3])

    def _draw(self, rng, n: int) -> np.ndarray:
        idx = rng.integers(0, self.cand.shape[0], size=(n, self.k))
        return self.cand[idx].astype(np.int64)

    def next(self) -> np.ndarray:
        """The next query's sources, int64[batch]."""
        if self.qset is None:
            return self._draw(self.rng, 1)[0]
        if self.pos == self.perm.shape[0]:
            self.perm, self.pos = self.rng.permutation(self.qset.shape[0]), 0
        self.pos += 1
        return self.qset[self.perm[self.pos - 1]]

    def warmup(self) -> list[np.ndarray]:
        """Two warm-up queries: the ``batch`` highest-degree vertices, and
        one query of the mix from a stream of its own."""
        top = np.argsort(-self.deg, kind="stable")[: self.k].astype(np.int64)
        if self.qset is None:
            other = self._draw(self.warm_rng, 1)[0]
        else:
            other = self.qset[self.warm_rng.integers(0, self.qset.shape[0])]
        return [top, other]


class Cell:
    def __init__(self, name: str, seed: int, device="cuda",
                 bench: dict | None = None, config: dict | None = None):
        bench = manifest.benchmark() if bench is None else bench
        self.name = name
        self.seed = int(seed)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        w = manifest.workload(bench, name)
        self.chips = int(w["chips"])
        self.config = manifest.config(w["config"]) if config is None else config
        self.traffic = manifest.traffic(w["traffic"])
        self.entry = manifest.entry(self.traffic["entry"])
        self.params = dict(self.traffic.get("params", {}))
        self.limits = manifest.limits(name)
        self.k = int(self.traffic.get("batch", 1))
        self.timings: dict[str, float] = {}
        self.prog = self.state = None
        self.failed = 0

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        self.setup_graph()
        self.setup_entry()

    def setup_graph(self, shared: "Cell | None" = None) -> None:
        """Generate the graph from the seed and load it through the port;
        or take both from ``shared``, a cell of the same configuration
        and seed."""
        from portbench import program

        if shared is not None:
            self.edges, self.prog = shared.edges, shared.prog
            self.timings.update(gen_s=shared.timings["gen_s"],
                                build_s=shared.timings["build_s"])
            return
        if self.cuda:
            t0 = time.perf_counter()
            torch.empty(1, device=self.device)  # the CUDA context
            self._sync()
            self.timings["cuda_init_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.edges = graphs.generate(self.config, self.seed, self.device)
        self._sync()
        self.timings["gen_s"] = time.perf_counter() - t0
        if self.cuda:
            # the peak counts what the port holds, not the generator's
            # scratch
            torch.cuda.reset_peak_memory_stats()
        self.prog, self.timings["build_s"] = program.load(
            self.edges, self.config, self.device)

    def setup_entry(self) -> None:
        """Build what the entry point needs and warm up the cell's shapes.
        ``warm_first_s`` is the first warm-up query alone: in a fresh
        checkout it holds the build of the port's kernels."""
        self.sources = Sources(self.edges, self.traffic, self.seed)
        self.state, extra = self.entry.prepare(self.prog, self.params)
        self._sync()
        self.timings["build_s"] += extra.pop("build_s", 0.0)
        self.timings.update(extra)
        t1 = time.perf_counter()
        for i, sources in enumerate(self.sources.warmup()):
            self.entry.query(self.prog, self.state, sources)
            self._sync()
            if i == 0:
                self.timings["warm_first_s"] = time.perf_counter() - t1
        self.timings["warm_s"] = time.perf_counter() - t1

    # -- the measured window --------------------------------------------
    def window(self, seconds: float):
        """Closed loop, one query at a time, until ``seconds`` have passed
        (the query in flight then finishes). Returns (queries, window
        seconds, sampler)."""
        sampler = Sampler(int(self.traffic.get("sample", 8)), self.seed)
        queries: list[Query] = []
        i = 0
        t0 = time.perf_counter()
        while True:
            sources = self.sources.next()
            if self.cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            h0 = time.perf_counter()
            try:
                raw, passes = self.entry.query(self.prog, self.state, sources)
            except Exception:  # a query that fails ends the window
                traceback.print_exc()
                self.failed += 1
                break
            if self.cuda:
                e1.record()
                e1.synchronize()
                latency = e0.elapsed_time(e1)
            else:
                latency = (time.perf_counter() - h0) * 1e3
            queries.append(Query(sources, int(passes), latency))
            sampler.offer(i, sources, raw, latency)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        return queries, time.perf_counter() - t0, sampler

    # -- after the window -----------------------------------------------
    def release(self) -> None:
        """Free the port's graph, layouts and state."""
        self.prog = self.state = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def reference(self):
        """The kind's plain reference over the benchmark's own edge list."""
        return manifest.kind(self.entry.KIND).reference(self.edges,
                                                        self.device)

    def verify(self, answers: list[tuple], ref=None) -> dict:
        """The worst readings over ``answers`` ([(sources, raw)])."""
        kind = manifest.kind(self.entry.KIND)
        ref = self.reference() if ref is None else ref
        return check.merge([kind.check_answer(ref, [int(s) for s in src],
                                              self.entry.answer(raw))
                            for src, raw in answers])

    def control(self, answers: list[tuple], ref=None) -> dict:
        """The same readings of the control, on the same sources."""
        kind = manifest.kind(self.entry.KIND)
        ref = self.reference() if ref is None else ref
        out = []
        for src, _ in answers:
            srcs = [int(s) for s in src]
            out.append(kind.check_answer(ref, srcs,
                                         kind.control(ref, srcs, self.entry)))
        return check.merge(out)

    def work(self, queries: list[Query]):
        """([work of each query], [bytes each query needs]), by the kind's
        own count (``portbench/bytecount.py``), never the program's."""
        return manifest.kind(self.entry.KIND).work(
            self.edges, [q.sources for q in queries], self.entry)

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
