"""The distributed layer's rank worker (``parallel/``) and what its checks
read.

:func:`run_cases` runs a list of sharded calls in one set of ranks,
``parallel.mesh.spawn(run_cases, n, graphs, cases, device, device=...)``.
The CLIs' ``--devices`` branch (``examples/runner.maybe_mesh``), the tests
and ``chip_smoke.py``'s distributed phase all go through it. Beside each
call's result and times it returns what those checks read: each rank's
kernel launches and layout chunks, the exchange mode and its bytes, and
the modules of ``jax`` or ``gunrock_tpu`` a rank loaded (none is
expected).

Two more kinds of case: ``collectives`` runs each collective once on
seeded data (:func:`collectives_probe`, held against
:func:`collectives_expected`), and ``round`` times the pieces of one round
of a sharded BFS in every rank (:func:`round_costs`).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from gunrock_tpu_torch.examples.runner import timed_runs
from gunrock_tpu_torch.parallel import collectives as C
from gunrock_tpu_torch.parallel import sharded
from gunrock_tpu_torch.parallel.algorithms import tc, tc_replicated

# what run_cases calls: the sharded graph first, or the Graph itself
_ON_SHARDS = {f.__name__: f for f in (
    sharded.bfs, sharded.sssp, sharded.pagerank, sharded.spmv, sharded.kcore,
    sharded.hits, sharded.color, sharded.color_greedy, sharded.ppr,
    sharded.bc, sharded.geo, sharded.mst, sharded.spgemm_count)}
_ON_GRAPH = {"tc": tc, "tc_ring": sharded.tc_ring,
             "tc_replicated": tc_replicated}
_FOREIGN = ("jax", "gunrock_tpu")
# warm calls a piece of ``round_costs`` is timed over
ROUND_RUNS = 20


def _host(x):
    """A result with its tensors as numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, tuple):
        return tuple(_host(v) for v in x)
    return x


def run_cases(graphs: dict, cases: list, device="cuda",
              mesh_2d: tuple | None = None) -> dict:
    """Run each case of ``cases`` on one mesh of the ranks (inside a rank).
    The mesh is flat, or (host, chip) with ``mesh_2d = (n_hosts,
    chips_per_host)``.

    A case is a dict: ``algo`` (a sharded algorithm's name, ``tc``,
    ``tc_ring``, ``tc_replicated``, ``collectives`` with ``kwargs`` and no
    graph, or ``round`` with a source in ``args``), ``graph`` (a key of
    ``graphs``), ``use_halo`` (the partition's exchange; None picks),
    ``layouts`` (``build_sharded_layouts`` keywords, a list of two for
    hits, or None), ``args`` and ``kwargs`` after the sharded graph
    (``graph_b`` names spgemm_count's B), ``repeat`` (timed runs,
    ``runner.timed_runs``; default 1) and ``name``.

    Returns, from rank 0: the backend, whether collectives go through the
    host, the ranks, the host's clock (``time.time()``) on entering and
    leaving, each rank's loaded modules of ``jax`` or ``gunrock_tpu``, and
    per case its result (numpy), the wall ms of each run, each rank's
    kernel launches over the runs and the chunk counts of its layouts (an
    edgeless one launches nothing), the exchange mode,
    ``collective_bytes_per_exchange`` and ``_detail``, and rank 0's ms of
    set-up (the partition and layouts the case built first) and of the
    whole case (set-up, runs and the gathers of its counts)."""
    from gunrock_tpu_torch.ops.kernels import _build
    from gunrock_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    entered = time.time()
    mesh = make_mesh(device=device) if mesh_2d is None else make_mesh_2d(
        *mesh_2d, device=device)
    shards, layouts, out = {}, {}, []

    def sharded_graph(key, use_halo):
        if (key, use_halo) not in shards:
            shards[key, use_halo] = sharded.partition_sharded(
                graphs[key], mesh.size, mesh, use_halo=use_halo)
        return shards[key, use_halo]

    def layout(key, kw):
        lk = (key, tuple(sorted(kw.items())))
        if lk not in layouts:
            layouts[lk] = sharded.build_sharded_layouts(
                graphs[key], mesh.size, mesh=mesh, **kw)
        return layouts[lk]

    n_hosts = mesh.shape[0] if len(mesh.shape) > 1 else 1
    for case in cases:
        algo, key = case["algo"], case.get("graph")
        name = case.get("name", algo)
        if algo == "collectives":
            out.append({"name": name, "algo": algo, "result":
                        collectives_probe(mesh, **case.get("kwargs", {}))})
            continue
        if algo == "round":
            sg = sharded_graph(key, case.get("use_halo"))
            out.append({"name": name, "algo": algo,
                        "result": round_costs(sg, *case["args"], mesh)})
            continue
        case_start = time.perf_counter()
        kwargs = dict(case.get("kwargs", {}))
        lay = case.get("layouts")
        if lay is not None:
            kwargs["layouts"] = (
                tuple(layout(key, kw) for kw in lay) if isinstance(lay, list)
                else layout(key, lay))
        args = list(case.get("args", ()))
        if "graph_b" in case:
            args.insert(0, graphs[case["graph_b"]])
        if algo in _ON_GRAPH:
            sg, fn, first = None, _ON_GRAPH[algo], graphs[key]
        else:
            sg = sharded_graph(key, case.get("use_halo"))
            fn, first = _ON_SHARDS[algo], sg
        setup_ms = (time.perf_counter() - case_start) * 1e3
        _build.reset_launches()
        # the JAX layer's argument order: the sharded graph (or the graph),
        # a source, x, lat/lon or B, then the mesh
        times, result = timed_runs(
            case.get("repeat", 1), lambda: fn(first, *args, mesh, **kwargs),
            mesh.device)
        launches = [None] * mesh.size
        dist.all_gather_object(launches, dict(_build.LAUNCHES))
        used = kwargs.get("layouts")
        used = used if isinstance(used, tuple) else (
            () if used is None else (used,))
        chunks = [None] * mesh.size
        dist.all_gather_object(chunks, [L.layout.n_chunks for L in used])
        out.append({
            "case_ms": (time.perf_counter() - case_start) * 1e3,
            "name": name, "algo": algo,
            "result": _host(result), "ms": times, "launches": launches,
            "layout_chunks": chunks,
            "mode": None if sg is None else
            ("halo" if sg.use_halo else "all_gather"),
            "bytes": None if sg is None else
            sharded.collective_bytes_per_exchange(sg),
            "bytes_detail": None if sg is None else
            sharded.collective_bytes_detail(sg, n_hosts),
            "setup_ms": setup_ms,
        })
    foreign = [None] * mesh.size
    dist.all_gather_object(foreign, sorted(
        m for m in sys.modules if m.split(".")[0] in _FOREIGN))
    return {"backend": mesh.backend, "staged": mesh.staged,
            "ranks": mesh.size, "device": str(mesh.device),
            "foreign_modules": foreign, "cases": out,
            "entered": entered, "left": time.time()}


def collectives_probe(mesh, seed: int = 0, width: int = 5) -> dict:
    """Run each collective once on seeded data and return what every rank
    got (gathered to each rank): a check of a mesh's wiring and backend,
    held against :func:`collectives_expected`. Rank r's operand is
    ``probe_data(seed, r, n, width)``."""
    n = mesh.size
    x = torch.from_numpy(probe_data(seed, mesh.rank, n, width)).to(
        mesh.device)
    got = {
        "all_gather": C.all_gather(x[0], mesh),
        "psum": C.psum(x[0], mesh), "pmax": C.pmax(x[0], mesh),
        "pmin": C.pmin(x[0], mesh), "psum_scalar": C.psum(mesh.rank + 1, mesh),
        "all_to_all": C.all_to_all(x, mesh),
        "all_to_all_flat": C._a2a(x, mesh, None),
        "ppermute": C.ppermute(x[0], mesh,
                               [(i, (i - 1) % n) for i in range(n)]),
        "bool_all_gather": C.all_gather(x[0] > 0.5, mesh),
        "axis_index": [C.axis_index(mesh, a) for a in mesh.axis_names],
    }
    got = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
           for k, v in got.items()}
    ranks = [None] * n
    dist.all_gather_object(ranks, got)
    return {"ranks": ranks}


def probe_data(seed: int, rank: int, n: int, width: int):
    """Rank ``rank``'s [n, width] f32 operand of :func:`collectives_probe`."""
    return np.random.default_rng(seed * 1000 + rank).random(
        (n, width)).astype(np.float32)


def collectives_expected(seed: int, n: int, width: int = 5,
                         shape: tuple | None = None) -> list:
    """What :func:`collectives_probe` must give on each of ``n`` ranks (a
    mesh of ``shape``, default flat), computed with numpy."""
    shape = shape or (n,)
    xs = [probe_data(seed, r, n, width) for r in range(n)]
    firsts = np.stack([x[0] for x in xs])
    out = []
    for r in range(n):
        a2a = np.stack([xs[e][r] for e in range(n)])
        out.append({
            "all_gather": firsts.reshape(-1), "psum": firsts.sum(0),
            "pmax": firsts.max(0), "pmin": firsts.min(0),
            "psum_scalar": n * (n + 1) // 2, "all_to_all": a2a,
            "all_to_all_flat": a2a, "ppermute": xs[(r + 1) % n][0],
            "bool_all_gather": firsts.reshape(-1) > 0.5,
            "axis_index": [int(c) for c in np.unravel_index(r, shape)],
        })
    return out


def round_costs(sg, src: int, mesh) -> list:
    """What a round of the sharded BFS costs in each rank, warm, wall ms
    (fenced with a synchronise on a card, the mean of ``ROUND_RUNS``
    calls): the boundary exchange (an all_gather of f32[Vs] and of
    bool[Vs]), a scalar ``pmax``, the loop test ``sharded._any`` (a device
    read and an all-reduce), and the round's local work (the gather of
    the frontier at the edges' sources and the count of each vertex's
    frontier in-neighbours). On a card, rank 0 adds one BFS from ``src``
    under torch.profiler (``utils/trace_stats.device_profile``: busy time
    and idle share). Returns every rank's dict, in rank order."""
    def wall_ms(fn):
        times, _ = timed_runs(ROUND_RUNS + 1, fn, mesh.device)
        return float(np.mean(times[1:]))

    x = torch.zeros(sg.v_per_shard, device=mesh.device)
    front = x > 0
    at_src = C.all_gather(front, mesh)
    out = {
        "rank": mesh.rank, "edges": int(sg.d_src.numel()),
        "all_gather_f32_ms": wall_ms(lambda: C.all_gather(x, mesh)),
        "all_gather_bool_ms": wall_ms(lambda: C.all_gather(front, mesh)),
        "pmax_scalar_ms": wall_ms(lambda: C.pmax(1, mesh)),
        "loop_test_ms": wall_ms(lambda: sharded._any(front, mesh)),
        "round_local_ms": wall_ms(lambda: sharded._local_reduce(
            sg, at_src[sg.d_src.long()], None, "sum")),
    }
    if mesh.device.type == "cuda":
        from gunrock_tpu_torch.utils.trace_stats import device_profile

        prof = device_profile(lambda: sharded.bfs(sg, src, mesh))
        if mesh.rank == 0:
            out["bfs_profile"] = prof
    ranks = [None] * mesh.size
    dist.all_gather_object(ranks, out)
    return ranks
