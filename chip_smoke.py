#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gunrock_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each raising on failure:

1. setup: the card's name and power limit, torch/CUDA/nvcc versions, and
   the build of every kernel from ``gunrock_tpu_torch/csrc``.
2. kernels: each kernel against its plain PyTorch version, first at an
   edge shape (V=1000, W=128; an edgeless layout), then at the main path's
   shapes (R-MAT scale 18, edge factor 16, seed 1, degree-sorted;
   W=2048/C=256 pull layout; K=32 for the SpMM), with CUDA-event times of
   the kernel, its plain version and, where one exists, one PyTorch call
   computing the same function. The BFS push step exactly on two random
   frontiers, every frontier of a search from the top-degree vertex,
   that vertex alone and every vertex at once, and as one device
   operation a call.
   The semiring family's kernels (dense pass, fused HITS pass, SSSP push
   step) are checked the same way, also with negative values and a row
   window no chunk reaches, at the W=2048/C=256 pull layouts and the
   W=4096/C=1024 PageRank and HITS layouts; the push step exactly over
   every frontier of a search, the top-degree vertex alone and every
   vertex at once.
   The frontier family's kernels (fused max/min pass, frontier-sparse
   SpMM, Boruvka min-cut pass) likewise, over the symmetrized coloring
   layouts and the doubled canonical MST layout; the min-cut pass exactly
   with V, V/8 and 1 random roots and with the real roots after rounds 1
   and 2 of one ``mst.run``.
   The analysis family's kernels (the Weiszfeld step, dense and
   chunk-skipping, and the banded gather) likewise,
   over the unit push layout with 10% of the vertices labeled and a real
   slab of the slabbed triangle count; with them the frontier-sparse
   semiring pass on every level of a BC search, the SpMM on every
   backward level of a BC batch, and the frontier-sparse SpMM on a row
   block of A, as the dense SpGEMM calls it. The banded gather also bit
   for bit at its edge shapes (``probes/banded_cases.edge_cases``:
   span_rows 1 and 200, the sink window at the table's last rows, indices
   below and above their window, one block, blocks of 128, an idx view
   off 16-byte alignment for the scalar instance).
   The probes' kernels likewise: the dense pass's floor modes (stream,
   gather) on the valued pull layout, the gather at every shape of the two
   gather probes, the bulk block copy at the dma probe's case and at one
   x-window per chunk.
   The span kernels of the sparse and dense semiring passes over their
   whole range: the three semirings, unit and valued, a full, a 10% and an
   empty frontier with and without out_mask, at W=2048/C=256 and
   W=4096/C=1024, at the edge shapes also with spans of 3 chunks, with
   C=125 (scalar loads) and edgeless. Likewise the span kernels of the
   fused HITS pass (unit push layouts: padding slots, spans of 3 chunks,
   C=125, edgeless; at R-MAT 18 W=4096/C=1024 and W=2048/C=256) and of the
   frontier-sparse SpMM (K = 1, 8, 32, 33 and 512; a full, a 10% and an
   empty frontier with and without out_mask; one-hot, signed-delta and
   float X; at R-MAT 18 over greedy coloring's layout), of the dense SpMM
   (K = 1, 4, 8, 32, 33; one-hot, signed-delta and float X nonzero on
   all, 10% and none of the rows; through the keep pass at its own tiles
   and at row tiles of 32 rows, and walking where one tile holds the
   window; at R-MAT 18 over the unit and valued pull layouts) and of the
   fused max/min pass (full, 10% and empty frontiers with and without
   out_mask, and an all-zero x, bit for bit; at R-MAT 18 over Luby's
   layout).
   The async sweep's kernels against their plain loops (min-plus bit for
   bit with equal sweep and pass counts; PageRank within rtol 1e-5, sweeps
   within one, two launches bit-equal) on the R-MAT 18 graph and a
   Delaunay mesh of 2^16 points (natural and RCM order), and at the edge
   shapes in 1 to 10,000 blocks (clamped to V), 2 blocks (every sweep's
   turnaround repeats a block), blocks of fewer edges than a warp tile, a
   hub whose in-edges span more warp tiles than the grid has warps,
   edgeless, with a sweep cap of 0 and 1 for both kernels.
   The multi-source BFS kernels (``msbfs_start``, ``msbfs_pull``) bit for
   bit against their plain versions, the start and every level of three
   batches (K=32 from the 32 highest-degree vertices and from random
   sources with one repeated, K=40 from random sources) in the normal
   and the checked build, then ``msbfs_pull`` timed on the level that
   needs the most slots.
   Then the edge shapes again, 20 times, on the range-checking build.
3. main paths, each with launch counts reset just before and read just
   after; every kernel of the path must have launched:
   a. BFS: ``bfs.run`` (direction-optimizing BFS) from the 8
      highest-degree vertices, each checked against the CPU oracle, then
      multi-source BFS over the 32 highest-degree vertices; then DO-BFS
      and DO-SSSP with their levels replayed from captured CUDA graphs,
      bit for bit against the same searches run eagerly (the checked
      build), with the levels captured and replayed;
   b. the semiring family: ``sssp.run`` from the 8 highest-degree
      vertices and once with the dense min_plus pass, ``pr.run``,
      ``pr.run_batch`` over four dampings, ``hits.run`` and ``spmv.run``,
      each checked against its CPU oracle;
   c. the frontier family: ``color.run`` (greedy, rank, luby; validity
      checked on the card over all edges), ``mst.run`` (weight and
      components against scipy), ``kcore.run`` (against the CPU oracle),
      ``ppr.run`` from the top-degree vertex and ``ppr.run_batch`` over 8
      seeds (against the CPU oracle);
   d. the analysis family: ``bc.run`` from the top-degree vertex on both
      paths and ``bc_batch_kernel`` over 8 and 32 sources (against the
      float64 Brandes oracle), ``tc.run`` in one sort, in five slabs and
      by the probe kernel (equal counts, equal to the CPU oracle's),
      ``spgemm.run`` counting A.A by both strategies and eight row blocks
      materialized by both (against scipy), ``geo.run`` on the kernel path
      (the invariants oracle) against the scatter-sum path, and a second
      run of each path bit for bit;
   e. the measurement path: the four probe drivers
      (``gunrock_tpu_torch.probes``): the dense pass split into stream,
      gather and scatter at R-MAT 18, W=2048/C=256 with the card's bound,
      the gathers (checked against numpy) and their rates, the block copy
      at the dma probe's case and at one window per chunk, with its rate
      beside ``x.view(-1, W)[meta].sum()``; each time comes with the
      device time of a ``torch.profiler`` trace (``utils/trace_stats``);
   f. the operator layer (``ops/``, ``framework/frontier.py``):
      ``advance_semiring`` (plus_times, min_plus, max_times; forward and
      backward; every vertex active and a mid-search BFS level) by the
      bucketed kernels (B3; B1 after B2) against the plain segmented
      path, min and max bit for bit with the same infinities, plus_times
      by ``sum_check`` and, on a unit-weight copy with integer x, exactly
      equal; ``advance`` and ``neighbor_reduce`` with Python lambdas
      exactly against numpy; ``filter_queue``, ``uniquify``,
      ``queue_to_mask`` and ``mask_to_queue`` on a 1M-entry queue exactly
      against numpy; a queue BFS and a Bellman-Ford SSSP written on the
      operators against ``bfs.run``/``sssp.run`` (equal; rtol 1e-5), and
      ``bfs.run`` through the BFS enactor against the DO run;
   g. the async sweep (``experimental/async_sweep.py``, one launch of
      ``csrc/async_sweep.cu`` a search, asserted): ``sssp_async``,
      ``bfs_async`` and ``pr_async`` (tol 1e-7 and 1e-9) on the R-MAT 18
      graph from its top-degree vertex, and ``sssp_async`` natural and
      rcm and ``bfs_async`` rcm on a Delaunay mesh of 2^18 points; BFS
      depths equal ``bfs.run``'s, SSSP within rtol 1e-5 of ``sssp.run``
      (R-MAT) and of scipy's Dijkstra (mesh), rcm in no more sweeps than
      natural, PageRank at tol 1e-9 within rtol 1e-4 of the float64 fixed
      point and at 1e-7 within rtol 1e-2 / atol 1e-6 of ``pr.run``, two
      runs bit-equal;
   h. the distributed layer (``parallel/``, one process a shard): four
      ranks share the card under gloo, their collectives staged through
      the host, and run every sharded algorithm on the R-MAT 18 graph in
      all_gather mode (bfs, sssp, pagerank, spmv and hits also through
      their kernels on each rank's own layout: B1 planned by B2, B3) and
      BFS and SSSP on the 2^18-point Delaunay mesh in halo mode, with and
      without layouts; one rank runs BFS and SSSP through their kernels
      and PageRank under NCCL; each result is held against the
      single-device port's on the card, each collective against numpy,
      and each layout case's kernels must launch in every rank (the
      launches, summed over ranks, join the kernel table); then the bfs
      and pr CLIs with ``--devices 4 --validate`` on the R-MAT graph;
   i. graph loading through the native host IO (``_native/``, host C++
      built with ``c++``; the phase fails without it): the R-MAT graph
      before ``degree_sort`` written as a ``real general`` .mtx and its
      symmetrized edges as a ``pattern symmetric`` one, each loaded onto
      the card by ``load_graph_file`` through the native parse and sort
      (``_native.CALLS`` must grow) and through numpy's, every Graph
      array bit-equal between the two and, for the general file, with
      ``rmat_graph``'s; the parse, each sort and the host-to-device copies
      timed, and the setup (``rmat_graph`` + ``degree_sort``) both ways;
      then bfs and sssp ``--validate`` on the general file and bfs on the
      symmetric one;
   j. Graph's accessors and degree statistics, batched on the card over
      the R-MAT graph and the symmetrized loop-free graph that triangle
      counting counts on, each against numpy on the host arrays: the
      counts and degrees of every vertex, the source of every edge,
      ``get_edge`` of every edge and as many seeded pairs, the
      intersection count of every undirected edge (summing to 3 x
      ``tc.run``'s triangles) and of 10,000 sampled and 32 top-degree
      pairs, ``intersect_neighbors`` of the two top hubs, the average
      degree and its deviation (rtol 1e-5 of numpy's float64), the degree
      histogram bin for bin (also at degrees around every power of two up
      to 2^16), and ``Timer.end(x)`` on a CUDA tensor.
4. CLIs: bfs (twice; the first also with ``--export_metrics``, whose JSON
   is checked: the reference's keys, the card in ``gpuinfo``), sssp, pr,
   hits, spmv, color, mst, kcore, ppr, bc (one source, all sources), tc,
   spgemm (esc, dense), geo, bfs ``--mode async`` and sssp ``--mode async
   --ordering rcm`` with ``--validate``, all started together.
5. the regression battery (``examples/regression.py``) on the card: one
   process per vendored graph family, all seven started together, each
   running its CLI list with ``--validate`` and checking the invariants of
   ``datasets/expected.json``.

Output: the ``nvidia-smi`` name/power-limit line first, a bench line with
bench.py's keys, a ``{"level_graphs": ...}`` line, a
``{"semiring_family": ...}`` line, a
``{"frontier_family": ...}`` line, an ``{"analysis_family": ...}`` line
(each with roofline columns from ``utils/roofline``), the probes' lines
and a ``{"measurement": ...}`` line, an ``{"operators": ...}`` line, an
``{"async": ...}`` line (each case's sweeps, block passes, wall and device
ms, idle share and bound), a ``{"distributed": ...}`` line (per sharded
case the wall ms of a run beside the single-device ms, the exchange mode
and bytes, the backend, each rank's launches of the layout cases, the
phase's seconds), an ``{"ingest": ...}`` line (the files' sizes, each
load's pieces in seconds on both paths, the setup both ways, the CLIs'
lines, the phase's seconds), a ``{"graph_accessors": ...}`` line (the
wall ms of each batched call, the intersection pass's products, blocks and
peak bytes, the statistics), an
``{"export": ...}`` line, a ``{"regression_battery": ...}`` line with
each family's seconds, the seconds of each phase, then the kernel table as one JSON line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, without a CUDA
device or without the package beside it.

``edge_shapes_main()`` runs only the build and the edge-shape checks, for
``compute-sanitizer``; ``edge_shapes_main(checked=True, repeat=20)`` runs
them on the range-checking build of the kernels (``_build.py``), which
stands in where no sanitizer runs.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
try:  # the bound column (the card's published peaks) and the profiles
    from gunrock_tpu_torch.probes import async_cases as ac
    from gunrock_tpu_torch.probes import banded_cases
    from gunrock_tpu_torch.utils.roofline import bound_ms, roofline
    from gunrock_tpu_torch.utils.trace_stats import device_profile
except ImportError as exc:  # run without the package beside it
    sys.exit(f"chip_smoke: gunrock_tpu_torch is not beside this script ({exc})")

SCALE, EDGE_FACTOR, SEED, K = 18, 16, 1, 32
TC_SLABS = banded_cases.TC_SLABS  # slabs of the slabbed triangle count
CHECKED_RUNS = 20  # edge-shape runs on the range-checking build
# the keys of the metrics JSON (the reference's schema "2022-10-28", as the
# JAX package's utils/performance.py writes it)
EXPORT_KEYS = {
    "engine", "schema", "primitive", "graph_file", "graph_type",
    "num_vertices", "num_edges", "process_times", "avg_process_time",
    "stddev_process_time", "min_process_time", "max_process_time", "mteps",
    "avg_mteps", "min_mteps", "max_mteps", "edges_visited", "nodes_visited",
    "search_depths", "avg_search_depth", "min_search_depth",
    "max_search_depth", "srcs", "tags", "command_line", "git_commit_sha",
    "compiler", "compiler_version", "gpuinfo", "sysinfo", "time",
}


def kernels_of_one_call(fn, tries: int = 3) -> dict:
    """The device kernels (name -> launches) of one call of ``fn``, from a
    torch.profiler profile. The profiler at times records no device event
    of a run ("not measured"); then the call is profiled again, at most
    ``tries`` times, and an empty dict is returned if none is measured."""
    for _ in range(tries):
        prof = device_profile(fn)
        if "top_us" in prof:
            return {k: n for k, (_, n) in prof["top_us"].items()}
    return {}


def time_ms(torch, fn, n: int = 20) -> float:
    """Mean milliseconds per call of ``fn`` over ``n`` warm calls, by CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


LIBRARY = " library"  # timed[name + LIBRARY]: the library call of row name


def library(torch, timed: dict, name: str, fn) -> float:
    """:func:`time_ms` of ``fn``, the one PyTorch call computing kernel
    ``name``'s function, kept in ``timed`` so that check_kernels also
    takes its device time (``library_device_ms``)."""
    timed[name + LIBRARY] = fn
    return time_ms(torch, fn)


def max_abs_err(torch, got, want, exact: bool, rtol: float = 1e-5,
                what: str = "") -> float:
    """Max |got - want| over finite entries; raises on a mismatch (bit for
    bit when ``exact``, else within ``rtol``) or on differing infinities."""
    got, want = got.float(), want.float()
    if not torch.equal(torch.isinf(got), torch.isinf(want)) or not torch.equal(
            torch.sign(got[torch.isinf(got)]), torch.sign(want[torch.isinf(want)])):
        raise AssertionError(f"{what}: infinities differ")
    fin = ~torch.isinf(want)
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    if exact:
        if err != 0.0:
            raise AssertionError(f"{what}: not exact, max abs err {err}")
    else:
        torch.testing.assert_close(got[fin], want[fin], rtol=rtol, atol=1e-6,
                                   msg=lambda m: f"{what}: {m}")
    return err


def record(torch, errs: dict, name: str, got, want, exact: bool,
           what: str) -> None:
    """max_abs_err of one comparison, kept as errs[name]'s maximum."""
    e = max_abs_err(torch, got, want, exact, what=f"{name} {what}")
    errs[name] = max(errs.get(name, 0.0), e)


def both(torch, kernel, plain, *args, **kw):
    """(kernel(...), plain(...)) on the same inputs, with a sync between,
    so that a fault surfaces at the kernel that made it."""
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    return got, plain(*args, **kw)


def compare_kernels(torch, graph, layouts, k: int) -> dict:
    """Each kernel against its plain version on ``graph``'s shapes; raises
    on a mismatch. Returns {kernel: max abs error}. Exact for the chunk
    plan, the push step, max/min and 0/1 counts; plus_times on floats by
    :func:`sum_check` (f32 atomics sum in another order than the plain
    scatter_reduce / index_add_)."""
    from gunrock_tpu_torch.algorithms import bfs
    from gunrock_tpu_torch.ops.kernels import chunkplan, semiring, spmm
    from gunrock_tpu_torch.utils.limits import UNREACHED

    dev = graph.device
    V = graph.n_vertices
    lay = layouts["unit"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    full = torch.ones(V, dtype=torch.bool, device=dev)
    tenth = torch.rand(V, device=dev, generator=gen) < 0.1
    half = torch.rand(V, device=dev, generator=gen) < 0.5
    errs = {}

    def err(name, got, want, exact, what):
        record(torch, errs, name, got, want, exact, what)

    # the chunk plan: the mask exactly, the queue element for element (the
    # active ids ascending), also with every source active (None), on an
    # empty frontier and as the span passes ask for it (no queue)
    for active in (full, tenth, ~full, None):
        for om in (None, half):
            (ch, queue, count), (want, want_q, want_n) = both(
                torch, chunkplan.chunk_activity, chunkplan.chunk_activity_plain,
                lay, active, om)
            err("chunk_activity", ch, want, True, "mask")
            n = int(want_n)
            if int(count) != n or not torch.equal(queue[:n], want_q[:n]):
                raise AssertionError(
                    f"chunk_activity: queue of {int(count)} != the plain "
                    f"version's {n} ascending active chunk ids")
            ch, no_q, no_n = chunkplan.chunk_activity(lay, active, om,
                                                      queue=False)
            torch.cuda.synchronize()
            if no_q is not None or no_n is not None:
                raise AssertionError("chunk_activity: a queue not asked for")
            err("chunk_activity", ch, want, True, "mask, no queue")

    name = "bucketed_semiring_spmv_sparse"
    for sr in ("plus_times", "max_times", "min_plus"):
        for unit in (True, False):
            L = layouts["unit" if unit else ("big" if sr == "min_plus" else "valued")]
            for active in (full, tenth):
                noise = torch.randn(V, device=dev, generator=gen)
                if sr == "min_plus":  # negative messages: the signed atomic min
                    x = torch.where(active, noise, torch.inf)
                elif sr == "max_times":
                    x = torch.where(active, noise, 0.0)
                else:
                    x = torch.where(active, noise.abs(), 0.0)
                for om in (None, half):
                    got, want = both(
                        torch, semiring.bucketed_semiring_spmv_sparse,
                        semiring.bucketed_semiring_spmv_sparse_plain,
                        L, x, active, sr, out_mask=om, unit=unit)
                    if sr == "plus_times":
                        ch_act = chunkplan.chunk_activity_plain(L, active, om)[0]
                        e = sum_check(torch, f"{name} {sr} unit={unit}", got,
                                      *layout_terms(L, x, unit, ch_act), want)
                        errs[name] = max(errs.get(name, 0.0), e)
                    else:
                        err(name, got, want, True, f"{sr} unit={unit}")
    for active in (full, tenth):  # the BFS pull itself: 0/1 counts, exact
        got, want = both(
            torch, semiring.bucketed_semiring_spmv_sparse,
            semiring.bucketed_semiring_spmv_sparse_plain,
            lay, active.float(), active, "plus_times", out_mask=half, unit=True)
        err(name, got, want, True, "0/1")

    x01 = (torch.rand((V, k), device=dev, generator=gen) < 0.05).float()
    xr = torch.rand((V, k), device=dev, generator=gen)
    err("bucketed_spmm",
        *both(torch, spmm.bucketed_spmm, spmm.bucketed_spmm_plain, lay, x01), True, "0/1")
    got, want = both(torch, spmm.bucketed_spmm, spmm.bucketed_spmm_plain, lay, xr)
    errs["bucketed_spmm"] = max(errs["bucketed_spmm"], sum_check(
        torch, "bucketed_spmm float", got, *layout_terms(lay, xr, False), want))

    # the push step: two random frontiers over a 30%-reached vector, every
    # frontier of a search from the top-degree vertex, every vertex at
    # once over the search's middle distances, and that vertex alone over
    # them with every other of its out-neighbours unreached again
    reached = torch.rand(V, device=dev, generator=gen) < 0.3
    dist0 = torch.where(reached, 1, UNREACHED).to(torch.int32)
    cases = [(f"random {p}", reached & (torch.rand(
        V, device=dev, generator=gen) < p), dist0, 1) for p in (0.002, 0.2)]
    hub = int(torch.argmax(graph.out_degrees()))
    states = bfs_frontiers(torch, graph, hub)
    cases += [(f"level {it}", front, d, it) for front, d, it in states]
    _, d_mid, it_mid = states[len(states) // 2]
    d_hub = d_mid.clone()
    d_hub[graph.col_indices[graph.row_offsets[hub]:graph.row_offsets[
        hub + 1]:2].long()] = UNREACHED
    alone = torch.zeros(V, dtype=torch.bool, device=dev)
    alone[hub] = True
    cases += [("single hub", alone, d_hub, it_mid),
              ("full frontier", torch.ones_like(alone), d_mid, it_mid)]
    for what, front, d, it in cases:
        d_k, d_p = d.clone(), d.clone()
        new_k, _ = bfs.bfs_push_step(graph, front, d_k, it, 0)
        torch.cuda.synchronize()
        new_p, _ = bfs.bfs_push_step_plain(graph, front, d_p, it)
        err("bfs_push_step", new_k, new_p, True, f"{what} new_mask")
        err("bfs_push_step", d_k, d_p, True, f"{what} distances")
    return errs


def bfs_frontiers(torch, graph, source: int) -> list:
    """[(frontier, distances, level)] before each level of a search from
    ``source``, by the plain level-synchronous step (the frontiers every
    BFS path of the port walks)."""
    from gunrock_tpu_torch.algorithms import bfs
    from gunrock_tpu_torch.utils.limits import UNREACHED

    V = graph.n_vertices
    dist = torch.full((V,), UNREACHED, dtype=torch.int32, device=graph.device)
    dist[source] = 0
    front = torch.zeros(V, dtype=torch.bool, device=graph.device)
    front[source] = True
    states = []
    while bool(front.any()):
        states.append((front, dist, len(states)))
        front, dist, _ = bfs.bfs_step(graph, front, dist, None, len(states) - 1)
    return states


def compare_span_kernels(torch, layouts, keys) -> dict:
    """B1 (the frontier-sparse pass) and B3 (the dense pass), the span
    kernels, against their plain versions over each layout of ``keys``:
    the three semirings, unit and valued (a unit pass ignores the values),
    B1 on a full, a 10% and an empty frontier, each with and without an
    out_mask, and the BFS pull's 0/1 counts. Exact for min/max and the
    counts; float plus_times by :func:`sum_check`. An edgeless layout must
    give the identity. Returns {kernel: max abs error}."""
    from gunrock_tpu_torch.ops.kernels import chunkplan, semiring

    errs = {}
    b1, b3 = "bucketed_semiring_spmv_sparse", "bucketed_semiring_spmv"
    for key in keys:
        L = layouts[key]
        V, dev = L.n_vertices, L.device
        gen = torch.Generator(device=dev).manual_seed(SEED + 9)
        full = torch.ones(V, dtype=torch.bool, device=dev)
        fronts = {"full": full,
                  "10%": torch.rand(V, device=dev, generator=gen) < 0.1,
                  "empty": torch.zeros(V, dtype=torch.bool, device=dev)}
        half = torch.rand(V, device=dev, generator=gen) < 0.5
        for sr in ("plus_times", "max_times", "min_plus"):
            ident = torch.inf if sr == "min_plus" else 0.0
            for unit in (True, False):
                for front, active in (("dense", full), *fronts.items()):
                    noise = torch.randn(V, device=dev, generator=gen)
                    if sr == "min_plus":  # inactive: the gather identity
                        x = torch.where(active, noise, torch.inf)
                    elif sr == "max_times":  # negative messages too
                        x = torch.where(active, noise, 0.0)
                    else:
                        x = torch.where(active, noise.abs(), 0.0)
                    for om in ((None,) if front == "dense" else (None, half)):
                        what = (f"{sr} unit={unit} {key} W={L.window}/"
                                f"C={L.chunk} {front} out_mask={om is not None}")
                        if front == "dense":
                            name = b3
                            got, want = both(
                                torch, semiring.bucketed_semiring_spmv,
                                semiring.bucketed_semiring_spmv_plain, L, x,
                                sr, unit=unit)
                            ch_act = None
                        else:
                            name = b1
                            got, want = both(
                                torch, semiring.bucketed_semiring_spmv_sparse,
                                semiring.bucketed_semiring_spmv_sparse_plain,
                                L, x, active, sr, out_mask=om, unit=unit)
                            ch_act = (chunkplan.chunk_activity_plain(
                                L, active, om)[0] if L.n_chunks else None)
                        if L.n_chunks == 0:
                            if not bool((got == ident).all()):
                                raise AssertionError(f"{name} {what}: edgeless "
                                                     "layout, not the identity")
                            errs[name] = errs.get(name, 0.0)
                        elif sr == "plus_times":
                            errs[name] = max(errs.get(name, 0.0), sum_check(
                                torch, f"{name} {what}", got,
                                *layout_terms(L, x, unit, ch_act), want))
                        else:
                            record(torch, errs, name, got, want, True, what)
        for front, active in fronts.items():  # the BFS pull: 0/1 counts
            got, want = both(torch, semiring.bucketed_semiring_spmv_sparse,
                             semiring.bucketed_semiring_spmv_sparse_plain, L,
                             active.float(), active, "plus_times",
                             out_mask=half, unit=True)
            record(torch, errs, b1, got, want, True, f"0/1 {key} {front}")
    return errs


def compare_hits_spmm_spans(torch, layouts, b8_keys, b5_keys, ks,
                            slice_k: int) -> dict:
    """B8 (the fused HITS pass) and B5 (the frontier-sparse SpMM), the span
    kernels, against their plain versions. B8 over each layout of
    ``b8_keys`` (unit push layouts: padding slots in the chunks' tails,
    which the auth side must skip by the row sentinel) on mixed-sign auth
    with exact zeros and positive hub, both sums by :func:`sum_check`. B5
    over each layout of ``b5_keys`` at every K of ``ks``: a full, a 10% and
    an empty frontier, each with and without a 50% out_mask, on one-hot X
    and signed one-hot deltas (zero off the frontier, as coloring makes
    them) and on float X (nonzero everywhere: an active chunk's inactive
    sources count too); exact where the values and X are small integers,
    else :func:`sum_check`. The plain version is held against the kernel
    in slices of ``slice_k`` columns (it is column-separable), so that its
    [slots, K] intermediates stay small at R-MAT 18. An edgeless layout
    must give zeros. Returns {kernel: max abs error}."""
    from gunrock_tpu_torch.ops.kernels import chunkplan, hits_fused, spmm
    from gunrock_tpu_torch.ops.kernels.layout import slot_indices

    errs = {}

    def keep(name, e):
        errs[name] = max(errs.get(name, 0.0), e)

    name = "hits_fused_pass"
    for key in b8_keys:
        L = layouts[key]
        V, dev = L.n_vertices, L.device
        gen = torch.Generator(device=dev).manual_seed(SEED + 11)
        auth = torch.randn(V, device=dev, generator=gen)
        auth = torch.where(torch.rand(V, device=dev, generator=gen) < 0.2,
                           0.0, auth)
        hub = torch.rand(V, device=dev, generator=gen)
        (h_k, a_k), (h_p, a_p) = both(torch, hits_fused.hits_fused_pass,
                                      hits_fused.hits_fused_pass_plain, L,
                                      auth, hub)
        if L.n_chunks == 0:
            if bool(h_k.any()) or bool(a_k.any()):
                raise AssertionError(f"{name} {key}: edgeless layout, not 0")
            keep(name, 0.0)
            continue
        src, dst, _ = slot_indices(L)
        what = f"{name} {key} W={L.window}/C={L.chunk} P-spans={L.n_spans}"
        keep(name, sum_check(torch, f"{what} hub_raw", h_k, src,
                             auth[dst].double(), h_p))
        keep(name, sum_check(torch, f"{what} auth_raw", a_k, dst,
                             hub[src].double(), a_p))

    name = "bucketed_spmm_sparse"
    for key in b5_keys:
        L = layouts[key]
        V, dev = L.n_vertices, L.device
        gen = torch.Generator(device=dev).manual_seed(SEED + 12)
        int_values = bool(torch.equal(L.values, L.values.round()))
        fronts = {"full": torch.ones(V, dtype=torch.bool, device=dev),
                  "10%": torch.rand(V, device=dev, generator=gen) < 0.1,
                  "empty": torch.zeros(V, dtype=torch.bool, device=dev)}
        half = torch.rand(V, device=dev, generator=gen) < 0.5
        for k in ks:
            onehot = torch.nn.functional.one_hot(
                torch.randint(0, k, (V,), device=dev, generator=gen), k).float()
            sign = torch.randint(-1, 2, (V, 1), device=dev, generator=gen)
            xs = {"one-hot": onehot, "signed": onehot * sign,
                  "float": torch.randn((V, k), device=dev, generator=gen)}
            for front, active in fronts.items():
                for om in (None, half):
                    ch_act = (chunkplan.chunk_activity_plain(L, active, om)[0]
                              if L.n_chunks else None)
                    for xk, x in xs.items():
                        if xk != "float":
                            x = torch.where(active[:, None], x, 0.0)
                        what = (f"{name} {key} W={L.window}/C={L.chunk} K={k} "
                                f"{front} out_mask={om is not None} {xk}")
                        got = spmm.bucketed_spmm_sparse(L, x, active, om)
                        torch.cuda.synchronize()
                        if L.n_chunks == 0:
                            if bool(got.any()):
                                raise AssertionError(f"{what}: edgeless, not 0")
                            keep(name, 0.0)
                            continue
                        for j in range(0, k, slice_k):
                            xj = x[:, j:j + slice_k].contiguous()
                            want = spmm.bucketed_spmm_sparse_plain(L, xj, active,
                                                                   om)
                            gj = got[:, j:j + slice_k].contiguous()
                            if int_values and xk != "float":
                                record(torch, errs, name, gj, want, True, what)
                            else:
                                keep(name, sum_check(
                                    torch, f"{what} columns {j}+", gj,
                                    *layout_terms(L, xj, False, ch_act), want))
    return errs


def compare_spmm_minmax_spans(torch, layouts, b4_keys, b6_keys, ks,
                              slice_k: int) -> dict:
    """B4 (the dense SpMM) and B6 (the fused max/min pass), the span
    kernels, against their plain versions. B4 over each layout of
    ``b4_keys`` at every K of ``ks``, on one-hot, signed one-hot and float
    X whose rows are nonzero on all, 10% or none of the vertices (all-zero
    rows, which the row flags drop), through the keep pass at its own
    tiles and at row tiles of 32 rows, and through the walking tile pass
    where one tile holds the whole window; exact where the values and X
    are small integers, else :func:`sum_check`, the plain version in
    slices of
    ``slice_k`` columns. B6 over each layout of ``b6_keys`` (x >= 0,
    values >= 0) on a full, a 10% and an empty frontier, each with and
    without out_mask (the frontier itself, as Luby's rounds call it), and
    on an all-zero x (ymin stays _BIG): bit for bit. An edgeless layout
    must give the identity. Returns {kernel: max abs error}."""
    from gunrock_tpu_torch.ops.kernels import semiring, spmm

    errs = {}

    def keep(name, e):
        errs[name] = max(errs.get(name, 0.0), e)

    name = "bucketed_spmm"
    for key in b4_keys:
        L = layouts[key]
        V, dev = L.n_vertices, L.device
        gen = torch.Generator(device=dev).manual_seed(SEED + 13)
        int_values = bool(torch.equal(L.values, L.values.round()))
        rows = {"all": torch.ones(V, dtype=torch.bool, device=dev),
                "10%": torch.rand(V, device=dev, generator=gen) < 0.1,
                "none": torch.zeros(V, dtype=torch.bool, device=dev)}
        for k in ks:
            onehot = torch.nn.functional.one_hot(
                torch.randint(0, k, (V,), device=dev, generator=gen), k).float()
            sign = torch.randint(-1, 2, (V, 1), device=dev, generator=gen)
            xs = {"one-hot": onehot, "signed": onehot * sign,
                  "float": torch.randn((V, k), device=dev, generator=gen)}
            # the keep pass with its own tiles and with row tiles of 32
            # rows, and the walking tile pass where one tile holds it all
            kt, tile_rows = spmm.tile_shape(k, L.window, True)
            modes = [{"walk": False}, {"walk": False, "tile_rows": 32}]
            if kt >= k and tile_rows >= L.window:
                modes.append({"walk": True})
            for nz, on in rows.items():
                for xk, x in xs.items():
                    x = torch.where(on[:, None], x, 0.0)
                    for mode in modes:
                        what = (f"{name} {key} W={L.window}/C={L.chunk} K={k} "
                                f"rows {nz} {xk} {mode}")
                        got = spmm.bucketed_spmm(L, x, **mode)
                        torch.cuda.synchronize()
                        if L.n_chunks == 0 or nz == "none":
                            if bool(got.any()):
                                raise AssertionError(f"{what}: not 0")
                            keep(name, 0.0)
                            continue
                        for j in range(0, k, slice_k):
                            xj = x[:, j:j + slice_k].contiguous()
                            want = spmm.bucketed_spmm_plain(L, xj)
                            gj = got[:, j:j + slice_k].contiguous()
                            if int_values and xk != "float":
                                record(torch, errs, name, gj, want, True, what)
                            else:
                                keep(name, sum_check(
                                    torch, f"{what} columns {j}+", gj,
                                    *layout_terms(L, xj, False), want))

    name = "bucketed_semiring_spmv_sparse_minmax"
    for key in b6_keys:
        L = layouts[key]
        V, dev = L.n_vertices, L.device
        gen = torch.Generator(device=dev).manual_seed(SEED + 14)
        prio = torch.randperm(V, device=dev, generator=gen).float() + 1.0
        fronts = {"full": torch.ones(V, dtype=torch.bool, device=dev),
                  "10%": torch.rand(V, device=dev, generator=gen) < 0.1,
                  "empty": torch.zeros(V, dtype=torch.bool, device=dev)}
        for front, active in fronts.items():
            for om in (None, active):
                for xk in ("priorities", "zero"):
                    x = (torch.where(active, prio, 0.0) if xk == "priorities"
                         else torch.zeros(V, device=dev))
                    what = (f"{name} {key} W={L.window}/C={L.chunk} {front} "
                            f"out_mask={om is not None} x={xk}")
                    (gmax, gmin), (wmax, wmin) = both(
                        torch, semiring.bucketed_semiring_spmv_sparse_minmax,
                        semiring.bucketed_semiring_spmv_sparse_minmax_plain,
                        L, x, active, om)
                    for g, w, side in ((gmax, wmax, "ymax"), (gmin, wmin, "ymin")):
                        if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                            raise AssertionError(f"{what} {side}: not bit-equal")
                    if xk == "zero" and not (bool((gmax == 0).all()) and bool(
                            (gmin == semiring._BIG).all())):
                        raise AssertionError(f"{what}: not (0, _BIG)")
                    keep(name, 0.0)
    return errs


def sssp_frontiers(torch, graph, source: int) -> list:
    """[(frontier, distances)] before each iteration of a search from
    ``source``, by the plain relaxation (the frontiers every SSSP path
    of the port walks, Jacobi)."""
    from gunrock_tpu_torch.algorithms import sssp

    dist, front = sssp._start(graph, source)
    states = []
    while bool(front.any()):
        states.append((front, dist))
        front, dist = sssp.sssp_step(graph, front, dist)
    return states


F32_ROUNDOFF = 2.0 ** -24
# the largest share of its limit that any sum_check error reached
LIMIT_SHARE = {"max": 0.0}


def sum_check(torch, what: str, got, row, terms, plain=None) -> float:
    """A float plus_times result (f32[V] or f32[V, K]) against the float64
    sum of its terms (``terms`` f64[n] or f64[n, K], added into rows
    ``row``). Atomics add in any order, and the rounding error of an f32
    sum of n terms walks like sqrt(n) * 2^-24 * (sum of |terms|), so each
    row is held within 8x that: well past noise, whatever the order or
    the signs (a cancelled sum is held to its terms, not its result),
    while a bf16 product (2^-9) exceeds it in every row of under ~1,000
    terms, and one missing term exceeds it in any row of under ~16,000
    terms of like size. Raises if ``got``, or ``plain`` (the plain
    version's result), is outside. Returns max |got - plain| (|got - the
    float64 sum| without ``plain``)."""
    V = got.shape[0]

    def seg(t):
        return torch.zeros((V, *t.shape[1:]), dtype=torch.float64,
                           device=got.device).index_add_(0, row, t)

    exact, scale = seg(terms), seg(terms.abs())
    count = seg(torch.ones(row.numel(), dtype=torch.float64, device=got.device))
    count = count.reshape(V, *[1] * (terms.dim() - 1))
    limit = 8 * F32_ROUNDOFF * count.sqrt() * scale
    for side, y in (("kernel", got), ("plain", plain)):
        if y is None:
            continue
        diff = (y.double() - exact).abs()
        excess = diff - limit
        share = diff[limit > 0] / limit[limit > 0]
        if share.numel():
            LIMIT_SHARE["max"] = max(LIMIT_SHARE["max"], float(share.max()))
        if bool((excess > 0).any()):
            i = int(torch.argmax(excess.reshape(V, -1).max(dim=1).values))
            raise AssertionError(
                f"{what} ({side}): {int((excess > 0).sum())} entries past the "
                f"f32 summation limit; row {i} got {y[i].tolist()}, float64 "
                f"sum {exact[i].tolist()}, sum |terms| {scale[i].tolist()}, "
                f"{int(count[i].flatten()[0])} terms")
    ref = exact if plain is None else plain.double()
    return float((got.double() - ref).abs().max()) if V else 0.0


def layout_terms(layout, x, unit: bool, ch_act=None):
    """(row, float64 terms) of a plus_times pass of ``x`` over ``layout``
    (over the chunks in ``ch_act`` when given), for :func:`sum_check`."""
    from gunrock_tpu_torch.ops.kernels.layout import slot_indices

    row, col, slot = slot_indices(layout, ch_act)
    xg = x[col].double()
    if unit:
        return row, xg
    vals = layout.values[slot].double()
    return row, vals * xg if x.dim() == 1 else vals[:, None] * xg


def compare_family_kernels(torch, graph, layouts, source: int) -> dict:
    """The semiring family's kernels against their plain versions; raises
    on a mismatch. Returns {kernel: max abs error}. ``layouts``: "unit",
    "valued", "big" (the pull layouts), "hits" (a unit push layout),
    optionally "pr" (a valued pull layout at another W/C), "neg"/"neg_big"
    (negative values) and "empty_row" (a layout with a row window no
    chunk reaches). Exact for max/min and the push step; plus_times and
    the HITS sums by :func:`sum_check`."""
    from gunrock_tpu_torch.algorithms import sssp
    from gunrock_tpu_torch.ops.kernels import hits_fused, semiring
    from gunrock_tpu_torch.ops.kernels.layout import slot_indices

    dev = graph.device
    V = graph.n_vertices
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    errs = {}

    def err(name, got, want, exact, what):
        record(torch, errs, name, got, want, exact, what)

    name = "bucketed_semiring_spmv"
    for sr in ("plus_times", "max_times", "min_plus"):
        for unit in (True, False):
            keys = ["unit"] if unit else (
                ["big", "neg_big"] if sr == "min_plus" else ["valued", "neg"])
            keys += ["empty_row"]
            keys += ["pr"] if sr == "plus_times" and not unit else []
            for key in keys:
                if key not in layouts:
                    continue
                noise = torch.randn(V, device=dev, generator=gen)
                if sr == "min_plus":  # the SSSP pull input: _BIG off-frontier
                    on = torch.rand(V, device=dev, generator=gen) < 0.5
                    x = torch.where(on, noise, semiring._BIG)
                elif sr == "max_times":
                    x = noise
                else:
                    x = noise.abs()
                got, want = both(torch, semiring.bucketed_semiring_spmv,
                                 semiring.bucketed_semiring_spmv_plain,
                                 layouts[key], x, sr, unit=unit)
                if sr == "plus_times":
                    e = sum_check(torch, f"{name} {sr} unit={unit} {key}", got,
                                  *layout_terms(layouts[key], x, unit), want)
                    errs[name] = max(errs.get(name, 0.0), e)
                else:
                    err(name, got, want, True, f"{sr} unit={unit} {key}")

    name = "hits_fused_pass"
    src, dst, _ = slot_indices(layouts["hits"])
    for _ in range(2):
        auth = torch.rand(V, device=dev, generator=gen)
        hub = torch.rand(V, device=dev, generator=gen)
        (h_k, a_k), (h_p, a_p) = both(torch, hits_fused.hits_fused_pass,
                                      hits_fused.hits_fused_pass_plain,
                                      layouts["hits"], auth, hub)
        errs[name] = max(
            errs.get(name, 0.0),
            sum_check(torch, f"{name} hub_raw", h_k, src, auth[dst].double(), h_p),
            sum_check(torch, f"{name} auth_raw", a_k, dst, hub[src].double(), a_p))

    name = "sssp_push_step"
    states = sssp_frontiers(torch, graph, source)
    # also the top-degree vertex alone (every edge of the expansion one
    # vertex's) and every vertex at once, over a search's middle distances
    # stretched (2d + 1, weights are below 1.1) so that the hub's edges
    # improve its neighbours
    hub = int(torch.argmax(graph.out_degrees()))
    dist = states[len(states) // 2][1] * 2.0 + 1.0
    dist[hub] = 0.0
    alone = torch.zeros(V, dtype=torch.bool, device=dev)
    alone[hub] = True
    cases = [("step", front, d) for front, d in states]
    cases += [("single hub", alone, dist),
              ("full frontier", torch.ones_like(alone), dist)]
    for what, front, d in cases:
        imp_k, new_k = sssp.sssp_push_step(graph, front, d, 0)
        torch.cuda.synchronize()
        imp_p, new_p = sssp.sssp_push_step_plain(graph, front, d)
        err(name, imp_k, imp_p, True, f"{what} improved")
        err(name, new_k, new_p, True, f"{what} distances")
    return errs


def compare_frontier_kernels(torch, graph, layouts, k: int,
                             k_batch: int = 8, real_roots=()) -> dict:
    """The frontier family's kernels against their plain versions; raises
    on a mismatch. Returns {kernel: max abs error}. ``layouts``: "color"
    (symmetrized, loop-free, unit values), "rank" (the same edges, 0/1
    values), "mst" with "mst_ranks" (doubled canonical edges and their
    int32 slot ranks), optionally "empty_row" (a row window no chunk
    reaches). Exact for the max/min pass, the min-cut pass and the SpMM on
    signed one-hot X over 0/1 values; the SpMM on float X or float values
    by :func:`sum_check`. With
    ``out_mask`` the kernel and its plain version run the same chunks, so
    every row is compared. Also the two kernels of the earlier slices at
    the shapes only this family gives them: the frontier-sparse semiring
    pass as rank coloring calls it over "rank" (exact), and the SpMM at
    ``k_batch`` columns over "unit" (the pull layout) as the batched PPR
    does (:func:`sum_check`). The min-cut pass also on each of
    ``real_roots`` (:func:`mst_round_roots`)."""
    from gunrock_tpu_torch.ops.kernels import chunkplan, mst_min, semiring, spmm

    dev = graph.device
    V = graph.n_vertices
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    full = torch.ones(V, dtype=torch.bool, device=dev)
    third = torch.rand(V, device=dev, generator=gen) < 0.3
    errs = {}

    def err(name, got, want, what):
        record(torch, errs, name, got, want, True, what)

    prio = torch.randperm(V, device=dev, generator=gen).float() + 1.0
    keys = [key for key in ("color", "rank", "empty_row") if key in layouts]
    for key in keys:
        L = layouts[key]
        for active in (full, third):
            x = torch.where(active, prio, 0.0)
            onehot = torch.nn.functional.one_hot(
                torch.randint(0, k, (V,), device=dev, generator=gen), k).float()
            sign = torch.randint(-1, 2, (V, 1), device=dev, generator=gen)
            delta = torch.where(active[:, None], onehot * sign, 0.0)
            xr = torch.where(active[:, None],
                             torch.rand((V, k), device=dev, generator=gen), 0.0)
            for om in (None, active):
                name = "bucketed_semiring_spmv_sparse_minmax"
                got, want = both(
                    torch, semiring.bucketed_semiring_spmv_sparse_minmax,
                    semiring.bucketed_semiring_spmv_sparse_minmax_plain,
                    L, x, active, om)
                err(name, got[0], want[0], f"{key} ymax")
                err(name, got[1], want[1], f"{key} ymin")
                if bool(torch.isinf(got[1]).any()):
                    raise AssertionError(f"{name} {key}: ymin holds inf")
                name = "bucketed_spmm_sparse"
                got, want = both(torch, spmm.bucketed_spmm_sparse,
                                 spmm.bucketed_spmm_sparse_plain, L, delta,
                                 active, om, exact=True)
                if key == "empty_row":  # float values: sums round
                    errs[name] = max(errs.get(name, 0.0), sum_check(
                        torch, f"{name} {key} signed one-hot", got,
                        *layout_terms(L, delta, False,
                                      chunkplan.chunk_activity_plain(
                                          L, active, om)[0]), want))
                else:  # 0/1 values: sums of small integers
                    err(name, got, want, f"{key} signed one-hot")
                got, want = both(torch, spmm.bucketed_spmm_sparse,
                                 spmm.bucketed_spmm_sparse_plain, L, xr,
                                 active, om)
                ch_act = chunkplan.chunk_activity_plain(L, active, om)[0]
                errs[name] = max(errs.get(name, 0.0), sum_check(
                    torch, f"{name} {key} float", got,
                    *layout_terms(L, xr, False, ch_act), want))

    # rank coloring's two passes of the frontier-sparse semiring kernel
    # over the 0/1-valued rank layout, as color_kernel_rank_pallas makes
    # them: the count of higher uncolored neighbours, then the max of the
    # packed (rank, priority) keys; both exact (small integers in f32)
    name = "bucketed_semiring_spmv_sparse"
    L = layouts["rank"]
    shift = max(0, max(1, (V - 1).bit_length()) - 18)
    inv1 = ((V - 1 - torch.arange(V, dtype=torch.int32, device=dev))
            >> shift) + 1
    mult = ((V - 1) >> shift) + 2
    for unc in (full, third):
        got, want = both(torch, semiring.bucketed_semiring_spmv_sparse,
                         semiring.bucketed_semiring_spmv_sparse_plain,
                         L, unc.float(), unc, "plus_times", out_mask=unc)
        err(name, got, want, "rank layout plus_times")
        rankc = torch.clamp(want, max=31).to(torch.int32)
        pack = torch.where(unc, (rankc * mult + inv1).float(), 0.0)
        got, want = both(torch, semiring.bucketed_semiring_spmv_sparse,
                         semiring.bucketed_semiring_spmv_sparse_plain,
                         L, pack, unc, "max_times", out_mask=unc)
        err(name, got, want, "rank layout max_times")

    # the batched PPR's SpMM: k_batch residual columns over the unit pull
    # layout, a sparse wave and a full one
    name = "bucketed_spmm"
    L = layouts["unit"]
    for active in (third, full):
        xb = torch.where(active[:, None], torch.rand(
            (V, k_batch), device=dev, generator=gen), 0.0)
        got, want = both(torch, spmm.bucketed_spmm, spmm.bucketed_spmm_plain,
                         L, xb)
        errs[name] = max(errs.get(name, 0.0), sum_check(
            torch, f"{name} K={k_batch} float", got,
            *layout_terms(L, xb, False), want))

    name = "bucketed_min_rank_cut"
    cases = [("mst", layouts["mst"], layouts["mst_ranks"])]
    if "empty_row" in layouts:
        L = layouts["empty_row"]
        cases.append(("empty_row", L, torch.randint(
            0, 1 << 20, (L.n_chunks * L.chunk,), device=dev, generator=gen,
            dtype=torch.int32)))
    for key, L, ranks in cases:
        for n_roots in (V, max(2, V // 8), 1):  # 1: no cut edge anywhere
            roots = torch.randint(0, n_roots, (V,), device=dev, generator=gen,
                                  dtype=torch.int32)
            got, want = both(torch, mst_min.bucketed_min_rank_cut,
                             mst_min.bucketed_min_rank_cut_plain, L, ranks,
                             roots)
            err(name, got, want, f"{key} {n_roots} roots")
            if n_roots == 1 and not bool((got == mst_min.NO_CUT).all()):
                raise AssertionError(f"{name} {key}: a cut edge inside one "
                                     "component")
        for r, roots in enumerate(real_roots, 1):
            err(name, *both(torch, mst_min.bucketed_min_rank_cut,
                            mst_min.bucketed_min_rank_cut_plain, L, ranks,
                            roots), f"{key} roots after round {r}")
    return errs


def mst_round_roots(graph) -> list:
    """The roots the min-cut pass gets after rounds 1 and 2 of one
    ``mst.run`` (fewer if it ends sooner), recorded by wrapping the
    kernel's entry point."""
    from gunrock_tpu_torch.algorithms import mst
    from gunrock_tpu_torch.probes.pull import record_calls

    _, calls = record_calls(mst, "bucketed_min_rank_cut", lambda: mst.run(
        graph, warmup=False, device=graph.device))
    return [roots for _, _, roots in calls[1:3]]


def wstep_inputs(torch, L, gen, labeled_share: float):
    """(y_lat, y_lon, mlat3, mlon3, ok3) for the Weiszfeld-step kernels
    over layout ``L``: a ``labeled_share`` of the vertices carry random
    coordinates, the slot tables are built as ``geo_kernel`` builds them,
    and the iterate is random except on every 8th row, which sits exactly
    on one of its labeled neighbours (distance 0: the slot the kernel must
    not count)."""
    from gunrock_tpu_torch.algorithms import geo
    from gunrock_tpu_torch.ops.kernels.layout import slot_indices

    dev, V = L.device, L.n_vertices

    def coords():
        return (torch.rand(V, device=dev, generator=gen) * 120 - 60,
                torch.rand(V, device=dev, generator=gen) * 360 - 180)

    labeled = torch.rand(V, device=dev, generator=gen) < labeled_share
    (lat, lon), (y_lat, y_lon) = coords(), coords()
    slot_dst, slot_valid = geo.slot_tables(L)
    ok_slot = slot_valid & labeled[slot_dst]
    mlat3 = torch.where(ok_slot, lat[slot_dst], 0.0)
    mlon3 = torch.where(ok_slot, lon[slot_dst], 0.0)
    if L.n_chunks:
        row, _, slot = slot_indices(L)
        keep = ok_slot[slot]
        best = torch.full((V,), -1, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, row[keep], slot[keep], reduce="amax",
                             include_self=True)
        on = (best >= 0) & (torch.arange(V, device=dev) % 8 == 0)
        at = torch.clamp(best, min=0)
        y_lat = torch.where(on, mlat3[at], y_lat)
        y_lon = torch.where(on, mlon3[at], y_lon)
    return y_lat, y_lon, mlat3, mlon3, ok_slot.float()


WSTEP_RTOL = 1e-4


def wstep_err(torch, what: str, got, want) -> float:
    """The four sums of a Weiszfeld step, kernel against plain version:
    the counts equal; the sum of 1/d within rtol 1e-4; the two weighted
    coordinate sums, whose terms have either sign, within 1e-4 of 90 resp.
    180 degrees times the sum of 1/d (their terms' magnitude). The kernel
    uses the card's sinf/cosf/asinf and fused multiply-adds, the plain
    version torch's; both subtract the same rounded radians, so a distance
    is 0 in both or in neither. Returns the largest absolute error."""
    if not torch.equal(got[0], want[0]):
        i = int(torch.nonzero(got[0] != want[0])[0])
        raise AssertionError(
            f"{what}: {int((got[0] != want[0]).sum())} rows count other "
            f"nonzero distances; row {i}: {float(got[0][i])} vs "
            f"{float(want[0][i])}, sum 1/d {float(got[1][i])} vs "
            f"{float(want[1][i])}")
    worst = 0.0
    for k, scale in ((1, 1.0), (2, 90.0), (3, 180.0)):
        diff = (got[k] - want[k]).abs()
        limit = WSTEP_RTOL * scale * want[1] + 1e-30
        if bool((diff > limit).any()):
            i = int(torch.argmax(diff - limit))
            raise AssertionError(
                f"{what}: channel {k} row {i}: {float(got[k][i])} vs "
                f"{float(want[k][i])}, limit {float(limit[i])}")
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst


def compare_analysis_kernels(torch, graph, layouts, source: int,
                             block_rows: tuple, slab=None) -> dict:
    """The analysis family's kernels against their plain versions; raises
    on a mismatch. Returns {kernel: max abs error}. ``layouts``: "geo"
    (the unit push layout), "unit" and "valued" (pull layouts),
    optionally "empty_row", "geo_odd" and "geo_c512". The two
    Weiszfeld-step passes by :func:`wstep_err`, with all, 10% and none of
    the rows still iterating, and bit-equal across two calls (a fixed order
    of summation) on "geo" and "empty_row"; the banded gather exactly,
    on random windows with out-of-window indices, and on ``slab`` (a real
    slab's table, positions and window starts) when given. Also three kernels of the
    earlier slices at the shapes only this family gives them: the
    frontier-sparse semiring pass on every level of a BC search from
    ``source`` (float sigma forward over "unit", dependencies backward
    over "geo", both level masks: :func:`sum_check`), the SpMM on every
    backward level of a BC batch from the K top-degree vertices (over
    "geo": :func:`sum_check`), and the frontier-sparse SpMM as the dense SpGEMM calls it, on one row block of
    ``block_rows[0]`` rows with unit values (exact) and one of
    ``block_rows[1]`` rows with the weights (positive terms: rtol 1e-4)."""
    import numpy as np

    from gunrock_tpu_torch.algorithms import bc
    from gunrock_tpu_torch.ops.kernels import (
        banded,
        chunkplan,
        geo_step,
        semiring,
        spmm,
    )

    dev = graph.device
    V = graph.n_vertices
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    errs = {}

    def keep(name, e):
        errs[name] = max(errs.get(name, 0.0), e)

    def again(name, got, fn, *args):
        """A second call on the same inputs gives the same bits."""
        if not all(torch.equal(a, b) for a, b in zip(got, fn(*args))):
            raise AssertionError(f"{name}: two calls on the same inputs "
                                 "differ")

    for key in [k for k in ("geo", "empty_row", "geo_odd", "geo_c512")
                if k in layouts]:
        L = layouts[key]
        # every sum has a fixed order, whatever the layout (empty_row's
        # edges are not in CSR order: a row has several runs in a chunk),
        # so a second call gives the same bits; the extra chunk sizes
        # take one share of labels
        fixed = key in ("geo", "empty_row")
        for share in (0.1, 0.6) if key in ("geo", "empty_row") else (0.6,):
            args = wstep_inputs(torch, L, gen, share)
            name = "weiszfeld_step_sums"
            got, want = both(torch, geo_step.weiszfeld_step_sums,
                             geo_step.weiszfeld_step_sums_plain, L, *args)
            keep(name, wstep_err(torch, f"{name} {key}", got, want))
            if fixed:
                again(f"{name} {key}", got, geo_step.weiszfeld_step_sums, L,
                      *args)
            name = "weiszfeld_step_sums_sparse"
            for p in (1.0, 0.1, 0.0):
                undone = torch.rand(V, device=dev, generator=gen) < p
                got, want = both(
                    torch, geo_step.weiszfeld_step_sums_sparse,
                    geo_step.weiszfeld_step_sums_sparse_plain, L, *args,
                    undone)
                keep(name, wstep_err(torch, f"{name} {key} undone {p}", got,
                                     want))
                if fixed:
                    again(f"{name} {key} undone {p}", got,
                          geo_step.weiszfeld_step_sums_sparse, L, *args,
                          undone)
                if p == 0.0 and any(bool(y.any()) for y in got):
                    raise AssertionError(f"{name} {key}: sums without a row "
                                         "that iterates")

    name = "banded_gather"
    cases = [banded_cases.banded_case(gen, 5000, 7, 256, 5, dev) + (256, 5),
             banded_cases.banded_case(gen, 200_000, 33, 2048, 37, dev)
             + (2048, 37),
             banded_cases.banded_case(gen, 300_000, 9, 2048, 120, dev)
             + (2048, 120)]
    if slab is not None:
        cases.append(slab)
    for table2, idx, block_lo, block_t, span_rows in cases:
        want = banded.banded_gather_plain(table2, idx, block_lo,
                                          span_rows=span_rows, block_t=block_t)
        got = banded.banded_gather(table2, idx, block_lo,
                                   span_rows=span_rows, block_t=block_t)
        torch.cuda.synchronize()
        record(torch, errs, name, got, want, True,
               f"T={block_t} span_rows={span_rows}")

    # B1 at BC's shape: every level of a search, forward and backward
    name = "bucketed_semiring_spmv_sparse"
    labels, sigma, depth = bc.bc_forward(graph, source)
    sigma_safe = torch.where(sigma > 0, sigma, 1.0)
    for d in range(depth):
        front, up = labels == d, labels == d + 1
        unreached = (labels > d) | (labels == -1)
        for L, x, act, om in (
                (layouts["unit"], torch.where(front, sigma, 0.0), front,
                 unreached),
                (layouts["geo"], torch.where(up, 1.0 / sigma_safe, 0.0), up,
                 front)):
            got, want = both(torch, semiring.bucketed_semiring_spmv_sparse,
                             semiring.bucketed_semiring_spmv_sparse_plain,
                             L, x, act, "plus_times", out_mask=om, unit=True)
            ch_act = chunkplan.chunk_activity_plain(L, act, om)[0]
            keep(name, sum_check(torch, f"{name} BC level {d}", got,
                                 *layout_terms(L, x, True, ch_act), want))

    # B4 at the batched BC's backward shape: every level's
    # (1 + delta) / sigma columns of the top-degree sources, summed over
    # the push layout
    name = "bucketed_spmm"
    deg = np.diff(graph.host["row_offsets"])
    sources = np.argsort(-deg, kind="stable")[:K]
    plain_pull, plain_push = bc._segment_advances(graph)
    columns = []

    def push(x, up, here):
        columns.append(x)
        return plain_push(x, up, here)

    bc._backward(*bc._forward(graph, sources, plain_pull), push)
    for d, x in enumerate(columns):
        got, want = both(torch, spmm.bucketed_spmm, spmm.bucketed_spmm_plain,
                         layouts["geo"], x)
        keep(name, sum_check(
            torch, f"{name} BC backward pass {d} K={x.shape[1]}", got,
            *layout_terms(layouts["geo"], x, True), want))

    # B5 at SpGEMM's shape: one row block of A as the columns of X
    name = "bucketed_spmm_sparse"
    offs = graph.host["row_offsets"]
    for n_rows, unit in zip(block_rows, (True, False)):
        r0 = min(4 * n_rows, (V - 1) // n_rows * n_rows)
        e0, e1 = int(offs[r0]), int(offs[min(r0 + n_rows, V)])
        c = graph.col_indices[e0:e1].long()
        x = torch.zeros((V, n_rows), device=dev)
        x[c, graph.edge_src[e0:e1].long() - r0] = (
            1.0 if unit else graph.values[e0:e1])
        active = torch.zeros(V, dtype=torch.bool, device=dev)
        active[c] = True
        got, want = both(torch, spmm.bucketed_spmm_sparse,
                         spmm.bucketed_spmm_sparse_plain,
                         layouts["unit" if unit else "valued"], x, active,
                         exact=unit)
        keep(name, max_abs_err(
            torch, got, want, unit, rtol=1e-4,
            what=f"{name} SpGEMM block K={n_rows} unit={unit}"))
    return errs


def compare_banded_edges(torch, dev) -> dict:
    """The banded gather bit for bit against its plain version at
    ``banded_cases.edge_cases``' shapes: span_rows 1 and 200
    (``tc.MAX_SPAN_ROWS``), the sink window at the table's last rows,
    indices below and above their window (int32's extremes among them), a
    single block, blocks of 128, and an idx view off 16-byte alignment
    (the scalar instance). Returns {"banded_gather": max abs error}."""
    from gunrock_tpu_torch.ops.kernels import banded

    errs = {}
    for name, (table2, idx, block_lo, block_t, span_rows) in (
            banded_cases.edge_cases(dev).items()):
        got, want = both(torch, banded.banded_gather,
                         banded.banded_gather_plain, table2, idx, block_lo,
                         span_rows=span_rows, block_t=block_t)
        record(torch, errs, "banded_gather", got, want, True,
               f"edge shape {name}")
    return errs


def check_edge_shapes(torch, dev) -> None:
    """The kernels at shapes the main path does not have: V = 1000 is no
    multiple of the window (128) or of a warp, so the last window and the
    last warp run past V; an edgeless layout; negative values; and a
    layout with a row window that no chunk reaches."""
    import numpy as np

    from gunrock_tpu_torch.algorithms import color, mst
    from gunrock_tpu_torch.formats import Coo
    from gunrock_tpu_torch.graph import build_graph
    from gunrock_tpu_torch.ops.kernels import (
        chunkplan,
        geo_step,
        hits_fused,
        mst_min,
        semiring,
        spmm,
    )
    from gunrock_tpu_torch.ops.kernels.layout import (
        build_bucketed_layout,
        pull_layout,
        push_layout,
    )

    V, W = 1000, 128
    rng = np.random.default_rng(SEED)
    rows = (V * rng.random(20_000) ** 3).astype(np.int32)  # skewed: hub rows
    cols = rng.integers(0, V, 20_000).astype(np.int32)
    vals = (rng.random(20_000) + 0.1).astype(np.float32)
    graph = build_graph(Coo(V, V, rows, cols, vals), device=dev)
    neg = vals * rng.choice(np.float32([-1, 1]), vals.size)
    keep = rows // W != 3  # row window 3 gets no chunk

    def layout(r, c, v, pad=0.0):
        return build_bucketed_layout(r, c, v, V, window=W, chunk=W,
                                     pad_value=pad, device=dev)

    layouts = {
        "unit": pull_layout(graph, window=W, chunk=W, unit=True),
        "valued": pull_layout(graph, window=W, chunk=W),
        "big": pull_layout(graph, window=W, chunk=W, pad_value=semiring._BIG),
        "hits": push_layout(graph, window=W, chunk=W, unit=True),
        "neg": layout(rows, cols, neg),
        "neg_big": layout(rows, cols, neg, semiring._BIG),
        "empty_row": layout(rows[keep], cols[keep], vals[keep]),
    }
    layouts["color"] = color._color_layout(graph, window=W, chunk=W)
    layouts["rank"] = color._rank_color_layout(graph, window=W, chunk=W)
    layouts["mst"], layouts["mst_ranks"] = mst._mst_rank_layout(
        graph, window=W, chunk=W)
    errs = compare_kernels(torch, graph, layouts, 5)
    errs.update(compare_family_kernels(torch, graph, layouts, 0))
    errs.update(compare_frontier_kernels(torch, graph, layouts, 5))
    layouts["geo"] = layouts["hits"]  # the unit push layout at W=128
    # B9 also with chunks of 125 slots (a tile with idle threads) and of
    # 512 (two tiles a chunk: a row's run cut at the tile's end)
    h = graph.host
    ones = np.ones(graph.n_edges, np.float32)
    layouts["geo_odd"] = build_bucketed_layout(
        h["edge_src"], h["col_indices"], ones, V, window=W, chunk=125,
        device=dev)
    layouts["geo_c512"] = build_bucketed_layout(
        h["edge_src"], h["col_indices"], ones, V, window=W, chunk=512,
        device=dev)
    analysis = compare_analysis_kernels(
        torch, graph, layouts, int(np.argmax(np.diff(graph.host["row_offsets"]))),
        (64, 32))
    for name, e in {**analysis, **compare_banded_edges(torch, dev)}.items():
        errs[name] = max(errs.get(name, 0.0), e)
    errs.update(compare_probe_kernels(torch, layouts, dev))
    empty = np.zeros(0, np.int32)
    edgeless = layout(empty, empty, empty.astype(np.float32))
    # the span kernels also with several spans per row block (P = 3) and
    # with scalar loads (C = 125, no multiple of 4)
    layouts["edgeless"] = edgeless
    layouts["neg_p3"] = layouts["neg"].with_span_chunks(3)
    layouts["odd_chunk"] = build_bucketed_layout(rows, cols, neg, V, window=W,
                                                 chunk=125, device=dev)
    for name, e in compare_span_kernels(torch, layouts, (
            "valued", "neg", "neg_p3", "odd_chunk", "empty_row",
            "edgeless")).items():
        errs[name] = max(errs.get(name, 0.0), e)
    # B8 and B5 on their span tables: several spans per block (P = 3) and
    # scalar loads (C = 125, no multiple of 4) too
    layouts["hits_p3"] = layouts["hits"].with_span_chunks(3)
    layouts["hits_odd"] = layouts["geo_odd"]
    layouts["rank_p3"] = layouts["rank"].with_span_chunks(3)
    for name, e in compare_hits_spmm_spans(
            torch, layouts, ("hits", "hits_p3", "hits_odd", "edgeless"),
            ("rank", "rank_p3", "odd_chunk", "edgeless"), (1, 8, 32, 33, 512),
            512).items():
        errs[name] = max(errs.get(name, 0.0), e)
    # B4 and B6 on the span table likewise; B6's layouts hold values >= 0
    src, dst = color._sym_loopfree_edges(graph)
    layouts["color_p3"] = layouts["color"].with_span_chunks(3)
    layouts["color_odd"] = build_bucketed_layout(
        src, dst, np.ones(src.size, np.float32), V, window=W, chunk=125,
        device=dev)
    for name, e in compare_spmm_minmax_spans(
            torch, layouts, ("unit", "rank_p3", "odd_chunk", "empty_row",
                             "edgeless"),
            ("color", "color_p3", "color_odd", "empty_row", "edgeless"),
            (1, 4, 8, 32, 33), 64).items():
        errs[name] = max(errs.get(name, 0.0), e)
    x = torch.ones(V, device=dev)
    act = torch.ones(V, dtype=torch.bool, device=dev)
    if not (bool((semiring.bucketed_semiring_spmv_sparse(
            edgeless, x, act, "min_plus") == torch.inf).all())
            and bool((semiring.bucketed_semiring_spmv(
                edgeless, x, "min_plus") == torch.inf).all())
            and bool((spmm.bucketed_spmm(edgeless, x[:, None]) == 0).all())
            and all(bool((y == 0).all()) for y in hits_fused.hits_fused_pass(
                edgeless, x, x))
            and bool((spmm.bucketed_spmm_sparse(edgeless, x[:, None], act)
                      == 0).all())
            and bool((mst_min.bucketed_min_rank_cut(
                edgeless, torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(V, dtype=torch.int32, device=dev))
                == mst_min.NO_CUT).all())):
        raise AssertionError("edgeless layout: not the identity")
    ch, queue, count = chunkplan.chunk_activity(edgeless, act, act)
    if ch.numel() or queue.numel() or int(count) != 0:
        raise AssertionError("edgeless layout: a chunk plan with chunks")
    ymax, ymin = semiring.bucketed_semiring_spmv_sparse_minmax(edgeless, x, act)
    if not (bool((ymax == 0).all()) and bool((ymin == semiring._BIG).all())):
        raise AssertionError("edgeless layout: max/min not (0, _BIG)")
    no_slots = torch.zeros(0, device=dev)
    for sums in (geo_step.weiszfeld_step_sums(edgeless, x, x, no_slots,
                                              no_slots, no_slots),
                 geo_step.weiszfeld_step_sums_sparse(
                     edgeless, x, x, no_slots, no_slots, no_slots, act)):
        if any(bool(y.any()) or y.shape != (V,) for y in sums):
            raise AssertionError("edgeless layout: Weiszfeld sums not 0")
    errs.update(async_edge_shapes(torch, graph, dev))
    torch.cuda.synchronize()
    print(f"edge shapes (V={V}, W={W}, {layouts['unit'].n_chunks} chunks; "
          f"negative values; an empty row window; edgeless; spans of 3 "
          f"chunks; C=125; B5 at K=1, 8, 32, 33, 512; B4 at K=1, 4, 8, 32, "
          f"33; the sweeps at 1 to 1000 blocks; B10 at span_rows 1 and "
          f"200, the last rows, clamped both sides, one block, T=128, "
          f"unaligned idx): max abs err {errs}")


def compare_probe_kernels(torch, layouts, dev) -> dict:
    """The probes' kernels at edge shapes: the floor modes on the W=128
    layouts (C=128, half the block idle; a row window no chunk reaches,
    which must come back 0), relative to the plain version as their sums
    are ~1e-27; the gather on a 3-D tensor along each axis with another
    index count on the axis, and flat; the block copy of 3-row blocks with
    cnt below meta's length, and with cnt 0. Returns {kernel: max abs
    error}."""
    import numpy as np

    from gunrock_tpu_torch.ops.kernels import probes

    errs = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    for key in ("valued", "empty_row"):
        lay = layouts[key]
        x = torch.rand(lay.n_vertices, device=dev, generator=gen)
        reached = torch.zeros(lay.n_row_blocks, dtype=torch.bool, device=dev)
        reached[lay.chunk_rb.long()] = True
        for mode in ("dma", "gather"):
            got, want = both(torch, probes.spmv_floor, probes.spmv_floor_plain,
                             lay, x, mode)
            g, w = got[reached], want[reached]
            if (float(((g - w).abs() / w).max()) > 1e-5
                    or not bool((got[~reached] == 0).all())):
                raise AssertionError(f"semiring_floor_{mode} on {key}: off by "
                                     "more than rtol 1e-5, or a row window no "
                                     "chunk reaches is not 0")
            name = f"semiring_floor_{mode}"
            errs[name] = max(errs.get(name, 0.0), float((g - w).abs().max()))
    # [3, 5, 7]: rows of 35 and 7 on axes 0 and 1 (one split an output);
    # [3, 8, 12] and axis 2: whole groups of four in a row (one split, an
    # int4 and a float4 a group); flat, also with idx one element off
    # 16-byte alignment
    for dims in ((3, 5, 7), (3, 8, 12)):
        xg = torch.randn(dims, device=dev, generator=gen)
        for axis in (0, 1, 2):
            shape = list(dims)
            shape[axis] = 4 if dims[axis] != 4 else 8
            idx = torch.randint(0, xg.shape[axis], shape, device=dev,
                                generator=gen, dtype=torch.int32)
            record(torch, errs, "gather", *both(
                torch, probes.gather, probes.gather_plain, xg, idx, axis), True,
                f"{dims} axis {axis}")
        for n in (999, 1000):
            idx = torch.randint(0, xg.numel(), (n + 1,), device=dev,
                                generator=gen, dtype=torch.int32)
            for what, ix in (("flat", idx[:n]), ("flat, unaligned", idx[1:])):
                record(torch, errs, "gather", *both(
                    torch, probes.gather, probes.gather_plain, xg, ix, None),
                    True, f"{dims} {what} {n}")
    xb = torch.rand((5, 3, 128), device=dev, generator=gen)
    meta = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 5, 700).astype(np.int32)).to(dev)
    meta[-60] = 4  # the last block, inside cnt
    for n in (650, 0):
        cnt = torch.tensor([n], dtype=torch.int32, device=dev)
        got, want = both(torch, probes.block_copy_sum,
                         probes.block_copy_sum_plain, xb, meta, cnt)
        record(torch, errs, "block_copy_sum", got, want, False, f"cnt {n}")
    return errs


def edge_shapes_main(checked: bool = False, repeat: int = 1) -> int:
    """Build the kernels and run only the edge-shape checks, ``repeat``
    times: the command that ``compute-sanitizer`` wraps,

        compute-sanitizer --tool memcheck python3 -c \\
            'import sys, chip_smoke; sys.exit(chip_smoke.edge_shapes_main())'

    ``checked=True`` runs them on the range-checking build instead (every
    computed index is tested before use and each launch is synchronised;
    a bad index raises with its source line), for a machine where no
    sanitizer runs:

        python3 -c 'import sys, chip_smoke; sys.exit(
            chip_smoke.edge_shapes_main(checked=True, repeat=20))'
    """
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    run_edge_shapes(torch, checked, repeat)
    return 0


def run_edge_shapes(torch, checked: bool, repeat: int) -> list:
    """Build the kernels (the range-checking build when ``checked``) and
    run the edge-shape checks ``repeat`` times, printing one line each.
    Returns the launches of each run; raises at the first fault."""
    from gunrock_tpu_torch.ops.kernels import _build

    print(f"built kernels in {_build.build(checked=checked):.1f} s "
          f"(checked={checked})")
    launches = []
    _build.use_checked(checked)
    try:
        for i in range(repeat):
            _build.reset_launches()
            check_edge_shapes(torch, torch.device("cuda"))
            launches.append(sum(_build.LAUNCHES.values()))
            print(f"edge shapes run {i + 1}/{repeat}: ok, no fault in "
                  f"{launches[-1]} launches (checked={checked})")
    finally:
        _build.use_checked(False)
    return launches


def check_kernels(torch, graph, layouts):
    """Phase 2 at the main path's shapes: every kernel against its plain
    version, then timed. Returns {name: row} for the kernel table (launches
    are filled in from the main path)."""
    from gunrock_tpu_torch.algorithms import bfs
    from gunrock_tpu_torch.ops.kernels import chunkplan, semiring, spmm
    from gunrock_tpu_torch.utils.limits import UNREACHED

    errs = compare_kernels(torch, graph, layouts, K)
    span_errs = compare_span_kernels(torch, layouts, ("valued", "pr"))
    span_errs.update(compare_hits_spmm_spans(
        torch, layouts, ("hits", "geo"), ("rank",), (1, 8, 32, 33, 512), 64))
    span_errs.update(compare_spmm_minmax_spans(
        torch, layouts, ("unit", "valued"), ("color",), (1, 4, 8, 32, 33), 64))
    dev = graph.device
    V = graph.n_vertices
    lay = layouts["unit"]
    n_chunks = lay.n_chunks
    n_real = int((lay.row_local != lay.window).sum())
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    full = torch.ones(V, dtype=torch.bool, device=dev)
    rows, timed = {}, {}

    # chunk plan as the span passes call it: masks in, the chunk mask out
    # (four metadata words a chunk in); one device kernel a call
    b, by = bound_ms(2 * V + 16 * n_chunks + n_chunks, 4 * n_chunks)
    launched = kernels_of_one_call(lambda: chunkplan.chunk_activity(
        lay, full, full, queue=False))
    if list(launched.values()) != [1]:
        raise AssertionError(f"chunk_activity: one call ran {launched}, not "
                             "one device kernel")
    rows["chunk_activity"] = dict(
        route="cuda", source="gunrock_tpu_torch/csrc/chunkplan.cu",
        replaces="gunrock_tpu/ops/pallas/chunkplan.py:61",
        max_abs_err=errs["chunk_activity"],
        ms=time_ms(torch, timed.setdefault(
            "chunk_activity", lambda: chunkplan.chunk_activity(
                lay, full, full, queue=False))),
        plain_ms=time_ms(torch, lambda: chunkplan.chunk_activity_plain(
            lay, full, full, queue=False)),
        bound_ms=b, bound_by=by, library_ms=None)
    print("chunk_activity with its ascending queue, ms:", time_ms(
        torch, lambda: chunkplan.chunk_activity(lay, full, full)))

    # the BFS pull (plus_times, unit) on a full frontier, so that one
    # torch.sparse.mm over the pull matrix computes the same y
    xf = full.float()
    b, by = bound_ms(8 * n_real + 4 * V + 2 * V + 4 * V + 16 * n_chunks,
                     n_real)
    A = torch.sparse_csr_tensor(
        graph.csc_offsets.long(), graph.csc_rows.long(),
        torch.ones(graph.n_edges, device=dev), size=(V, V))
    max_abs_err(torch, semiring.bucketed_semiring_spmv_sparse(
        lay, xf, full, "plus_times", out_mask=full, unit=True),
        torch.sparse.mm(A, xf[:, None])[:, 0], True,
        what="spmv_sparse vs torch.sparse.mm")
    rows["bucketed_semiring_spmv_sparse"] = dict(
        route="cuda", source="gunrock_tpu_torch/csrc/semiring.cu",
        replaces="gunrock_tpu/ops/pallas/semiring.py:815",
        max_abs_err=errs["bucketed_semiring_spmv_sparse"],
        ms=time_ms(torch, timed.setdefault(
            "bucketed_semiring_spmv_sparse",
            lambda: semiring.bucketed_semiring_spmv_sparse(
                lay, xf, full, "plus_times", out_mask=full, unit=True))),
        plain_ms=time_ms(torch, lambda: semiring.bucketed_semiring_spmv_sparse_plain(
            lay, xf, full, "plus_times", out_mask=full, unit=True)),
        bound_ms=b, bound_by=by,
        library_ms=library(torch, timed, "bucketed_semiring_spmv_sparse",
                           lambda: torch.sparse.mm(A, xf[:, None])))
    tenth = torch.rand(V, device=dev, generator=gen) < 0.1
    half = torch.rand(V, device=dev, generator=gen) < 0.5
    tenth_x = tenth.float()
    print("spmv_sparse BFS pull, 10% frontier, ms:", time_ms(
        torch, lambda: semiring.bucketed_semiring_spmv_sparse(
            lay, tenth_x, tenth, "plus_times", out_mask=half, unit=True)))

    # SpMM, K=32, on random X
    xr = torch.rand((V, K), device=dev, generator=gen)
    b, by = bound_ms(12 * n_real + 2 * 4 * V * K, 2 * n_real * K)
    rows["bucketed_spmm"] = dict(
        route="cuda", source="gunrock_tpu_torch/csrc/spmm.cu",
        replaces="gunrock_tpu/ops/pallas/spmm.py:85",
        max_abs_err=errs["bucketed_spmm"],
        ms=time_ms(torch, timed.setdefault(
            "bucketed_spmm", lambda: spmm.bucketed_spmm(lay, xr))),
        plain_ms=time_ms(torch, lambda: spmm.bucketed_spmm_plain(lay, xr)),
        bound_ms=b, bound_by=by,
        library_ms=library(torch, timed, "bucketed_spmm",
                           lambda: torch.sparse.mm(A, xr)))

    # push step: a small frontier of the size the DO switch pushes, over a
    # 30%-reached distance vector
    reached = torch.rand(V, device=dev, generator=gen) < 0.3
    dist0 = torch.where(reached, 1, UNREACHED).to(torch.int32)
    front = reached & (torch.rand(V, device=dev, generator=gen) < 0.002)
    q = torch.nonzero(front).flatten()
    n_edges_q = int(graph.out_degrees()[q].sum())
    n_new = int(bfs.bfs_push_step_plain(graph, front, dist0.clone(), 1)[0].sum())
    b, by = bound_ms(V + 8 * q.numel() + 8 * n_edges_q + 4 * n_new + V)
    clone_ms = time_ms(torch, lambda: dist0.clone())
    # one device operation a call: the cooperative launch, no memset
    d = dist0.clone()
    launched = kernels_of_one_call(
        lambda: bfs.bfs_push_step(graph, front, d, 1, 0))
    if list(launched.values()) != [1]:
        raise AssertionError(f"bfs_push_step: one call ran {launched}, not "
                             "one device kernel")
    rows["bfs_push_step"] = dict(
        route="cuda", source="gunrock_tpu_torch/csrc/bfs_push.cu",
        replaces="gunrock_tpu/algorithms/bfs.py:76",
        max_abs_err=errs["bfs_push_step"],
        ms=time_ms(torch, timed.setdefault(
            "bfs_push_step", lambda: bfs.bfs_push_step(
                graph, front, dist0.clone(), 1, 0))) - clone_ms,
        plain_ms=time_ms(torch, lambda: bfs.bfs_push_step_plain(
            graph, front, dist0.clone(), 1)) - clone_ms,
        bound_ms=b, bound_by=by, library_ms=None)
    print(f"push step input: {q.numel()} frontier vertices, {n_edges_q} "
          f"out-edges, {n_new} new")
    rows.update(predecessor_rows(torch, graph, layouts, timed))
    rows.update(msbfs_rows(torch, graph, timed))
    rows.update(family_kernel_rows(torch, graph, layouts, timed))
    frontier_rows, frontier_errs = frontier_kernel_rows(torch, graph, layouts,
                                                       timed)
    rows.update(frontier_rows)
    analysis_rows, analysis_errs = analysis_kernel_rows(torch, graph, layouts,
                                                        timed)
    rows.update(analysis_rows)
    rows.update(probe_kernel_rows(torch, graph, layouts, timed))
    for name in ("bucketed_semiring_spmv_sparse", "bucketed_spmm"):
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        frontier_errs[name])
    for name in ("bucketed_semiring_spmv_sparse", "bucketed_spmm",
                 "bucketed_spmm_sparse"):
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        analysis_errs[name])
    for name, e in span_errs.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)
    # the device's own busy time per call (ms above is wall time between
    # CUDA events, which the host's launch overhead can set), and each
    # kernel's share of it in microseconds per call; the push step's
    # includes its 1 MB distance copy
    for key, fn in timed.items():
        prof = device_profile(lambda: [fn() for _ in range(20)])
        busy = prof["busy_us"] / 20e3 if "busy_us" in prof else None
        if key.endswith(LIBRARY):
            rows[key[:-len(LIBRARY)]]["library_device_ms"] = busy
            continue
        rows[key]["device_ms"] = busy
        rows[key]["device_kernels_us"] = {
            k: us / 20 for k, (us, _) in prof.get("top_us", {}).items()}
    for r in rows.values():
        r.setdefault("library_device_ms", None)
    return rows


def predecessor_rows(torch, graph, layouts, timed) -> dict:
    """The predecessor kernel of BFS and of SSSP at the main path's shape.
    Held bit for bit (``torch.equal``) against the plain pass, in the
    normal and the checked build: on the distances of the DO searches
    (``bfs_kernel_do``, ``sssp_kernel_do``) from the in-neighbour in the
    middle of the longest CSC run (so that run's one BFS-tight slot sits
    mid-run) and from four random sources, and on
    ``probes/predecessor_cases.py``'s graphs. Then timed on the first
    random source's distances beside the plain pass and the early exit's
    byte bound. Adds each timed call to ``timed``."""
    import numpy as np

    from gunrock_tpu_torch.algorithms import bfs, sssp
    from gunrock_tpu_torch.ops.kernels import _build
    from gunrock_tpu_torch.ops.kernels import predecessors as P
    from gunrock_tpu_torch.probes import predecessor_cases

    off, csc_rows = graph.host["csc_offsets"], graph.host["csc_rows"]
    top = int(np.argmax(np.diff(off)))
    live = torch.nonzero(graph.out_degrees().cpu() > 0).flatten()
    gen = torch.Generator().manual_seed(SEED + 5)
    sources = [int(csc_rows[(off[top] + off[top + 1]) // 2])] + live[
        torch.randperm(live.numel(), generator=gen)[:4]].tolist()
    kernel = {"bfs": P.bfs_predecessors, "sssp": P.sssp_predecessors}
    dists = {
        "bfs": [bfs.bfs_kernel_do(graph, s, layout=layouts["unit"])[0]
                for s in sources],
        "sssp": [sssp.sssp_kernel_do(graph, s, layout=layouts["big"])[0]
                 for s in sources]}
    cases = [(f"DO search from {s}", graph, kind, d)
             for kind in dists for s, d in zip(sources, dists[kind])]
    cases += [(name, *case) for name, case in
              predecessor_cases.cases(graph.device).items()]
    for checked in (False, True):
        _build.use_checked(checked)
        try:
            for what, g, kind, d in cases:
                got = kernel[kind](g, d)
                torch.cuda.synchronize()
                want = P.predecessors_plain(g, d, kind)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{kind}_predecessors, {what}"
                        f"{' (checked build)' if checked else ''}: "
                        f"{int((got != want).sum())} of {g.n_vertices} "
                        "predecessors differ from the plain pass's")
        finally:
            _build.use_checked(False)
    print(f"predecessors: {len(cases)} cases bit for bit in both builds, "
          f"DO searches from {sources}")

    rows = {}
    for kind, replaces in (("bfs", "gunrock_tpu/algorithms/bfs.py:458"),
                           ("sssp", "gunrock_tpu/algorithms/sssp.py:403")):
        name, d, fn = f"{kind}_predecessors", dists[kind][1], kernel[kind]
        launched = kernels_of_one_call(lambda: fn(graph, d))
        if list(launched.values()) != [1]:
            raise AssertionError(f"{name}: one call ran {launched}, not "
                                 "one device kernel")
        b, by = bound_ms(predecessor_cases.bound_bytes(graph, d, kind)[0])
        rows[name] = dict(
            route="cuda", source="gunrock_tpu_torch/csrc/predecessors.cu",
            replaces=replaces, max_abs_err=0.0,
            ms=time_ms(torch, timed.setdefault(
                name, lambda fn=fn, d=d: fn(graph, d))),
            plain_ms=time_ms(torch, lambda d=d, kind=kind:
                             P.predecessors_plain(graph, d, kind)),
            bound_ms=b, bound_by=by, library_ms=None)
    return rows


def msbfs_rows(torch, graph, timed) -> dict:
    """The multi-source BFS kernels at the main path's shape. The start
    and every level of three batches held bit for bit (``torch.equal`` on
    every tensor of the state) against the plain versions, in the normal
    and the checked build; then ``msbfs_pull`` timed on the level of the
    top-degree batch that needs the most slots (each call restores the
    state's words, a copy timed apart and taken off) beside its plain
    version and its byte bound. Adds the timed call to ``timed``."""
    import numpy as np

    from gunrock_tpu_torch.ops.kernels import _build
    from gunrock_tpu_torch.ops.kernels import msbfs as M
    from gunrock_tpu_torch.probes.pull import msbfs_level_bytes

    dev, V = graph.device, graph.n_vertices
    deg = graph.out_degrees().cpu().numpy()
    rng = np.random.default_rng(SEED + 6)
    rand = rng.choice(np.flatnonzero(deg > 0), 40)
    rand[1] = rand[0]
    batches = {"top-degree K=32": np.argsort(-deg, kind="stable")[:K],
               "random K=32": rand[:32], "random K=40": rand}
    heaviest = None  # (slots, level, state before it) of the top batch
    for checked in (False, True):
        _build.use_checked(checked)
        try:
            for what, batch in batches.items():
                src = torch.as_tensor(batch, device=dev).long()
                got, want = (M.MsbfsState.empty(V, len(batch), dev)
                             for _ in range(2))
                M.msbfs_start(graph, src, got)
                M.msbfs_start_plain(graph, src, want)
                level = 0
                while True:
                    torch.cuda.synchronize()
                    for name, t in got.tensors().items():
                        if not torch.equal(t, getattr(want, name)):
                            raise AssertionError(
                                f"msbfs {what}, level {level}"
                                f"{' (checked build)' if checked else ''}: "
                                f"{name} differs from the plain pass's")
                    c = want.counts.tolist()
                    if not c[level % 2]:
                        break
                    before = M.MsbfsState(**{
                        k: t.clone() for k, t in got.tensors().items()})
                    M.msbfs_pull(graph, got, level)
                    M.msbfs_pull_plain(graph, want, level)
                    slots = want.counts[2].item() - c[2]
                    if (not checked and what.startswith("top")
                            and (heaviest is None or slots > heaviest[0])):
                        heaviest = (slots, level, before)
                    level += 1
        finally:
            _build.use_checked(False)
    print(f"msbfs: {len(batches)} batches bit for bit, every level, in both "
          "builds")

    slots, level, before = heaviest
    st = M.MsbfsState(**{k: t.clone() for k, t in before.tensors().items()})
    M.msbfs_pull(graph, st, level)
    gained = int((st.dist == level + 1).sum())
    spare = torch.empty_like(before.front)  # each call's next, written whole

    def restore():  # the words the level reads and writes, as before it
        for name in ("seen", "aux", "counts"):
            getattr(st, name).copy_(getattr(before, name))
        st.front, st.next = before.front, spare

    launched = kernels_of_one_call(lambda: (restore(), M.msbfs_pull(
        graph, st, level)))
    if sum(n for k, n in launched.items() if "msbfs" in k) != 1:
        raise AssertionError(f"msbfs_pull: one call ran {launched}, not one "
                             "msbfs kernel")
    copy_ms = time_ms(torch, restore)
    b, by = bound_ms(msbfs_level_bytes(graph, M.n_words(K), slots, gained))
    print(f"msbfs_pull timed input: level {level} of the top-degree batch, "
          f"{slots} of {graph.n_edges} slots, {gained} distances written")
    return {"msbfs_pull": dict(
        route="cuda", source="gunrock_tpu_torch/csrc/msbfs.cu",
        replaces="none (gunrock_tpu/algorithms/bfs.py:248 msbfs_kernel "
                 "calls B4, gunrock_tpu/ops/pallas/spmm.py:85)",
        max_abs_err=0.0,
        ms=time_ms(torch, timed.setdefault(
            "msbfs_pull", lambda: (restore(), M.msbfs_pull(
                graph, st, level)))) - copy_ms,
        plain_ms=time_ms(torch, lambda: (restore(), M.msbfs_pull_plain(
            graph, st, level))) - copy_ms,
        bound_ms=b, bound_by=by, library_ms=None)}


def family_kernel_rows(torch, graph, layouts, timed) -> dict:
    """The semiring family's kernels at the main path's shapes: each held
    against its plain version (compare_family_kernels), then timed beside
    its plain version, its bound and one PyTorch call computing the same
    function (``library_ms``). Adds each timed call to ``timed``."""
    import numpy as np

    from gunrock_tpu_torch.algorithms import sssp
    from gunrock_tpu_torch.ops.kernels import hits_fused, semiring

    dev = graph.device
    V, E = graph.n_vertices, graph.n_edges
    deg = graph.out_degrees()
    source = int(np.argmax(np.diff(graph.host["row_offsets"])))
    errs = compare_family_kernels(torch, graph, layouts, source)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows = {}

    def n_real(lay):  # real (non-padding) slots: the edges the pass needs
        return int((lay.row_local != lay.window).sum())

    def csr(offsets, cols, vals):
        return torch.sparse_csr_tensor(offsets.long(), cols.long(), vals,
                                       size=(V, V))

    # B3 at PageRank's shape: valued plus_times over the W=4096/C=1024 pull
    # layout; the library call is the pull matrix (CSR of the transpose)
    lay = layouts["pr"]
    x = torch.rand(V, device=dev, generator=gen)
    A_pull = csr(graph.csc_offsets, graph.csc_rows, graph.csc_values)
    max_abs_err(torch, semiring.bucketed_semiring_spmv(lay, x, "plus_times"),
                torch.sparse.mm(A_pull, x[:, None])[:, 0], False, rtol=1e-4,
                what="bucketed_semiring_spmv vs torch.sparse.mm")
    b, by = bound_ms(12 * n_real(lay) + 8 * lay.n_chunks + 4 * V + 4 * V,
                     2 * n_real(lay))
    rows["bucketed_semiring_spmv"] = dict(
        route="cuda", source="gunrock_tpu_torch/csrc/semiring.cu",
        replaces="gunrock_tpu/ops/pallas/semiring.py:491",
        max_abs_err=errs["bucketed_semiring_spmv"],
        ms=time_ms(torch, timed.setdefault(
            "bucketed_semiring_spmv",
            lambda lay=lay: semiring.bucketed_semiring_spmv(lay, x, "plus_times"))),
        plain_ms=time_ms(torch, lambda: semiring.bucketed_semiring_spmv_plain(
            lay, x, "plus_times")),
        bound_ms=b, bound_by=by,
        library_ms=library(torch, timed, "bucketed_semiring_spmv",
                           lambda: torch.sparse.mm(A_pull, x[:, None])),
        library="torch.sparse.mm (CSR)")
    for key, sr in (("unit", "plus_times"), ("valued", "plus_times"),
                    ("big", "min_plus")):
        xk = torch.where(torch.rand(V, device=dev, generator=gen) < 0.5, x,
                         semiring._BIG) if sr == "min_plus" else x
        print(f"bucketed_semiring_spmv {sr} {key} W={layouts[key].window}/"
              f"C={layouts[key].chunk}, ms:", time_ms(
                  torch, lambda: semiring.bucketed_semiring_spmv(
                      layouts[key], xk, sr, unit=key == "unit")))

    # B8 on the W=4096/C=1024 unit push layout; the library computes the
    # same two sums in one call, [[0, A], [A^T, 0]] . (hub; auth) =
    # (A.auth; A^T.hub), and, for comparison, in two, A.auth and A^T.hub
    lay = layouts["hits"]
    auth = torch.rand(V, device=dev, generator=gen)
    hub = torch.rand(V, device=dev, generator=gen)
    ones = torch.ones(E, device=dev)
    A = csr(graph.row_offsets, graph.col_indices, ones)
    A_t = csr(graph.csc_offsets, graph.csc_rows, ones)
    src, dst = graph.edge_src.long(), graph.col_indices.long()
    M = torch.sparse_coo_tensor(
        torch.stack([torch.cat([src, V + dst]), torch.cat([V + dst, src])]),
        torch.cat([ones, ones]), size=(2 * V, 2 * V)).coalesce().to_sparse_csr()
    hub_auth = torch.cat([hub, auth])[:, None]
    max_abs_err(torch, torch.cat(hits_fused.hits_fused_pass(lay, auth, hub)),
                torch.sparse.mm(M, hub_auth)[:, 0], False, rtol=1e-4,
                what="hits_fused_pass vs torch.sparse.mm")
    b, by = bound_ms(8 * n_real(lay) + 8 * lay.n_chunks + 4 * 4 * V,
                     2 * n_real(lay))
    rows["hits_fused_pass"] = dict(
        route="cuda", source="gunrock_tpu_torch/csrc/hits_fused.cu",
        replaces="gunrock_tpu/ops/pallas/hits_fused.py:80",
        max_abs_err=errs["hits_fused_pass"],
        ms=time_ms(torch, timed.setdefault(
            "hits_fused_pass",
            lambda: hits_fused.hits_fused_pass(lay, auth, hub))),
        plain_ms=time_ms(torch, lambda: hits_fused.hits_fused_pass_plain(
            lay, auth, hub)),
        bound_ms=b, bound_by=by,
        library_ms=library(torch, timed, "hits_fused_pass",
                           lambda: torch.sparse.mm(M, hub_auth)),
        library="torch.sparse.mm ([[0, A], [A^T, 0]] . (hub; auth)), one call",
        library_two_calls_ms=time_ms(
            torch, lambda: (torch.sparse.mm(A, auth[:, None]),
                            torch.sparse.mm(A_t, hub[:, None]))))

    # SSSP push step on the largest frontier of the search from the top
    # source that the DO switch pushes (out-edges and size under E/192)
    budget = max(4096, E // 192)
    pushed = []
    for front, dist in sssp_frontiers(torch, graph, source):
        n_out, n_front = torch.stack(
            [torch.where(front, deg, 0).sum(), front.sum()]).tolist()
        if n_out < budget and n_front < budget:
            pushed.append((n_out, n_front, front, dist))
    n_out, n_front, front, dist = max(pushed, key=lambda t: t[0])
    b, by = bound_ms(V + 4 * V + 4 * V + V + 12 * n_front + 12 * n_out, n_out)
    rows["sssp_push_step"] = dict(
        route="cuda", source="gunrock_tpu_torch/csrc/sssp_push.cu",
        replaces="gunrock_tpu/algorithms/sssp.py:84",
        max_abs_err=errs["sssp_push_step"],
        ms=time_ms(torch, timed.setdefault(
            "sssp_push_step",
            lambda: sssp.sssp_push_step(graph, front, dist, budget))),
        plain_ms=time_ms(torch, lambda: sssp.sssp_push_step_plain(
            graph, front, dist)),
        bound_ms=b, bound_by=by, library_ms=None)
    print(f"sssp push step input: {n_front} frontier vertices, {n_out} "
          f"out-edges (budget {budget}; {len(pushed)} pushed iterations)")
    return rows


def frontier_kernel_rows(torch, graph, layouts, timed) -> tuple:
    """The frontier family's kernels at the main path's shapes: each held
    against its plain version (compare_frontier_kernels), then timed on
    the inputs of the path's first, full-frontier round beside its plain
    version, its bound and, for the SpMM, ``torch.sparse.mm`` over the
    same matrix. Adds each timed call to ``timed``. Returns (rows, the
    errors of every kernel compare_frontier_kernels held)."""
    import numpy as np

    from gunrock_tpu_torch.algorithms import color
    from gunrock_tpu_torch.ops.kernels import chunkplan, mst_min, semiring, spmm

    dev = graph.device
    V = graph.n_vertices
    errs = compare_frontier_kernels(torch, graph, layouts, K,
                                    real_roots=mst_round_roots(graph))
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    full = torch.ones(V, dtype=torch.bool, device=dev)
    rows = {}

    def n_real(lay):
        return int((lay.row_local != lay.window).sum())

    # B6 on Luby's first round: every vertex uncolored, priorities 1..V
    lay = layouts["color"]
    x = torch.randperm(V, device=dev, generator=gen).float() + 1.0
    b, by = bound_ms(12 * n_real(lay) + 8 * lay.n_chunks + 4 * V + 2 * V
                     + 8 * V, 3 * n_real(lay))
    name = "bucketed_semiring_spmv_sparse_minmax"
    rows[name] = dict(
        route="cuda", source="gunrock_tpu_torch/csrc/semiring.cu",
        replaces="gunrock_tpu/ops/pallas/semiring.py:1022",
        max_abs_err=errs[name],
        ms=time_ms(torch, timed.setdefault(
            name, lambda: semiring.bucketed_semiring_spmv_sparse_minmax(
                lay, x, full, full))),
        plain_ms=time_ms(
            torch, lambda: semiring.bucketed_semiring_spmv_sparse_minmax_plain(
                lay, x, full, full), 5),
        bound_ms=b, bound_by=by, library_ms=None)

    # B5 on greedy coloring's first round: every vertex changed, X the
    # one-hot of the rank-init colors; the library call is the same matrix
    # (rows = vertices, cols = neighbours, values = the higher predicate)
    rlay, rank = color._greedy_color_setup(graph)
    x1 = torch.nn.functional.one_hot(torch.clamp(rank, max=K - 1).long(),
                                     K).float()
    xr = torch.rand((V, K), device=dev, generator=gen)
    src, dst = color._sym_loopfree_edges(graph)
    A = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([src, dst]).astype(np.int64)).to(dev),
        torch.from_numpy((dst < src).astype(np.float32)).to(dev),
        size=(V, V)).coalesce().to_sparse_csr()
    name = "bucketed_spmm_sparse"
    max_abs_err(torch, spmm.bucketed_spmm_sparse(rlay, x1, full, full,
                                                 exact=True),
                torch.sparse.mm(A, x1), True,
                what="spmm_sparse vs torch.sparse.mm")
    b, by = bound_ms(12 * n_real(rlay) + 8 * rlay.n_chunks + 2 * 4 * V * K
                     + 2 * V, 2 * n_real(rlay) * K)
    rows[name] = dict(
        route="cuda", source="gunrock_tpu_torch/csrc/spmm.cu",
        replaces="gunrock_tpu/ops/pallas/spmm.py:188",
        max_abs_err=errs[name],
        ms=time_ms(torch, timed.setdefault(
            name, lambda: spmm.bucketed_spmm_sparse(rlay, x1, full, full,
                                                    exact=True))),
        plain_ms=time_ms(torch, lambda: spmm.bucketed_spmm_sparse_plain(
            rlay, x1, full, full), 5),
        bound_ms=b, bound_by=by,
        library_ms=library(torch, timed, name, lambda: torch.sparse.mm(A, x1)),
        library="torch.sparse.mm (CSR)")
    print(f"bucketed_spmm_sparse K={K}, full frontier, float X, ms:",
          time_ms(torch, lambda: spmm.bucketed_spmm_sparse(rlay, xr, full,
                                                           full)),
          "torch.sparse.mm:", time_ms(torch, lambda: torch.sparse.mm(A, xr)))
    ulay = layouts["unit"]
    offs = graph.row_offsets.long()
    e0, e1 = int(offs[2048]), int(offs[2560])
    c = graph.col_indices[e0:e1].long()
    xs = torch.zeros((V, 512), device=dev)
    xs[c, graph.edge_src[e0:e1].long() - 2048] = 1.0
    act = torch.zeros(V, dtype=torch.bool, device=dev)
    act[c] = True
    A_pull = torch.sparse_csr_tensor(
        graph.csc_offsets.long(), graph.csc_rows.long(),
        torch.ones(graph.n_edges, device=dev), size=(V, V))
    print("bucketed_spmm_sparse SpGEMM row block 4 (K=512, unit pull "
          f"layout, {int(chunkplan.chunk_activity(ulay, act)[0].sum())} "
          "active chunks), ms:",
          time_ms(torch, lambda: spmm.bucketed_spmm_sparse(ulay, xs, act,
                                                           exact=True), 5),
          "torch.sparse.mm:", time_ms(torch, lambda: torch.sparse.mm(A_pull, xs), 5))
    del xs
    tenth = torch.rand(V, device=dev, generator=gen) < 0.1
    x10 = torch.where(tenth[:, None], x1, 0.0)
    print("bucketed_spmm_sparse one-hot X, 10% changed, 50% unstable, ms:",
          time_ms(torch, lambda: spmm.bucketed_spmm_sparse(
              rlay, x10, tenth, torch.rand(V, device=dev) < 0.5, exact=True)))

    # B7 on Boruvka's first round: every vertex its own component
    mlay, ranks = layouts["mst"], layouts["mst_ranks"]
    roots = torch.arange(V, dtype=torch.int32, device=dev)
    b, by = bound_ms(12 * n_real(mlay) + 8 * mlay.n_chunks + 4 * V + 4 * V,
                     2 * n_real(mlay))
    name = "bucketed_min_rank_cut"
    rows[name] = dict(
        route="cuda", source="gunrock_tpu_torch/csrc/mst_min.cu",
        replaces="gunrock_tpu/ops/pallas/mst_min.py:78",
        max_abs_err=errs[name],
        ms=time_ms(torch, timed.setdefault(
            name, lambda: mst_min.bucketed_min_rank_cut(mlay, ranks, roots))),
        plain_ms=time_ms(torch, lambda: mst_min.bucketed_min_rank_cut_plain(
            mlay, ranks, roots), 5),
        bound_ms=b, bound_by=by, library_ms=None)
    few = torch.randint(0, 4, (V,), device=dev, generator=gen,
                        dtype=torch.int32)
    print(f"frontier layouts: color {lay.n_chunks} chunks / {n_real(lay)} "
          f"slots, mst {mlay.n_chunks} chunks / {n_real(mlay)} slots; "
          "bucketed_min_rank_cut with 4 components, ms:",
          time_ms(torch, lambda: mst_min.bucketed_min_rank_cut(mlay, ranks,
                                                               few)))
    return rows, errs


def analysis_kernel_rows(torch, graph, layouts, timed) -> tuple:
    """The analysis family's kernels at the main path's shapes: each held
    against its plain version (compare_analysis_kernels, with a real
    triangle-counting slab for the banded gather), then timed beside its
    plain version, its bound and, for the gather, ``index_select`` on the
    same indices. Adds each timed call to ``timed``. Returns (rows, the
    errors of every kernel compare_analysis_kernels held)."""
    from gunrock_tpu_torch.ops.kernels import banded, geo_step

    dev = graph.device
    V = graph.n_vertices
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    # one real slab of the slabbed sort-join: what the wrapper was given
    slab = banded_cases.real_slab(graph)
    table2, idx, block_lo, block_t, span_rows = slab
    errs = compare_analysis_kernels(torch, graph, layouts, 0, (512, 256),
                                    slab)
    rows = {}

    # B9 on the geo path's first step: 10% of the vertices labeled
    L = layouts["geo"]
    n_real = int((L.row_local != L.window).sum())
    args = wstep_inputs(torch, L, gen, 0.1)
    n_ok = int(args[4].sum())
    full = torch.ones(V, dtype=torch.bool, device=dev)
    n_bytes = 16 * n_real + 4 * L.n_chunks + 8 * V + 16 * V
    b, by = bound_ms(n_bytes, 30 * n_ok)
    name = "weiszfeld_step_sums"
    rows[name] = dict(
        route="cuda", source="gunrock_tpu_torch/csrc/geo_step.cu",
        replaces="gunrock_tpu/ops/pallas/geo_step.py:161",
        max_abs_err=errs[name],
        ms=time_ms(torch, timed.setdefault(
            name, lambda: geo_step.weiszfeld_step_sums(L, *args))),
        plain_ms=time_ms(torch, lambda: geo_step.weiszfeld_step_sums_plain(
            L, *args), 5),
        bound_ms=b, bound_by=by, library_ms=None)
    b, by = bound_ms(n_bytes + 2 * V + 13 * L.n_chunks, 30 * n_ok)
    name = "weiszfeld_step_sums_sparse"
    rows[name] = dict(
        route="cuda", source="gunrock_tpu_torch/csrc/geo_step.cu",
        replaces="gunrock_tpu/ops/pallas/geo_step.py:215",
        max_abs_err=errs[name],
        ms=time_ms(torch, timed.setdefault(
            name, lambda: geo_step.weiszfeld_step_sums_sparse(L, *args,
                                                              full))),
        plain_ms=time_ms(
            torch, lambda: geo_step.weiszfeld_step_sums_sparse_plain(
                L, *args, full), 5),
        bound_ms=b, bound_by=by, library_ms=None)
    tenth = torch.rand(V, device=dev, generator=gen) < 0.1
    print(f"weiszfeld step: {n_real} slots, {n_ok} labeled; sparse pass "
          "with 10% / none of the rows iterating, ms:",
          time_ms(torch, lambda: geo_step.weiszfeld_step_sums_sparse(
              L, *args, tenth)),
          time_ms(torch, lambda: geo_step.weiszfeld_step_sums_sparse(
              L, *args, ~full)))

    # B10 on the captured slab; the library call gathers the same indices
    flat = table2.view(-1)
    b, by = bound_ms(banded_cases.bound_bytes(idx, block_lo))
    name = "banded_gather"
    max_abs_err(torch, banded.banded_gather(table2, idx, block_lo,
                                            span_rows=span_rows,
                                            block_t=block_t),
                flat.index_select(0, idx), True,
                what="banded_gather vs index_select on a real slab")
    rows[name] = dict(
        route="cuda", source="gunrock_tpu_torch/csrc/banded.cu",
        replaces="gunrock_tpu/ops/pallas/banded.py:75",
        max_abs_err=errs[name],
        ms=time_ms(torch, timed.setdefault(
            name, lambda: banded.banded_gather(
                table2, idx, block_lo, span_rows=span_rows,
                block_t=block_t))),
        plain_ms=time_ms(torch, lambda: banded.banded_gather_plain(
            table2, idx, block_lo, span_rows=span_rows, block_t=block_t), 5),
        bound_ms=b, bound_by=by,
        library_ms=library(torch, timed, name, lambda: flat.index_select(0, idx)),
        library="torch.index_select (int32 indices)")
    print(f"banded_gather: slab of {idx.numel()} positions, span_rows "
          f"{span_rows}, table {flat.numel()}")
    return rows, errs


def probe_kernel_rows(torch, graph, layouts, timed) -> dict:
    """The probes' kernels against their plain versions, then timed beside
    them, their bounds and, where one PyTorch call computes the same
    function, that call: the floor modes of the dense pass (P1) on the
    valued W=2048/C=256 pull layout, rtol 1e-5 per reached row block
    (positive sums, only the order differs) and exact 0 elsewhere; the
    gather (P2) at every shape of the two gather probes and on its 64-bit
    path (x of 2^31 + 16 elements), bit for bit; the
    block copy (P3) at the dma probe's 4x16 shape within rtol 1e-6 of the
    float64 sum, and at one x-window per chunk of the unit pull layout
    within rtol 1e-5. Adds each timed call to ``timed``."""
    from gunrock_tpu_torch.ops.kernels import probes
    from gunrock_tpu_torch.probes import dma, gather, gather2, v5_floor

    dev = graph.device
    V = graph.n_vertices
    rows = {}

    # P1: the floor modes, at the probe's own layout and first x
    lay = layouts["valued"]
    x = v5_floor.probe_inputs(lay, 1)[0]
    n_real = int((lay.row_local != lay.window).sum())
    n_y = lay.n_row_blocks * lay.window
    reached = torch.zeros(lay.n_row_blocks, dtype=torch.bool, device=dev)
    reached[lay.chunk_rb.long()] = True
    for mode in ("dma", "gather"):
        name = f"semiring_floor_{mode}"
        got, want = both(torch, probes.spmv_floor, probes.spmv_floor_plain,
                         lay, x, mode)
        # values ~1e-27: a relative limit, no absolute floor
        g, w = got[reached], want[reached]
        rel = float(((g - w).abs() / w).max())
        if rel > 1e-5 or not (bool((got[~reached] == 0).all())
                              and bool((w > 0).all())):
            raise AssertionError(f"{name}: relative error {rel} > 1e-5, or "
                                 "unreached blocks not 0")
        err = float((g - w).abs().max())
        n_bytes = 12 * n_real + 4 * n_y + (4 * V if mode == "gather" else 0)
        b, by = bound_ms(n_bytes, n_real * (2 if mode == "gather" else 1))
        rows[name] = dict(
            route="cuda", source="gunrock_tpu_torch/csrc/semiring.cu",
            replaces="benchmarks/probe_v5_floor.py:115",
            max_abs_err=err,
            ms=time_ms(torch, timed.setdefault(
                name, lambda mode=mode: probes.spmv_floor(lay, x, mode))),
            plain_ms=time_ms(torch, lambda mode=mode: probes.spmv_floor_plain(
                lay, x, mode)),
            bound_ms=b, bound_by=by, library_ms=None)

    # P2: every gather shape of the two probes, bit for bit; timed at the
    # [4096, 128] lane gather beside torch.take_along_dim
    err = 0.0
    for module in (gather, gather2):
        for v in module.VARIANTS:
            xa, ia, axis = module.inputs(v)[:3]
            xt, it = torch.from_numpy(xa).to(dev), torch.from_numpy(ia).to(dev)
            got, want = both(torch, probes.gather, probes.gather_plain, xt, it, axis)
            err = max(err, max_abs_err(torch, got, want, True, what=f"gather {v}"))
    # the 64-bit path: x of 2^31 + 16 elements
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    xb = torch.randn((2, 2 ** 30 + 8), device=dev, generator=gen)
    ib = torch.randint(0, xb.shape[1], (2, 64), device=dev, generator=gen,
                       dtype=torch.int32)
    ib[:, 0] = xb.shape[1] - 1
    got, want = both(torch, probes.gather, probes.gather_plain, xb, ib, 1)
    err = max(err, max_abs_err(torch, got, want, True, what="gather 64-bit"))
    del xb, got, want
    torch.cuda.empty_cache()
    xa, ia, axis = gather2.inputs("bench")
    xt, it = torch.from_numpy(xa).to(dev), torch.from_numpy(ia).to(dev)
    il = it.long()
    b, by = bound_ms(4 * xa.size + 4 * ia.size + 4 * ia.size)
    rows["gather"] = dict(
        route="cuda", source="gunrock_tpu_torch/csrc/probes.cu",
        replaces="benchmarks/probe_gather2.py:46",
        max_abs_err=err,
        ms=time_ms(torch, timed.setdefault(
            "gather", lambda: probes.gather(xt, it, axis))),
        plain_ms=time_ms(torch, lambda: probes.gather_plain(xt, it, axis)),
        bound_ms=b, bound_by=by,
        library_ms=library(torch, timed, "gather",
                           lambda: torch.take_along_dim(xt, il, dim=axis)))

    # P3: the dma probe's case, then one x-window per chunk
    xa, meta, cnt = dma.check_inputs()
    want = sum(float(xa[int(m)].astype("float64").sum()) for m in meta)
    got = probes.block_copy_sum(*(torch.from_numpy(a).to(dev)
                                  for a in (xa, meta, cnt)))
    torch.cuda.synchronize()
    err = abs(float(got[0, 0, 0]) - want)
    if err > 1e-6 * want or not bool((got == got[0, 0, 0]).all()):
        raise AssertionError(f"block_copy_sum 4x16: {float(got[0, 0, 0])} "
                             f"against {want}")
    xw, mw, cw = dma.window_inputs(layouts["unit"])
    got, want = both(torch, probes.block_copy_sum, probes.block_copy_sum_plain,
                     xw, mw, cw)
    want64 = float(xw.view(xw.shape[0], -1).double()[mw.long()].sum())
    for what, t in (("kernel", got), ("plain", want)):
        if abs(float(t[0, 0, 0]) - want64) > 1e-5 * want64:
            raise AssertionError(f"block_copy_sum windows, {what}: "
                                 f"{float(t[0, 0, 0])} against {want64}")
    err = max(err, abs(float(got[0, 0, 0]) - float(want[0, 0, 0])))
    b, by = bound_ms(xw.numel() * 4 + mw.numel() * 4 + 4 + xw[0].numel() * 4,
                     mw.numel() * xw[0].numel())
    rows["block_copy_sum"] = dict(
        route="cuda", source="gunrock_tpu_torch/csrc/probes.cu",
        replaces="benchmarks/probe_dma.py:66",
        max_abs_err=err,
        ms=time_ms(torch, timed.setdefault(
            "block_copy_sum", lambda: probes.block_copy_sum(xw, mw, cw))),
        plain_ms=time_ms(torch, lambda: probes.block_copy_sum_plain(xw, mw, cw)),
        bound_ms=b, bound_by=by, library_ms=None)
    return rows


def measurement_path(torch, graph, layouts) -> dict:
    """Phase 3e, the measurement path: the four probe drivers through
    their entry points on the same graph, printing each probe's lines:
    the dense pass split into stream, gather and scatter (20 x draws of
    the JAX probe), the gathers at both probes' shapes, the block copy at
    the dma probe's case and at one window per chunk. Returns the summary
    line's dict."""
    from gunrock_tpu_torch.probes import dma, gather, gather2, v5_floor

    lay = layouts["valued"]
    xs = v5_floor.probe_inputs(lay, 20)
    floor = {v: v5_floor.run_variant(lay, graph.n_edges, v, xs, SCALE)
             for v in v5_floor.VARIANTS}
    lines = [*floor.values(), v5_floor.split(lay, floor)]
    dev = graph.device
    lines += [gather.run_variant(v, dev) for v in gather.VARIANTS]
    lines += [gather2.run_variant(v, dev) for v in gather2.VARIANTS]
    lines += [dma.check(dev), dma.bench(layouts["unit"])]
    for line in lines:
        print(json.dumps(line))
    return {"split": lines[3], "gather_bench": lines[8],
            "gather2_bench": lines[12], "gather2_bench_sub": lines[13],
            "dma_bench": lines[-1]}


def frontier_path(torch, graph) -> dict:
    """Phase 3c, the frontier family's main path on the same graph: the
    three coloring strategies, MST, k-core, PPR (one seed, and a batch of
    8), each checked. Returns the summary line's dict."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    from gunrock_tpu_torch.algorithms import color, kcore, mst, ppr
    from gunrock_tpu_torch.examples import cpu_reference

    dev = graph.device
    V = graph.n_vertices
    h = graph.host
    deg = np.diff(h["row_offsets"])
    out = {}

    # coloring: proper over every edge, checked on the card
    src, dst = graph.edge_src.long(), graph.col_indices.long()
    off_diag = src != dst
    for strategy in ("greedy", "rank", "luby"):
        res = color.run(graph, seed=SEED, strategy=strategy, device=dev)
        c = res.colors
        if not bool((c >= 0).all()) or bool(
                (c[src[off_diag]] == c[dst[off_diag]]).any()):
            raise AssertionError(f"color {strategy}: not a proper coloring")
        out[f"color_{strategy}"] = {
            "ms": res.elapsed_ms, "iterations": res.iterations,
            "colors_used": int(c.max()) + 1}

    # MST: weight against scipy's, a forest of V - components edges
    res = mst.run(graph, device=dev)
    want = cpu_reference.mst_weight(graph)
    if abs(res.mst_weight - want) > 1e-5 * abs(want):
        raise AssertionError(f"mst weight {res.mst_weight} != scipy's {want}")
    n_comp = connected_components(csr_matrix(
        (np.ones(graph.n_edges), h["col_indices"], h["row_offsets"]),
        shape=(V, V)), directed=False)[0]
    if res.n_components != n_comp or int(res.mst_edges.sum()) != V - n_comp:
        raise AssertionError(
            f"mst: {res.n_components} components and "
            f"{int(res.mst_edges.sum())} edges, scipy finds {n_comp}")
    out["mst"] = {"ms": res.elapsed_ms, "weight": res.mst_weight,
                  "scipy_weight": want, "components": res.n_components,
                  "rounds": res.rounds, "jump_passes": res.jump_passes}

    # k-core against the peeling oracle
    res = kcore.run(graph, device=dev)
    if not np.array_equal(res.k_cores.cpu().numpy(),
                          cpu_reference.kcore(graph)):
        raise AssertionError("kcore: core numbers differ from the CPU oracle")
    out["kcore"] = {"ms": res.elapsed_ms, "rounds": res.rounds,
                    "degeneracy": res.degeneracy}

    # PPR from the top-degree vertex, and a batch over the 8 top-degree
    # ones, against the float32 CPU oracle
    seeds = np.argsort(-deg, kind="stable")[:8].tolist()

    def ppr_err(what, p, seed):
        ref = cpu_reference.ppr(graph, seed)
        p = p.cpu().numpy()
        bad = np.abs(p - ref) > 1e-6 + 1e-4 * np.abs(ref)
        if bad.any():
            i = np.flatnonzero(bad)[:5]
            raise AssertionError(f"{what}: {int(bad.sum())} entries differ "
                                 f"from the CPU oracle, first {i}: {p[i]} vs "
                                 f"{ref[i]}")
        return float(np.abs(p - ref).max())

    res = ppr.run(graph, seeds[0], device=dev)
    out["ppr"] = {"ms": res.elapsed_ms, "iterations": res.iterations,
                  "seed": seeds[0], "mass": float(res.p.sum()),
                  "max_abs_err_vs_cpu": ppr_err("ppr", res.p, seeds[0])}
    p, ms = ppr.run_batch(graph, seeds, device=dev)
    out["ppr_batch"] = {"ms": ms, "seeds": seeds, "max_abs_err_vs_cpu": max(
        ppr_err(f"ppr batch seed {s}", p[k], s) for k, s in enumerate(seeds))}

    out["profile"] = {
        "color_greedy": device_profile(lambda: color.run(
            graph, strategy="greedy", warmup=False, device=dev)),
        "mst": device_profile(lambda: mst.run(graph, warmup=False,
                                                     device=dev)),
        "color_luby": device_profile(lambda: color.run(
            graph, seed=SEED, strategy="luby", warmup=False, device=dev)),
        "ppr_batch": device_profile(lambda: ppr.run_batch(graph, seeds,
                                                          device=dev)),
    }
    return out


def main_path(torch, graph, layout):
    """Phase 3. Returns (bench dict, launches of each single BFS)."""
    import numpy as np

    from gunrock_tpu_torch.algorithms import bfs
    from gunrock_tpu_torch.examples import cpu_reference
    from gunrock_tpu_torch.ops.kernels import _build
    from gunrock_tpu_torch.utils.limits import UNREACHED

    deg = np.diff(graph.host["row_offsets"])
    sources = np.argsort(-deg, kind="stable")[:8].tolist()
    bfs.run(graph, sources[0], device=graph.device)  # warm-up
    torch.cuda.synchronize()
    times, mteps, per_bfs, depths = [], [], [], []
    for src in sources:
        before = dict(_build.LAUNCHES)
        res = bfs.run(graph, src, warmup=False, device=graph.device)
        per_bfs.append({k: n - before.get(k, 0)
                        for k, n in _build.LAUNCHES.items()})
        dist = res.distances.cpu().numpy()
        ref = cpu_reference.bfs(graph, src)
        if not np.array_equal(dist, ref):
            raise AssertionError(f"bfs from {src}: distances differ from the "
                                 f"CPU oracle at {np.flatnonzero(dist != ref)[:5]}")
        pred = res.predecessors.cpu().numpy()
        hit = (dist != UNREACHED) & (dist > 0)
        if not np.array_equal(dist[pred[hit]], dist[hit] - 1):
            raise AssertionError(f"bfs from {src}: a predecessor is not one "
                                 "level up")
        times.append(res.elapsed_ms)
        depths.append(res.search_depth)
        mteps.append(int(deg[dist != UNREACHED].sum()))
    avg_ms = float(np.mean(times))
    value = float(np.mean([e / avg_ms / 1e3 for e in mteps]))

    batch = np.argsort(-deg, kind="stable")[:K]
    bfs.msbfs_kernel(graph, batch, pull_layout=layout)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bdist, bdepth = bfs.msbfs_kernel(graph, batch, pull_layout=layout)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    bdist = bdist.cpu().numpy()
    bedges = 0
    for k, src in enumerate(batch.tolist()):
        if not np.array_equal(bdist[:, k], cpu_reference.bfs(graph, src)):
            raise AssertionError(f"msbfs column {k} (source {src}) differs "
                                 "from single-source BFS")
        bedges += int(deg[bdist[:, k] != UNREACHED].sum())
    profiles = {
        "bfs": device_profile(lambda: bfs.run(
            graph, sources[0], warmup=False, device=graph.device)),
        "msbfs_k32": device_profile(lambda: bfs.msbfs_kernel(
            graph, batch, pull_layout=layout)),
    }
    print(json.dumps({"profile": profiles}))
    bench = {
        "metric": f"bfs_mteps_rmat{SCALE}_ef{EDGE_FACTOR}",
        "value": value,
        "unit": "MTEPS",
        "avg_ms": avg_ms,
        "batch_mteps_k32": bedges / batch_ms / 1e3,
        "batch_ms_k32": batch_ms,
        "batch_depth_k32": bdepth,
        "n_vertices": graph.n_vertices,
        "n_edges": graph.n_edges,
        "num_runs": len(sources),
        "reorder": "degree",
        "times_ms": times,
        "depths": depths,
    }
    return bench, per_bfs


def level_graph_check(torch, graph, layouts) -> dict:
    """Phase 3a, second part: DO-BFS and DO-SSSP (``bfs_kernel_do``,
    ``sssp_kernel_do``) on the layouts of ``bfs.run`` and ``sssp.run``,
    their levels replayed from captured CUDA graphs
    (``framework/level_graphs.py``), against the same searches run
    eagerly by the checked build, bit for bit: distances and depth from
    the top-degree vertex and four seeded sources of nonzero degree. Two
    warm passes over the sources capture every direction they take; the
    third must only replay. Returns, per search, the levels, the captures
    and replays of the warm passes and of the third, and the third's ms a
    search by CUDA events."""
    import collections

    import numpy as np

    from gunrock_tpu_torch.algorithms import bfs, sssp
    from gunrock_tpu_torch.ops.kernels import _build

    deg = np.diff(graph.host["row_offsets"])
    rng = np.random.default_rng(SEED + 7)
    sources = [int(np.argmax(deg))] + rng.choice(
        np.flatnonzero(deg > 0), 4, replace=False).tolist()
    searches = {
        "bfs": lambda s: bfs.bfs_kernel_do(graph, s, layout=layouts["unit"]),
        "sssp": lambda s: sssp.sssp_kernel_do(graph, s,
                                              layout=layouts["big"])}
    out = {}
    for kind, search in searches.items():
        _build.use_checked(True)
        try:
            eager = [search(s) for s in sources]
        finally:
            _build.use_checked(False)
        before = collections.Counter(_build.LAUNCHES)
        for _ in range(2):
            for s in sources:
                search(s)
        warm = collections.Counter(_build.LAUNCHES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        replayed = [search(s) for s in sources]
        stop.record()
        torch.cuda.synchronize()
        hot = collections.Counter(_build.LAUNCHES) - warm
        for s, (d0, k0), (d1, k1) in zip(sources, eager, replayed):
            if k0 != k1 or not torch.equal(d0, d1):
                raise AssertionError(
                    f"level graphs, {kind} from {s}: depth {k1} against "
                    f"{k0}, {int((d0 != d1).sum())} distances differ from "
                    "the eager search's")
        levels = sum(k for _, k in replayed)
        if hot["level_graph_capture"] or hot["level_graph_replay"] != levels:
            raise AssertionError(f"level graphs, {kind}: the third pass "
                                 f"captured {hot['level_graph_capture']} and "
                                 f"replayed {hot['level_graph_replay']} of "
                                 f"{levels} levels")
        warmed = warm - before
        out[kind] = {"sources": sources, "levels": levels,
                     "warm_captures": warmed["level_graph_capture"],
                     "warm_replays": warmed["level_graph_replay"],
                     "replays": hot["level_graph_replay"],
                     "ms_per_search": start.elapsed_time(stop) / len(sources)}
    return out


def close(what, got, want, rtol, atol):
    """Raise unless got and want (numpy) agree: the same infinities, finite
    entries within atol + rtol * |want|. Returns the largest difference."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not np.array_equal(np.isinf(got), np.isinf(want)):
        raise AssertionError(f"{what}: infinities differ at "
                             f"{np.flatnonzero(np.isinf(got) != np.isinf(want))[:5]}")
    fin = np.isfinite(want)
    bad = np.abs(got[fin] - want[fin]) > atol + rtol * np.abs(want[fin])
    if bad.any():
        i = np.flatnonzero(fin)[np.flatnonzero(bad)[:5]]
        raise AssertionError(f"{what}: {int(bad.sum())} entries differ, "
                             f"first {i}: {got[i]} vs {want[i]}")
    return float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0


def semiring_path(torch, graph) -> dict:
    """Phase 3b, the semiring family's main path on the same graph: SSSP
    (direction-optimizing, 8 top-degree sources; dense min_plus, one
    source), PageRank (single and four dampings), HITS and SpMV, each
    checked against the CPU oracle. Returns the summary line's dict."""
    import numpy as np

    from gunrock_tpu_torch.algorithms import hits, pr, spmv, sssp
    from gunrock_tpu_torch.examples import cpu_reference
    from gunrock_tpu_torch.ops.configs import LoadBalance, Options

    dev = graph.device
    V = graph.n_vertices
    deg = np.diff(graph.host["row_offsets"])
    sources = np.argsort(-deg, kind="stable")[:8].tolist()
    out = {}

    # SSSP: distances against Dijkstra, predecessors on a tight in-edge
    sssp.run(graph, sources[0], device=dev)  # warm-up
    times, teps, depths = [], [], []
    src_t, dst_t = graph.csc_rows.long(), graph.csc_dst.long()
    for src in sources:
        res = sssp.run(graph, src, warmup=False, device=dev)
        dist = res.distances
        close(f"sssp from {src}", dist.cpu().numpy(),
              cpu_reference.sssp(graph, src), 1e-5, 0.0)
        pred = res.predecessors.long()
        tight = (src_t == pred[dst_t]) & torch.isclose(
            dist[src_t] + graph.csc_values, dist[dst_t])
        has = torch.zeros(V, dtype=torch.bool, device=dev).index_fill_(
            0, dst_t[tight], True)
        need = torch.isfinite(dist)
        need[src] = False
        if not bool((has == need).all()) or int(pred[src]) != -1:
            raise AssertionError(f"sssp from {src}: a predecessor is not on "
                                 "a tight in-edge")
        times.append(res.elapsed_ms)
        depths.append(res.search_depth)
        teps.append(int(deg[np.isfinite(dist.cpu().numpy())].sum()))
    avg_ms = float(np.mean(times))
    out["sssp"] = {"avg_ms": avg_ms, "times_ms": times, "depths": depths,
                   "mteps": float(np.mean([e / avg_ms / 1e3 for e in teps]))}
    res = sssp.run(graph, sources[0],
                   options=Options(load_balance=LoadBalance.PALLAS_MERGE_PATH),
                   device=dev)
    close("sssp dense min_plus", res.distances.cpu().numpy(),
          cpu_reference.sssp(graph, sources[0]), 1e-5, 0.0)
    out["sssp_dense"] = {"ms": res.elapsed_ms, "depth": res.search_depth}

    # PageRank, single and batched. The ranks are ~1/V = 3.8e-6 and tol
    # 1e-6 bounds only the last step, so a run is held to the float64
    # oracle's iterate after as many iterations (tol 0): the difference is
    # then f32 arithmetic alone, and a relative limit holds every vertex.
    # The oracle's own last step must be under tol: the run did not stop
    # early.
    tol = 1e-6

    def pr_check(what, p, iterations, alpha):
        want = cpu_reference.pr(graph, alpha, tol=0.0, max_iter=iterations)
        prev = cpu_reference.pr(graph, alpha, tol=0.0,
                                max_iter=iterations - 1)
        step = float(np.abs(want.astype(np.float64) - prev).max())
        if step >= tol:
            raise AssertionError(f"{what}: stopped after {iterations} "
                                 f"iterations, but the float64 oracle's "
                                 f"last step is {step} >= tol {tol}")
        p = p.cpu().numpy()
        err = close(what, p, want, 1e-4, 1e-9)
        rel = float((np.abs(p - want.astype(np.float64)) / want).max())
        return {"max_abs_err_vs_cpu": err, "max_rel_err_vs_cpu": rel,
                "cpu_last_step": step}

    res = pr.run(graph, tol=tol, device=dev)
    out["pr"] = {"ms": res.elapsed_ms, "iterations": res.iterations,
                 **pr_check("pr", res.p, res.iterations, 0.85)}
    alphas = (0.75, 0.80, 0.85, 0.90)
    batch = pr.run_batch(graph, alphas, tol=tol, device=dev)
    out["pr_batch"] = {"ms": batch.elapsed_ms, "iterations": batch.iterations,
                       "alphas": alphas, "columns": [
                           pr_check(f"pr batch alpha={a}", batch.p[:, k],
                                    batch.iterations, a)
                           for k, a in enumerate(alphas)]}

    # HITS (directed R-MAT: the fused sweep)
    res = hits.run(graph, max_iterations=20, device=dev)
    ref_auth, ref_hub = cpu_reference.hits(graph, res.iterations)
    close("hits auth", res.auth.cpu().numpy(), ref_auth, 1e-4, 1e-6)
    close("hits hub", res.hub.cpu().numpy(), ref_hub, 1e-4, 1e-6)
    out["hits"] = {"ms": res.elapsed_ms, "iterations": res.iterations}

    # SpMV on a seeded x, against the float64 sum over the edges
    x = np.random.default_rng(SEED).random(V).astype(np.float32)
    res = spmv.run(graph, x, device=dev)
    xt = torch.from_numpy(x).to(dev).double()
    err = sum_check(torch, "spmv", res.y, graph.edge_src.long(),
                    graph.values.double() * xt[graph.col_indices.long()])
    out["spmv"] = {"ms": res.elapsed_ms, "max_abs_err_vs_f64": err}

    out["profile"] = {
        "sssp": device_profile(lambda: sssp.run(
            graph, sources[0], warmup=False, device=dev)),
        "pr": device_profile(lambda: pr.run(graph, warmup=False,
                                                   device=dev)),
        "pr_batch": device_profile(lambda: pr.run_batch(
            graph, alphas, tol=tol, device=dev)),
    }
    return out


def analysis_path(torch, graph, order) -> dict:
    """Phase 3d, the analysis family's main path on the same graph:
    betweenness centrality (one source on both paths, a batch of 32),
    triangle counting (one sort, slabbed, probe), SpGEMM A.A (dense and
    ESC counts, sampled row blocks materialized) and geolocation (kernel
    path against the scatter-sum path), each checked. ``order`` maps the
    graph's vertex ids to the generator's (labels are drawn per input
    vertex). Returns the summary line's dict."""
    import numpy as np
    import scipy.sparse as sp

    from gunrock_tpu_torch.algorithms import bc, geo, spgemm, tc
    from gunrock_tpu_torch.examples import cpu_reference
    from gunrock_tpu_torch.examples.geo import default_labels
    from gunrock_tpu_torch.ops.configs import Options
    from gunrock_tpu_torch.ops.kernels.layout import pull_layout

    dev = graph.device
    V = graph.n_vertices
    h = graph.host
    deg = np.diff(h["row_offsets"])
    top = np.argsort(-deg, kind="stable")[:K].tolist()
    out = {}

    # BC: the float64 Brandes oracle holds the kernel path and the plain
    # path (all terms are positive, so a relative limit holds every vertex)
    ref = cpu_reference.bc(graph, top[0])
    res = bc.run(graph, top[0], device=dev)
    plain = bc.run(graph, top[0], options=Options(), device=dev)
    depth = bc.bc_forward(graph, top[0])[2]
    out["bc"] = {
        "ms": res.elapsed_ms, "plain_ms": plain.elapsed_ms, "depth": depth,
        "source": top[0],
        "max_abs_err_vs_cpu": close("bc", res.bc_values.cpu().numpy(), ref,
                                    1e-4, 1e-5),
        "plain_max_abs_err_vs_cpu": close(
            "bc plain", plain.bc_values.cpu().numpy(), ref, 1e-4, 1e-5)}
    want8 = sum(cpu_reference.bc(graph, s).astype(np.float64)
                for s in top[:8])
    got8 = bc.bc_batch_kernel(graph, top[:8])
    err8 = close("bc batch K=8", got8.cpu().numpy(), want8, 1e-4, 1e-5)
    bc.bc_batch_kernel(graph, top)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got32 = bc.bc_batch_kernel(graph, top)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got32).all()) or bool((got32 < 0).any()):
        raise AssertionError("bc batch K=32: not finite and non-negative")
    out["bc_batch"] = {"ms_k32": (time.perf_counter() - t0) * 1e3,
                       "k8_max_abs_err_vs_cpu": err8}

    # TC: one sort, slabs, probe: equal per-vertex counts, equal to the
    # DAG-based CPU oracle's
    rk = tc.ranked_dag(graph)
    print(f"tc: {rk['n_wedges']} wedges, {rk['eu'].size} DAG edges, max DAG "
          f"degree {rk['max_deg']}, span_rows "
          f"{tc.span_rows_for(rk['max_deg'])}")
    torch.cuda.reset_peak_memory_stats()
    one = tc.run(graph, device=dev)
    peak = torch.cuda.max_memory_allocated()
    slabbed = tc.run(graph, max_wedges=-(-rk["n_wedges"] // TC_SLABS),
                     device=dev)
    probe = tc.run(graph, method="probe", device=dev)
    want = torch.from_numpy(cpu_reference.tc(graph)).to(dev)
    for what, r in (("one sort", one), ("slabbed", slabbed), ("probe", probe)):
        if not torch.equal(r.vertex_triangles_count, want):
            bad = torch.nonzero(r.vertex_triangles_count != want).flatten()
            raise AssertionError(
                f"tc {what}: {bad.numel()} vertices differ from the CPU "
                f"oracle, first {bad[:5].tolist()}")
    out["tc"] = {"ms": one.elapsed_ms, "slabbed_ms": slabbed.elapsed_ms,
                 "slabs": TC_SLABS, "probe_ms": probe.elapsed_ms,
                 "triangles": one.n_triangles, "wedges": rk["n_wedges"],
                 "one_sort_peak_bytes": peak}

    # SpGEMM C = A.A: structure by both strategies, then sampled row
    # blocks materialized by both and held against scipy's product
    products = spgemm.product_count(graph, graph)
    dense = spgemm.run(graph, graph, strategy="dense", count_only=True,
                       device=dev)
    esc = spgemm.run(graph, graph, strategy="esc", count_only=True,
                     device=dev)
    if dense.nnz != esc.nnz:
        raise AssertionError(f"spgemm: dense counts {dense.nnz} nonzeros, "
                             f"esc {esc.nnz}")
    closed, streamed = float(dense.values[0]), float(esc.values[0])
    if abs(streamed - closed) > 1e-3 * abs(closed):
        raise AssertionError(f"spgemm: esc checksum {streamed} against the "
                             f"closed form {closed}")
    A = sp.csr_matrix((h["values"], h["col_indices"], h["row_offsets"]),
                      shape=(V, V))
    layout = pull_layout(graph)
    rows_k = 256
    starts = h["row_offsets"][: V // rows_k * rows_k + 1: rows_k]
    nonempty = np.flatnonzero(np.diff(starts) > 0)
    blocks = nonempty[np.linspace(min(4, nonempty.size - 1),
                                  nonempty.size - 1, 8).astype(int)].tolist()
    deg_b = deg.astype(np.int64)
    worst = 0.0
    for blk in blocks:
        r0, r1 = blk * rows_k, (blk + 1) * rows_k
        e0, e1 = int(h["row_offsets"][r0]), int(h["row_offsets"][r1])
        want = (A[r0:r1] @ A).tocsr()
        want.sort_indices()
        off = np.zeros(e1 - e0 + 1, np.int64)
        np.cumsum(deg_b[h["col_indices"][e0:e1]], out=off[1:])
        for what, got in (
                ("dense", spgemm._dense_block_kernel(layout, graph, e0, e1,
                                                     r0, rows_k)),
                ("esc", spgemm._block_kernel(graph, graph, e0, e1, off))):
            r, c, v = (t.cpu().numpy() for t in got[:3])
            if not (np.array_equal(r - r0, np.repeat(
                    np.arange(rows_k), np.diff(want.indptr)))
                    and np.array_equal(c, want.indices)):
                raise AssertionError(f"spgemm {what} block {blk}: structure "
                                     "differs from scipy's")
            worst = max(worst, close(f"spgemm {what} block {blk}", v,
                                     want.data, 1e-3, 1e-4))
    out["spgemm"] = {
        "products": products, "auto_picks": spgemm.pick_strategy(graph, graph),
        "nnz": dense.nnz, "dense_count_ms": dense.elapsed_ms,
        "esc_count_ms": esc.elapsed_ms, "checksum_closed_form": closed,
        "esc_checksum": streamed, "sampled_blocks": blocks,
        "sampled_max_abs_err_vs_scipy": worst}

    # geolocation: the CLI's default labels, permuted into execution ids
    lat, lon = (a[order] for a in default_labels(V))
    res = geo.run(graph, lat, lon, device=dev)
    got_lat, got_lon = res.latitude.cpu().numpy(), res.longitude.cpu().numpy()
    bad = cpu_reference.geo_invariants(graph, lat, lon, got_lat, got_lon)
    if bad:
        raise AssertionError(f"geo: {bad} invariant violations")
    # the scatter-sum path, twice. Each path adds in a fixed order (the run
    # and row passes of csrc/geo_step.cu; torch.segment_reduce over the CSR
    # ranges), so two runs of one path must give the same bits, NaNs in
    # the same places. The two paths add in different orders, and a vertex
    # that converges slowly stops where its step first falls under eps, so
    # between the paths the JAX package's tolerance (rtol 2e-3, atol 2e-3)
    # is held on all but 1 in 10,000 of the located vertices.
    plain, again = (geo.run(graph, lat, lon, options=Options(), warmup=False,
                            device=dev) for _ in range(2))
    located = np.isfinite(got_lat)

    def outside(a, b):
        """(vertices outside the tolerance, largest difference in degrees,
        longitudes compared around the circle) of two results."""
        a_lat, b_lat = (r.latitude.cpu().numpy() for r in (a, b))
        a_lon, b_lon = (r.longitude.cpu().numpy() for r in (a, b))
        if not (np.array_equal(located, np.isfinite(a_lat))
                and np.array_equal(located, np.isfinite(b_lat))):
            raise AssertionError("geo: two runs locate different vertices")
        d_lat = np.abs(a_lat - b_lat)[located]
        d_lon = np.abs((a_lon - b_lon + 180.0) % 360.0 - 180.0)[located]
        bad = ((d_lat > 2e-3 + 2e-3 * np.abs(b_lat[located]))
               | (d_lon > 2e-3 + 2e-3 * np.abs(b_lon[located])))
        return int(bad.sum()), float(max(d_lat.max(), d_lon.max()))

    def same_bits(what, a, b):
        for x, y in ((a.latitude, b.latitude), (a.longitude, b.longitude)):
            x, y = x.cpu().numpy(), y.cpu().numpy()
            if not np.array_equal(x, y, equal_nan=True):
                n = int((~((x == y) | (np.isnan(x) & np.isnan(y)))).sum())
                raise AssertionError(f"geo: two {what} runs differ at {n} "
                                     "vertices")

    same_bits("scatter-sum", plain, again)
    rerun = geo.run(graph, lat, lon, warmup=False, device=dev)
    same_bits("kernel-path", rerun, res)
    n_out, diff = outside(res, plain)
    if n_out * 10_000 > int(located.sum()):
        raise AssertionError(
            f"geo: {n_out} of {int(located.sum())} located vertices differ "
            f"between the kernel path and the scatter-sum path by more than "
            f"2e-3 + 2e-3 |x| (largest {diff})")
    out["geo"] = {"ms": res.elapsed_ms, "plain_ms": plain.elapsed_ms,
                  "steps": res.steps, "plain_steps": plain.steps,
                  "labeled": int(np.isfinite(lat).sum()),
                  "located": int(located.sum()),
                  "outside_tolerance_vs_plain_path": n_out,
                  "max_abs_diff_vs_plain_path": diff,
                  "reruns_bit_equal": True}

    out["profile"] = {
        "bc": device_profile(lambda: bc.run(
            graph, top[0], warmup=False, device=dev)),
        "geo_2_outer": device_profile(lambda: geo.run(
            graph, lat, lon, total_iterations=2, warmup=False, device=dev)),
        "bc_batch_k32": device_profile(lambda: bc.bc_batch_kernel(graph, top)),
    }
    return out


def _reduceat(values, offsets, ufunc, identity):
    """numpy oracle of a sorted-segment reduction: ``ufunc`` over each
    segment of ``values`` split by ``offsets``, ``identity`` where empty."""
    import numpy as np

    # one identity past the end, so that every start indexes the array
    padded = np.append(values, np.asarray(identity, values.dtype))
    out = ufunc.reduceat(padded, offsets[:-1].astype(np.int64))
    out[np.diff(offsets) == 0] = identity  # reduceat's empty segments
    return out


def queue_bfs(graph, source: int):
    """BFS as a Gunrock user writes it on the port's operators: a
    QueueFrontier, ``advance`` to the touched vertices, the touched
    compacted into a queue, ``filter_queue`` to the unvisited and
    ``uniquify``; the loop reads the device once a level (``is_empty``).
    Returns (distances, depth)."""
    import torch

    from gunrock_tpu_torch.framework import QueueFrontier, mask_to_queue
    from gunrock_tpu_torch.ops import advance, filter_queue, uniquify
    from gunrock_tpu_torch.utils.limits import UNREACHED

    V, dev = graph.n_vertices, graph.device
    dist = torch.full((V,), UNREACHED, dtype=torch.int32, device=dev)
    dist[source] = 0
    q = QueueFrontier.from_list([source], V, device=dev)
    depth = 0
    while not bool(q.is_empty()):
        _, touched = advance(graph, q.to_mask(V), lambda s, d, e, w: w, "min")
        data, count = mask_to_queue(touched, V)
        data, count = filter_queue(data, count,
                                   lambda x: dist[x.long()] == UNREACHED)
        q = QueueFrontier(*uniquify(data, count, V))
        depth += 1
        dist = torch.where(q.to_mask(V), depth, dist)
    return dist, depth


def bellman_ford(graph, source: int):
    """SSSP as a Gunrock user writes it: ``advance_semiring`` (min_plus,
    the frontier, the bucketed kernels) relaxes the frontier's out-edges,
    ``filter_mask`` keeps the improved vertices. Returns (distances,
    rounds)."""
    import torch

    from gunrock_tpu_torch.ops import LoadBalance, filter_mask
    from gunrock_tpu_torch.ops.advance import advance_semiring

    V, dev = graph.n_vertices, graph.device
    dist = torch.full((V,), torch.inf, device=dev)
    dist[source] = 0.0
    front = torch.zeros(V, dtype=torch.bool, device=dev)
    front[source] = True
    rounds = 0
    while bool(front.any()):
        relaxed = advance_semiring(graph, dist, "min_plus", front,
                                   load_balance=LoadBalance.PALLAS_MERGE_PATH)
        front = filter_mask(relaxed < torch.inf, relaxed < dist)
        dist = torch.minimum(dist, relaxed)
        rounds += 1
    return dist, rounds


def operators_path(torch, graph) -> dict:
    """Phase 3f, the operator layer on the same graph (``ops/``,
    ``framework/frontier.py``): ``advance_semiring`` by both strategies
    (the bucketed kernels B3, B1 after B2, against the plain segmented
    path), ``advance`` and ``neighbor_reduce`` with Python lambdas, the
    queue operators on a 1M-entry queue, and two algorithms written on the
    operators beside the tuned runs. Returns the summary line's dict."""
    import numpy as np

    from gunrock_tpu_torch.algorithms import bfs, sssp
    from gunrock_tpu_torch.framework import mask_to_queue, queue_to_mask
    from gunrock_tpu_torch.graph import Graph
    from gunrock_tpu_torch.ops import (
        AdvanceDirection,
        LoadBalance,
        UniquifyAlgorithm,
        advance,
        filter_queue,
        neighbor_reduce,
        uniquify,
    )
    from gunrock_tpu_torch.ops.advance import advance_semiring
    from gunrock_tpu_torch.ops.configs import Options
    from gunrock_tpu_torch.utils.limits import UNREACHED

    dev = graph.device
    V, E = graph.n_vertices, graph.n_edges
    h = graph.host
    deg = np.diff(h["row_offsets"])
    top = int(np.argmax(deg))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}

    # a. advance_semiring, both strategies, on the valued graph (and the
    # plus_times sums on a unit-weight copy with integer x, where the plain
    # path's prefix sums are exact too)
    states = bfs_frontiers(torch, graph, top)
    level, level_dist, level_it = states[len(states) // 2]
    ones = np.ones(E, np.float32)
    unit = Graph.from_arrays({**h, "values": ones, "csc_values": ones}, V,
                             graph.properties, dev)
    fwd, bwd = AdvanceDirection.FORWARD, AdvanceDirection.BACKWARD
    xs = {
        "plus_times": torch.rand(V, generator=gen, device=dev),
        "min_plus": torch.where(
            torch.rand(V, generator=gen, device=dev) < 0.05, torch.inf,
            torch.rand(V, generator=gen, device=dev) * 8),
        "max_times": torch.rand(V, generator=gen, device=dev) * 2 - 1,
        "plus_times_int": torch.randint(0, 4, (V,), generator=gen,
                                        device=dev).float(),
    }
    cases = {}
    for name, x in xs.items():
        semiring = name.removesuffix("_int")
        g = unit if name.endswith("_int") else graph
        for d in (fwd, bwd):
            for fname, front in (("all", None), ("level", level)):
                def call(lb, g=g, x=x, semiring=semiring, front=front, d=d):
                    return advance_semiring(g, x, semiring, front, d, lb)

                what = f"advance_semiring {name} {d.value} {fname}"
                got = call(LoadBalance.PALLAS_MERGE_PATH)
                torch.cuda.synchronize()
                plain = call(LoadBalance.XLA_SEGMENT)
                row_t = {fwd: (g.csc_dst, g.csc_rows, g.csc_values),
                         bwd: (g.edge_src, g.col_indices, g.values)}[d]
                xa = x if front is None else torch.where(front, x, 0.0)
                if semiring == "plus_times":
                    terms = row_t[2].double() * xa[row_t[1].long()].double()
                    if name.endswith("_int"):  # both exact
                        err = sum_check(torch, what, got, row_t[0].long(),
                                        terms, plain=plain)
                        max_abs_err(torch, got, plain, True, what=what)
                    else:
                        err = sum_check(torch, what, got, row_t[0].long(),
                                        terms)
                        exact = torch.zeros(V, dtype=torch.float64,
                                            device=dev).index_add_(
                            0, row_t[0].long(), terms)
                        # the plain path's cumsum difference: reported, its
                        # error follows the total (ulp of sum |terms|)
                        ulp = float(terms.abs().sum()) * F32_ROUNDOFF
                        cases[what + " plain_err_total_ulps"] = float(
                            (plain.double() - exact).abs().max()) / ulp
                else:
                    err = max_abs_err(torch, got, plain, True, what=what)
                t = {}
                for key, lb in (("pallas", LoadBalance.PALLAS_MERGE_PATH),
                                ("plain", LoadBalance.XLA_SEGMENT)):
                    t[f"{key}_ms"] = time_ms(torch, lambda: call(lb))
                    # device busy time over 20 calls (one call's trace can
                    # miss its kernels), per call
                    prof = device_profile(lambda: [call(lb) for _ in range(20)])
                    t[f"{key}_device_ms"] = prof["busy_us"] / 20e3 \
                        if "busy_us" in prof else "not measured"
                cases[what] = {"max_abs_err": err, **t}
    out["advance_semiring"] = cases
    out["level"] = {"iteration": level_it, "size": int(level.sum()),
                    "out_edges": int(deg[level.cpu().numpy()].sum())}

    # b. advance and neighbor_reduce with Python lambdas, exact against
    # numpy (the same float32 op; sums are counts of ones)
    f_np = level.cpu().numpy()
    dist_f = torch.where(level_dist == UNREACHED, torch.inf,
                         level_dist.float())
    df_np = dist_f.cpu().numpy()
    checks = {}

    def exact(what, got, want):
        got = got.cpu().numpy()
        if not np.array_equal(got, want):
            bad = np.flatnonzero(got != want)[:5]
            raise AssertionError(f"{what}: differs from numpy at {bad}: "
                                 f"{got[bad]} vs {want[bad]}")

    red, touched = advance(graph, level, lambda s, d, e, w: dist_f[s.long()] + w,
                           "min", fwd)
    act = f_np[h["csc_rows"]]
    msg = np.where(act, df_np[h["csc_rows"]] + h["csc_values"], np.inf)
    exact("advance forward min", red,
          _reduceat(msg.astype(np.float32), h["csc_offsets"], np.minimum,
                    np.inf))
    exact("advance forward touched", touched,
          np.bincount(h["csc_dst"][act], minlength=V) > 0)
    checks["forward_min_ms"] = time_ms(torch, lambda: advance(
        graph, level, lambda s, d, e, w: dist_f[s.long()] + w, "min", fwd))

    red, touched = advance(graph, level, lambda s, d, e, w: torch.ones_like(w),
                           "sum", bwd)
    act = f_np[h["col_indices"]]
    exact("advance backward sum of ones", red,
          np.bincount(h["edge_src"][act], minlength=V).astype(np.float32))
    exact("advance backward touched", touched,
          np.bincount(h["edge_src"][act], minlength=V) > 0)
    checks["backward_sum_ms"] = time_ms(torch, lambda: advance(
        graph, level, lambda s, d, e, w: torch.ones_like(w), "sum", bwd))

    emask = torch.rand(E, generator=gen, device=dev) < 0.1
    red, touched = advance(graph, emask, lambda s, d, e, w: w, "max", fwd,
                           edge_frontier=True)
    act = emask.cpu().numpy()[h["csc_edge_perm"]]
    exact("advance edge frontier max", red,
          _reduceat(np.where(act, h["csc_values"], -np.inf).astype(np.float32),
                    h["csc_offsets"], np.maximum, -np.inf))
    checks["edge_frontier_max_ms"] = time_ms(torch, lambda: advance(
        graph, emask, lambda s, d, e, w: w, "max", fwd, edge_frontier=True))

    for direction, offs, vals in (("out", h["row_offsets"], h["values"]),
                                  ("in", h["csc_offsets"], h["csc_values"])):
        for reduce, ufunc, ident in (("min", np.minimum, np.inf),
                                     ("max", np.maximum, -np.inf)):
            exact(f"neighbor_reduce {reduce} {direction}",
                  neighbor_reduce(graph, lambda s, d, e, w: w, reduce,
                                  direction),
                  _reduceat(vals, offs, ufunc, ident).astype(np.float32))
        exact(f"neighbor_reduce sum of ones {direction}",
              neighbor_reduce(graph, lambda s, d, e, w: torch.ones_like(w),
                              "sum", direction),
              np.diff(offs).astype(np.float32))
        checks[f"neighbor_reduce_sum_{direction}_ms"] = time_ms(
            torch, lambda: neighbor_reduce(
                graph, lambda s, d, e, w: torch.ones_like(w), "sum", direction))
    out["advance"] = checks

    # c. the queue operators on a 1M-entry queue drawn with repeats from V
    cap, count = 1 << 20, 1_000_000
    rng = np.random.default_rng(SEED)
    q_np = rng.integers(0, V, cap).astype(np.int32)
    q_np[rng.random(cap) < 0.01] = -1  # invalid entries inside the live part
    q_np[count:] = -1
    data = torch.from_numpy(q_np).to(dev)
    cnt = torch.tensor(count, dtype=torch.int32, device=dev)
    live = q_np[:count][q_np[:count] >= 0]

    def queue_is(what, got, want):
        d, c = got
        if int(c) != want.size:
            raise AssertionError(f"{what}: count {int(c)}, numpy {want.size}")
        exact(what, d, np.concatenate(
            [want, np.full(cap - want.size, -1, np.int32)]).astype(np.int32))

    qt = {}
    pred = lambda x: x % 3 != 0  # noqa: E731
    queue_is("filter_queue compact", filter_queue(data, cnt, pred),
             live[live % 3 != 0])
    d, c = filter_queue(data, cnt, pred, compact=False)
    keep = (np.arange(cap) < count) & (q_np >= 0) & (q_np % 3 != 0)
    exact("filter_queue bypass", d, np.where(keep, q_np, -1))
    if int(c) != count:
        raise AssertionError("filter_queue bypass: count changed")
    _, first = np.unique(live, return_index=True)
    queue_is("uniquify scatter", uniquify(data, cnt, V), live[np.sort(first)])
    queue_is("uniquify unique", uniquify(data, cnt, V,
                                         UniquifyAlgorithm.UNIQUE),
             np.unique(live))
    mask_np = np.zeros(V, bool)
    mask_np[live] = True
    mask = queue_to_mask(data, cnt, V)
    exact("queue_to_mask", mask, mask_np)
    queue_is("mask_to_queue", mask_to_queue(mask, cap),
             np.flatnonzero(mask_np).astype(np.int32))
    for key, fn in (
            ("filter_queue_ms", lambda: filter_queue(data, cnt, pred)),
            ("uniquify_scatter_ms", lambda: uniquify(data, cnt, V)),
            ("uniquify_unique_ms", lambda: uniquify(
                data, cnt, V, UniquifyAlgorithm.UNIQUE)),
            ("queue_to_mask_ms", lambda: queue_to_mask(data, cnt, V)),
            ("mask_to_queue_ms", lambda: mask_to_queue(mask, cap))):
        qt[key] = time_ms(torch, fn)
    out["queue"] = {"capacity": cap, "count": count, "unique": int(first.size),
                    **qt}

    # d. two algorithms on the operators beside the tuned runs (reported,
    # not claimed), and bfs.run through the BFS enactor
    def mteps(dist, ms):
        reached = dist.cpu().numpy() != UNREACHED
        return int(deg[reached].sum()) / ms / 1e3

    tuned = bfs.run(graph, top, device=dev)
    qd, q_depth = queue_bfs(graph, top)
    if not torch.equal(qd, tuned.distances):
        raise AssertionError("queue BFS on the operators: distances differ "
                             "from bfs.run's")
    q_ms = time_ms(torch, lambda: queue_bfs(graph, top), n=3)
    fw = bfs.run(graph, top, options=Options(advance_direction=fwd),
                 device=dev)
    if not (torch.equal(fw.distances, tuned.distances)
            and torch.equal(fw.predecessors, tuned.predecessors)
            and fw.search_depth == tuned.search_depth):
        raise AssertionError("bfs.run FORWARD (BfsEnactor): distances, "
                             "predecessors or depth differ from the DO run's")
    s_tuned = sssp.run(graph, top, device=dev)
    bd, bf_rounds = bellman_ford(graph, top)
    err = close("Bellman-Ford on advance_semiring", bd.cpu().numpy(),
                s_tuned.distances.cpu().numpy(), 1e-5, 1e-6)
    bf_ms = time_ms(torch, lambda: bellman_ford(graph, top), n=3)
    sd = torch.where(torch.isinf(s_tuned.distances), UNREACHED, 0)
    out["algorithms"] = {
        "source": top,
        "queue_bfs": {"ms": q_ms, "depth": q_depth,
                      "mteps": mteps(qd, q_ms)},
        "bfs_run_do": {"ms": tuned.elapsed_ms, "depth": tuned.search_depth,
                       "mteps": mteps(tuned.distances, tuned.elapsed_ms)},
        "bfs_run_forward_enactor": {"ms": fw.elapsed_ms,
                                    "mteps": mteps(fw.distances, fw.elapsed_ms)},
        "bellman_ford": {"ms": bf_ms, "rounds": bf_rounds,
                         "mteps": mteps(sd, bf_ms), "max_abs_err": err},
        "sssp_run_do": {"ms": s_tuned.elapsed_ms,
                        "depth": s_tuned.search_depth,
                        "mteps": mteps(sd, s_tuned.elapsed_ms)},
    }
    out["profile"] = {
        "queue_bfs": device_profile(lambda: queue_bfs(graph, top)),
        "bellman_ford": device_profile(lambda: bellman_ford(graph, top)),
    }
    return out


# PageRank's tol for the fixed-point check: the JAX test's 1e-7 on a
# 1,024-vertex graph scaled to the mean rank of R-MAT 18's 262,144 (4e-10),
# rounded up to 1e-9, several ulps of the largest rank
PR_FIXED_POINT_TOL = 1e-9
MESH_CHECK_POINTS = 2**16  # the mesh the sweeps' plain loops run on


# the plain loops' results by case: the edge shapes run 21 times with the
# same inputs, and the plain loops (a host read a block pass) would set
# the time of each run
_PLAIN_SWEEPS: dict = {}


def _plain_sweep(name: str, what: str, args):
    from gunrock_tpu_torch.ops.kernels import async_sweep

    key = (name, what)
    if key not in _PLAIN_SWEEPS:
        _PLAIN_SWEEPS[key] = getattr(async_sweep, name + "_plain")(*args)
    return _PLAIN_SWEEPS[key]


def check_sweep_min(torch, what: str, args) -> tuple:
    """gs_sweep_min against its plain loop on the same inputs: distances
    bit for bit (infinities included), sweeps and block passes equal.
    Returns (sweeps, passes)."""
    from gunrock_tpu_torch.ops.kernels import async_sweep

    d, s, p = async_sweep.gs_sweep_min(*args)
    torch.cuda.synchronize()
    pd, ps, pp = _plain_sweep("gs_sweep_min", what, args)
    if not torch.equal(d, pd) or (s, p) != (ps, pp):
        bad = torch.nonzero(d != pd).flatten()[:5].tolist()
        raise AssertionError(f"gs_sweep_min {what}: kernel (sweeps {s}, "
                             f"passes {p}) differs from its plain loop (sweeps "
                             f"{ps}, passes {pp}); distances differ at {bad}")
    return s, p


def check_sweep_pr(torch, what: str, args, sweeps=None, f64=False) -> float:
    """gs_sweep_pr against its plain loop: within rtol 1e-5, sweeps within
    one (rounding can decide the stop; both exactly ``sweeps`` where
    given), and a second launch bit-equal to the first. With ``f64`` the
    plain loop runs in float64: a float32 running sum over a hub's tens of
    thousands of in-edges is itself off by more than 1e-5. Returns the max
    abs error."""
    from gunrock_tpu_torch.ops.kernels import async_sweep

    p, s = async_sweep.gs_sweep_pr(*args)
    torch.cuda.synchronize()
    ref = list(args)
    if f64:  # values, iweights and p0 in float64
        for i in (1, 5, 7):
            ref[i] = ref[i].double()
        what += ", float64 plain loop"
    pp, ps = _plain_sweep("gs_sweep_pr", what, ref)
    p = p.to(pp.dtype)
    rel = float(((p - pp).abs() / pp.abs()).max()) if p.numel() else 0.0
    if (not rel <= 1e-5 or abs(s - ps) > 1
            or (sweeps is not None and not s == ps == sweeps)):
        raise AssertionError(f"gs_sweep_pr {what}: rel err {rel} (limit 1e-5), "
                             f"sweeps {s} against the plain loop's {ps}")
    p2, s2 = async_sweep.gs_sweep_pr(*args)
    if not torch.equal(p2.to(p.dtype), p) or s2 != s:
        raise AssertionError(f"gs_sweep_pr {what}: two launches differ")
    return float((p - pp).abs().max()) if p.numel() else 0.0


def async_edge_shapes(torch, graph, dev) -> dict:
    """The sweep kernels at shapes the main path does not have: the V=1000
    skewed graph and its reverse (a hub destination of ~2,000 in-edges:
    the warp fold, a run across many warp tiles) in 1, 2 (every sweep's
    turnaround repeats a block), 7 and 64 blocks; a 40-vertex graph in
    more blocks than vertices (clamped to V: blocks of fewer edges than a
    warp tile) and a 12-edge graph in one block; a two-way star whose hub
    has more in-edges than 32 x the grid's warps (its run spans more warp
    tiles than the grid has warps) in 1, 2 and 7 blocks; an edgeless
    graph; a sweep cap of 0 and 1 for both kernels. PageRank runs to tol
    1e-6, and on the new shapes for a fixed 3 sweeps (tol 0), so that
    rounding cannot move the stop; on the star against the plain loop in
    float64. Returns {kernel: max abs error}."""
    import numpy as np

    from gunrock_tpu_torch.formats import Coo
    from gunrock_tpu_torch.graph import build_graph

    h = graph.host
    V = graph.n_vertices
    rng = np.random.default_rng(SEED + 3)
    small = rng.integers(0, 40, (2, 200)).astype(np.int32)
    # 32 slots a warp tile, 16 warps a block of 512 threads, one block an SM
    hub = 32 * 16 * torch.cuda.get_device_properties(dev).multi_processor_count + 1000
    leaves = np.arange(1, hub + 1, dtype=np.int32)
    star = np.concatenate([leaves, np.zeros(hub, np.int32)]), \
        np.concatenate([np.zeros(hub, np.int32), leaves])
    graphs = {
        "skewed": (graph, (1, 2, 7, 64)),
        "reversed": (build_graph(Coo(V, V, h["col_indices"], h["edge_src"],
                                     h["values"]), device=dev), (1, 2, 7, 64)),
        "small": (build_graph(Coo(40, 40, small[0], small[1], (rng.random(
            200) + 0.1).astype(np.float32)), device=dev), (3, 10_000)),
        "tiny": (build_graph(Coo(40, 40, small[0, :12], small[1, :12], (
            rng.random(12) + 0.1).astype(np.float32)), device=dev), (1,)),
        "star": (build_graph(Coo(hub + 1, hub + 1, star[0], star[1], (
            rng.random(2 * hub) + 0.1).astype(np.float32)), device=dev),
            (1, 2, 7)),
        "edgeless": (build_graph(Coo(5, 5, small[0, :0], small[1, :0],
                                     h["values"][:0]), device=dev), (1, 10_000)),
    }
    fixed = ("tiny", "star")  # PageRank for a fixed 3 sweeps
    errs = {"gs_sweep_min": 0.0, "gs_sweep_pr": 0.0}
    for name, (g, block_counts) in graphs.items():
        src = ac.top_vertex(g) if name != "star" else 1
        for n_blocks in block_counts:
            for unit in (False, True):
                check_sweep_min(torch, f"{name}, {n_blocks} blocks, unit {unit}",
                                ac.sweep_args(g, src, unit, n_blocks))
            if name in fixed or n_blocks == 2:
                e = check_sweep_pr(torch, f"{name}, {n_blocks} blocks",
                                   ac.pr_args(g, 0.0, n_blocks, max_sweeps=3),
                                   sweeps=3, f64=name == "star")
            else:
                e = check_sweep_pr(torch, f"{name}, {n_blocks} blocks",
                                   ac.pr_args(g, 1e-6, n_blocks))
            errs["gs_sweep_pr"] = max(errs["gs_sweep_pr"], e)
        for cap in (0, 1):
            s, _ = check_sweep_min(torch, f"{name}, max_sweeps {cap}",
                                   ac.sweep_args(g, src, False, 7, cap))
            if s != cap:
                raise AssertionError(f"gs_sweep_min {name}: {s} sweeps under a "
                                     f"cap of {cap}")
            e = check_sweep_pr(torch, f"{name}, max_sweeps {cap}",
                               ac.pr_args(g, 0.0, 7, max_sweeps=cap),
                               sweeps=cap, f64=name == "star")
            errs["gs_sweep_pr"] = max(errs["gs_sweep_pr"], e)
    return errs


def sweep_profile(fn, kernel: str) -> dict:
    """device_profile of one search, taken again (at most three times in
    all) while the trace holds no event of the sweep kernel ``kernel``
    (``sweep_min`` or ``sweep_pr``): in a long run the profiler at times
    returns a trace without the one long cooperative launch, and then
    nothing of its device time was measured."""
    for _ in range(3):
        prof = device_profile(fn)
        if any(kernel in k for k in prof.get("top_us", {})):
            return prof
    return {"wall_us": prof["wall_us"], "device": "not measured"}


def async_kernel_rows(torch, graph) -> dict:
    """Phase 2 for the sweep kernels: each against its plain loop on the
    R-MAT 18 graph (from its top-degree vertex; SSSP, BFS, PageRank) and on
    a Delaunay mesh of 2^16 points (SSSP natural, BFS on the RCM order,
    PageRank), where the plain loops' host reads stay within seconds; then
    timed at R-MAT 18 (SSSP; PageRank at tol 1e-7) beside the plain loop
    and the bound, with the time a block pass and what the kernel counted
    on the card: its grid barriers (it fails above one a block pass and
    the start's: one, two for PageRank) and its grid's CTAs and cluster
    size, from which ``form`` is read. Returns {name: row}."""
    from gunrock_tpu_torch.graph.reorder import rcm_sort
    from gunrock_tpu_torch.io.generators import delaunay_graph
    from gunrock_tpu_torch.ops.kernels import async_sweep

    mesh = delaunay_graph(MESH_CHECK_POINTS, seed=ac.MESH_SEED,
                          device=graph.device)
    mesh_rcm, ro = rcm_sort(mesh)
    top, mtop = ac.top_vertex(graph), ac.top_vertex(mesh)
    info, pr_err = {}, 0.0
    for what, g, src, unit in (
            ("rmat18 sssp", graph, top, False), ("rmat18 bfs", graph, top, True),
            ("mesh16 sssp natural", mesh, mtop, False),
            ("mesh16 bfs rcm", mesh_rcm, int(ro.rank[mtop]), True)):
        info[what] = check_sweep_min(torch, what, ac.sweep_args(g, src, unit))
    for what, g in (("rmat18 pr", graph), ("mesh16 pr", mesh)):
        pr_err = max(pr_err, check_sweep_pr(torch, what,
                                            ac.pr_args(g, 1e-7)))
    print(json.dumps({"sweep_checks": {k: {"sweeps": s, "passes": p}
                                       for k, (s, p) in info.items()}}))

    rows = {}
    for name, args, ops, start, replaces in (
            ("gs_sweep_min", ac.sweep_args(graph, top, False), 2, 1, ":62"),
            ("gs_sweep_pr", ac.pr_args(graph, 1e-7), 3, 2, ":215")):
        kernel = getattr(async_sweep, name)
        plain = getattr(async_sweep, name + "_plain")
        kernel(*args)
        run = dict(async_sweep.LAST_RUN[name])
        passes, barriers = run["block_passes"], run["grid_barriers"]
        if barriers > passes + start:
            raise AssertionError(f"{name}: {barriers} grid barriers in "
                                 f"{passes} block passes")
        b, by = bound_ms(*ac.bound_work(graph, passes, ops))
        prof = sweep_profile(lambda: kernel(*args), name.replace("gs_", ""))
        rows[name] = dict(
            route="cuda", source="gunrock_tpu_torch/csrc/async_sweep.cu",
            replaces="gunrock_tpu/experimental/async_sweep.py" + replaces,
            # the min-plus sweeps are held bit for bit
            max_abs_err=0.0 if name == "gs_sweep_min" else pr_err,
            ms=time_ms(torch, lambda: kernel(*args), n=3),
            plain_ms=time_ms(torch, lambda: plain(*args), n=1),
            bound_ms=b, bound_by=by, library_ms=None,
            device_ms=prof["busy_us"] / 1e3 if "busy_us" in prof else None,
            device_kernels_us={k: us for k, (us, _) in
                               prof.get("top_us", {}).items()},
            library_device_ms=None, **run,
            grid_barriers_per_pass=barriers / passes,
            form="grid" if run["cluster_ctas"] == 1 else "cluster")
        rows[name]["us_per_pass"] = rows[name]["ms"] * 1e3 / passes
        if rows[name]["device_ms"] is not None:
            rows[name]["device_us_per_pass"] = rows[name]["device_ms"] * 1e3 / passes
    return rows


def async_path(torch, graph, smi: str) -> dict:
    """Phase 3g, the async sweep (``experimental/async_sweep.py``) at full
    width: on the R-MAT 18 graph from its top-degree vertex ``sssp_async``,
    ``bfs_async`` and ``pr_async`` (natural order); on a Delaunay mesh of
    2^18 points from its top-degree vertex ``sssp_async`` natural and rcm
    and ``bfs_async`` rcm. Each search must add exactly one launch of its
    kernel. Checks: BFS depths equal ``bfs.run``'s; SSSP within rtol 1e-5
    of ``sssp.run`` (R-MAT) and of scipy's Dijkstra (mesh); rcm takes no
    more sweeps than natural on the mesh; PageRank at tol 1e-7 within rtol
    1e-2 / atol 1e-6 of ``pr.run``, two runs bit-equal, and at tol 1e-9
    within rtol 1e-4 of the float64 fixed point. Returns the summary
    line's dict."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    from gunrock_tpu_torch.algorithms import bfs, pr, sssp
    from gunrock_tpu_torch.experimental.async_sweep import (
        bfs_async,
        pr_async,
        sssp_async,
    )
    from gunrock_tpu_torch.io.generators import delaunay_graph
    from gunrock_tpu_torch.ops.kernels import _build, async_sweep

    dev = graph.device
    t0 = time.perf_counter()
    mesh = delaunay_graph(ac.MESH_POINTS, seed=ac.MESH_SEED, device=dev)
    mesh_s = time.perf_counter() - t0
    top, mtop = ac.top_vertex(graph), ac.top_vertex(mesh)
    # (graph, ordering, search, ac.kernel_cases' name of its kernel call)
    cases = [
        ("rmat18", "natural", "sssp", "rmat18_sssp",
         lambda: sssp_async(graph, top)),
        ("rmat18", "natural", "bfs", "rmat18_bfs", lambda: bfs_async(graph, top)),
        ("rmat18", "natural", "pr", "rmat18_pr_1e-7",
         lambda: pr_async(graph, tol=1e-7)),
        ("rmat18", "natural", "pr tol 1e-9", "rmat18_pr_1e-9",
         lambda: pr_async(graph, tol=PR_FIXED_POINT_TOL)),
        ("delaunay18", "natural", "sssp", "mesh18_sssp_natural",
         lambda: sssp_async(mesh, mtop)),
        ("delaunay18", "rcm", "sssp", "mesh18_sssp_rcm",
         lambda: sssp_async(mesh, mtop, ordering="rcm")),
        ("delaunay18", "rcm", "bfs", "mesh18_bfs_rcm",
         lambda: bfs_async(mesh, mtop, ordering="rcm")),
    ]
    _build.reset_launches()
    results = []
    for g, ordering, algo, key, fn in cases:
        kernel = "gs_sweep_pr" if algo.startswith("pr") else "gs_sweep_min"
        before = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3  # with any relabel
        added = {k: n - before.get(k, 0) for k, n in _build.LAUNCHES.items()
                 if n != before.get(k, 0)}
        if added != {kernel: 1}:
            raise AssertionError(f"async {algo} {g} {ordering}: launched "
                                 f"{added}, not one {kernel}")
        results.append((g, ordering, algo, key, fn, out, first,
                        dict(async_sweep.LAST_RUN[kernel])))
    launches = dict(_build.LAUNCHES)

    # checks
    def cpu(t):
        return t.cpu().numpy()

    got = {r[:3]: r[5] for r in results}  # (graph, ordering, search): out
    sd = got["rmat18", "natural", "sssp"][0]
    bd = got["rmat18", "natural", "bfs"][0]
    pa = got["rmat18", "natural", "pr"][0]
    pa_tight = got["rmat18", "natural", "pr tol 1e-9"][0]
    md_nat, s_nat, _ = got["delaunay18", "natural", "sssp"]
    md_rcm, s_rcm, _ = got["delaunay18", "rcm", "sssp"]
    mb_rcm = got["delaunay18", "rcm", "bfs"][0]
    checks = {}
    ref = bfs.run(graph, top, device=dev)
    if not torch.equal(bd, ref.distances):
        raise AssertionError("bfs_async R-MAT 18: depths differ from bfs.run's")
    mref = bfs.run(mesh, mtop, device=dev)
    if not torch.equal(mb_rcm, mref.distances):
        raise AssertionError("bfs_async delaunay rcm: depths differ from "
                             "bfs.run's")
    checks["bfs_levels"] = {"rmat18": ref.search_depth,
                            "delaunay18": mref.search_depth}
    checks["sssp_rmat18_err"] = close(
        "sssp_async R-MAT 18 against sssp.run", cpu(sd),
        cpu(sssp.run(graph, top, device=dev).distances), 1e-5, 0.0)
    h = mesh.host
    A = sp.csr_matrix((h["values"].astype(np.float64), h["col_indices"],
                       h["row_offsets"]), shape=(mesh.n_vertices,) * 2)
    want = csg.dijkstra(A, indices=mtop)
    checks["sssp_delaunay18_err"] = max(
        close("sssp_async delaunay natural against Dijkstra", cpu(md_nat),
              want, 1e-5, 0.0),
        close("sssp_async delaunay rcm against Dijkstra", cpu(md_rcm), want,
              1e-5, 0.0))
    if s_rcm > s_nat:
        raise AssertionError(f"sssp_async delaunay: rcm took {s_rcm} sweeps, "
                             f"natural {s_nat}")
    # PageRank: the float64 fixed point by power iteration on the card (one
    # sparse product an iteration, to a change below 1e-13)
    V = graph.n_vertices
    At = torch.sparse_csr_tensor(
        graph.csc_offsets.long(), graph.csc_rows.long(),
        graph.csc_values.double(), size=(V, V))
    outw = torch.zeros(V, dtype=torch.float64, device=dev).index_add_(
        0, graph.edge_src.long(), graph.values.double())
    iw = torch.where(outw != 0, 1 / outw, 0.0)
    p = torch.full((V,), 1 / V, dtype=torch.float64, device=dev)
    for _ in range(2000):
        pn = (1 - 0.85 + 0.85 * p[outw == 0].sum()) / V + 0.85 * \
            torch.sparse.mm(At, (p * iw)[:, None])[:, 0]
        done = float((pn - p).abs().max()) < 1e-13
        p = pn
        if done:
            break
    pr_rel = float(((pa_tight.double() - p).abs() / p).max())
    if not pr_rel < 1e-4:
        raise AssertionError(f"pr_async R-MAT 18 at tol {PR_FIXED_POINT_TOL}: "
                             f"{pr_rel} from the float64 fixed point (limit "
                             "rtol 1e-4)")
    checks["pr_rel_err_f64"] = pr_rel
    # tol is an absolute bound on a sweep's largest change: at 1e-7 the
    # smallest ranks ((1 - alpha) / V = 5.7e-7) stop far from the fixed
    # point, for the plain loop (the JAX semantics) as for the kernel
    checks["pr_rel_err_f64_tol_1e-7"] = float(((pa.double() - p).abs() /
                                               p).max())
    checks["pr_run_err"] = close("pr_async against pr.run", cpu(pa), cpu(
        pr.run(graph, tol=1e-7, device=dev).p), 1e-2, 1e-6)
    again, _ = pr_async(graph, tol=1e-7)
    if not torch.equal(again, pa):
        raise AssertionError("pr_async R-MAT 18: two runs differ")
    checks["pr_bit_equal"] = True

    # each search's kernel alone on its prepared inputs, timed by CUDA
    # events (the profiler at times returns no device event of a long run)
    rg, _, ro = mesh.layouts[("rcm",)]
    alone = ac.kernel_cases(graph, mesh, (rg, ro))
    out_cases = []
    for g, ordering, algo, key, fn, out, first, run in results:
        gr, kernel, args = alone[key]
        kernel = getattr(async_sweep, kernel)
        kernel_alone = time_ms(torch, lambda: kernel(*args), n=3)
        prof = sweep_profile(fn, "sweep_pr" if algo.startswith("pr")
                             else "sweep_min")
        wall = time_ms(torch, fn, n=3)
        sweeps, passes = out[1], run["block_passes"]
        pr_case = algo.startswith("pr")
        kernel_us = {k: us for k, (us, _) in prof.get("top_us", {}).items()
                     if "sweep_" in k}
        out_cases.append({
            "graph": g, "vertices": gr.n_vertices, "edges": gr.n_edges,
            "search": algo, "ordering": ordering, "sweeps": sweeps,
            "block_passes": passes, "wall_ms": wall, "first_call_ms": first,
            "device_ms": prof["busy_us"] / 1e3 if "busy_us" in prof else
            "not measured",
            "idle_share": prof.get("idle_share", "not measured"),
            "kernel_ms": sum(kernel_us.values()) / 1e3 if kernel_us else
            "not measured",
            "kernel_alone_ms": kernel_alone,
            "idle_share_events": 1 - kernel_alone / wall,
            "bound_ms": bound_ms(*ac.bound_work(gr, passes,
                                                 3 if pr_case else 2))[0],
            "grid_barriers": run["grid_barriers"], "name_power_limit": smi})
    return {"cases": out_cases, "checks": checks, "launches": launches,
            "mesh_build_s": mesh_s, "name_power_limit": smi}


def roof(graph, algo: str, ms: float, edges_visited: int = 0, **extra) -> dict:
    """The roofline columns of one run (``utils/roofline``): modelled
    bytes, their rate and its share of the card's memory rate, with the
    card's name and power limit."""
    return roofline(algo, graph.n_vertices, graph.n_edges, int(edges_visited),
                    ms, extra, device=graph.device)


def family_rooflines(graph, family: str, out: dict) -> dict:
    """Roofline columns for each algorithm of a family's summary line.
    Frontier and analysis algorithms count one pass over the edges per
    round (the JAX CLIs report no workload for them); SpGEMM counts its
    partial products."""
    E = graph.n_edges
    if family == "semiring":
        s = out["sssp"]
        return {
            "sssp": roof(graph, "sssp", s["avg_ms"], s["mteps"] * s["avg_ms"] * 1e3,
                         search_depth=max(s["depths"])),
            "pr": roof(graph, "pr", out["pr"]["ms"], E * out["pr"]["iterations"],
                       iterations=out["pr"]["iterations"]),
            "hits": roof(graph, "hits", out["hits"]["ms"],
                         E * out["hits"]["iterations"],
                         iterations=out["hits"]["iterations"]),
            "spmv": roof(graph, "spmv", out["spmv"]["ms"], E)}
    if family == "frontier":
        return {
            "color_greedy": roof(graph, "color", out["color_greedy"]["ms"],
                                 E * out["color_greedy"]["iterations"]),
            "mst": roof(graph, "mst", out["mst"]["ms"], E * out["mst"]["rounds"]),
            "kcore": roof(graph, "kcore", out["kcore"]["ms"],
                          E * out["kcore"]["rounds"]),
            "ppr": roof(graph, "ppr", out["ppr"]["ms"], E * out["ppr"]["iterations"])}
    steps = sum(out["geo"]["steps"])
    return {
        "bc": roof(graph, "bc", out["bc"]["ms"]),
        "tc": roof(graph, "tc", out["tc"]["ms"], E),
        "spgemm_esc": roof(graph, "spgemm", out["spgemm"]["esc_count_ms"],
                           out["spgemm"]["products"]),
        "geo": roof(graph, "geo", out["geo"]["ms"], E * steps, iterations=steps)}


DIST_RANKS = 4  # ranks of the gloo run on the one card
# geolocation's iterations in the distributed phase, both sides
DIST_GEO = {"total_iterations": 2, "spatial_iterations": 100}
# the backend the one-rank run must take (a card of its own)
DIST_SOLE_BACKEND = "nccl"
# the R-MAT cases timed twice (the second run is reported): the ones that
# take the kernel path, and their segment-reduction twins
DIST_REPEAT = {"bfs", "sssp", "pagerank", "spmv", "hits"}


def distributed_cases(top: int, mtop: int, x, lat, lon, perm) -> list:
    """Phase 3h's cases for ``probes.mesh.run_cases``: every sharded
    algorithm but k-core on the R-MAT graph in all_gather mode, the five
    layout algorithms also through their kernels (B1 planned by B2 for bfs
    and sssp, B3 for pagerank, spmv and hits), BFS and SSSP on the
    Delaunay mesh in the mode the partition picks, with and without
    layouts, k-core there (it peels in-degrees: undirected graphs), the
    mesh's collectives against their numpy answers, and the pieces of a
    BFS round on the R-MAT graph per rank (``round_costs``)."""
    inf = float("inf")
    R = {"graph": "rmat", "use_halo": False}
    M = {"graph": "mesh", "use_halo": None}
    cases = [
        {"name": "collectives", "algo": "collectives", "kwargs": {"seed": SEED}},
        {"name": "round", "algo": "round", "args": [top], **R},
        {"name": "bfs", "algo": "bfs", "args": [top], **R},
        {"name": "bfs_layouts", "algo": "bfs", "args": [top],
         "layouts": {"side": "d"}, **R},
        {"name": "sssp", "algo": "sssp", "args": [top], **R},
        {"name": "sssp_layouts", "algo": "sssp", "args": [top],
         "layouts": {"side": "d", "pad_value": inf}, **R},
        {"name": "pagerank", "algo": "pagerank", **R},
        {"name": "pagerank_layouts", "algo": "pagerank",
         "layouts": {"side": "d"}, **R},
        {"name": "spmv", "algo": "spmv", "args": [x], **R},
        {"name": "spmv_layouts", "algo": "spmv", "args": [x],
         "layouts": {"side": "s"}, **R},
        {"name": "hits", "algo": "hits", "kwargs": {"max_iterations": 20}, **R},
        {"name": "hits_layouts", "algo": "hits",
         "kwargs": {"max_iterations": 20},
         "layouts": [{"side": "s", "unit": True}, {"side": "d", "unit": True}],
         **R},
        {"name": "ppr", "algo": "ppr", "args": [top], **R},
        {"name": "color", "algo": "color", "kwargs": {"perm": perm}, **R},
        {"name": "color_greedy", "algo": "color_greedy", **R},
        {"name": "bc", "algo": "bc", "args": [top], **R},
        {"name": "geo", "algo": "geo", "args": [lat, lon], "kwargs": DIST_GEO,
         **R},
        {"name": "mst", "algo": "mst", **R},
        {"name": "spgemm_count", "algo": "spgemm_count", "graph_b": "rmat",
         **R},
        {"name": "tc", "algo": "tc", "graph": "rmat"},
        {"name": "mesh_bfs", "algo": "bfs", "args": [mtop], **M},
        {"name": "mesh_bfs_layouts", "algo": "bfs", "args": [mtop],
         "layouts": {"side": "d"}, **M},
        {"name": "mesh_sssp", "algo": "sssp", "args": [mtop], **M},
        {"name": "mesh_sssp_layouts", "algo": "sssp", "args": [mtop],
         "layouts": {"side": "d", "pad_value": inf}, **M},
        # the sharded k-core peels in-degrees: an undirected graph's cores
        {"name": "mesh_kcore", "algo": "kcore", **M},
    ]
    for c in cases:
        c["repeat"] = 2 if c["algo"] in DIST_REPEAT and c.get(
            "graph") == "rmat" else 1
    return cases


def distributed_refs(torch, graph, mesh, top, mtop, x, lat, lon, perm):
    """The single-device port's runs on the card that phase 3h holds the
    sharded results against: name -> (result, ms)."""
    from gunrock_tpu_torch.algorithms import (bc, bfs, color, geo, hits,
                                              kcore, mst, ppr, pr, spgemm,
                                              spmv, sssp, tc)

    dev = graph.device

    def clocked(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, (time.perf_counter() - t0) * 1e3

    refs = {}
    r = bfs.run(graph, top, device=dev)
    refs["bfs"] = (r.distances.cpu().numpy(), r.elapsed_ms)
    r = sssp.run(graph, top, device=dev)
    refs["sssp"] = (r.distances.cpu().numpy(), r.elapsed_ms)
    r = pr.run(graph, device=dev)
    refs["pagerank"] = (r.p.cpu().numpy(), r.elapsed_ms)
    r = spmv.run(graph, x, device=dev)
    refs["spmv"] = (r.y.cpu().numpy(), r.elapsed_ms)
    r = hits.run(graph, max_iterations=20, device=dev)
    refs["hits"] = ((r.auth.cpu().numpy(), r.hub.cpu().numpy(),
                     r.iterations), r.elapsed_ms)
    r = ppr.run(graph, top, device=dev)
    refs["ppr"] = (r.p.cpu().numpy(), r.elapsed_ms)
    (c, _), ms = clocked(lambda: color.color_kernel(graph, priorities=perm))
    refs["color"] = (c.cpu().numpy(), ms)
    (c, _), ms = clocked(lambda: color.color_kernel_greedy(graph))
    refs["color_greedy"] = (c.cpu().numpy(), ms)
    r = bc.run(graph, top, device=dev)
    refs["bc"] = (r.bc_values.cpu().numpy(), r.elapsed_ms)
    r = geo.run(graph, lat, lon, device=dev, **DIST_GEO)
    refs["geo"] = ((r.latitude.cpu().numpy(), r.longitude.cpu().numpy()),
                   r.elapsed_ms)
    r = mst.run(graph, device=dev)
    refs["mst"] = (r.mst_weight, r.elapsed_ms)
    r = spgemm.run(graph, graph, count_only=True, strategy="esc", device=dev)
    refs["spgemm_count"] = ((r.nnz, float(r.values[0])), r.elapsed_ms)
    r = tc.run(graph, device=dev)
    refs["tc"] = ((r.vertex_triangles_count.cpu().numpy(),
                   r.total_triangles_count), r.elapsed_ms)
    r = bfs.run(mesh, mtop, device=dev)
    refs["mesh_bfs"] = (r.distances.cpu().numpy(), r.elapsed_ms)
    r = sssp.run(mesh, mtop, device=dev)
    refs["mesh_sssp"] = (r.distances.cpu().numpy(), r.elapsed_ms)
    r = kcore.run(mesh, device=dev)
    refs["mesh_kcore"] = ((r.k_cores.cpu().numpy(), r.degeneracy),
                          r.elapsed_ms)
    return refs


def check_distributed(graph, case: dict, refs: dict) -> None:
    """Raise unless a sharded result agrees with the single-device port's:
    exact for BFS depths, k-cores, colors (and proper over every edge),
    the triangle and product counts; rtol 1e-5 for SSSP and the MST
    weight; PageRank within rtol 1e-4 / atol 1e-9 of the float64 oracle
    after as many iterations; rtol 1e-4 for SpMV and HITS (one iteration
    of slack) and for PPR (atol 1e-6) and BC (atol 1e-3), as the
    single-device checks hold them; geo as the analysis path holds its two
    paths (at most 1 in 10,000 located vertices past rtol 2e-3 + 2e-3)."""
    import numpy as np

    from gunrock_tpu_torch.examples import cpu_reference

    name, got = case["name"], case["result"]
    base = name.replace("_layouts", "")
    want = refs[base][0]
    if base in ("bfs", "mesh_bfs"):
        if not np.array_equal(got[0], want):
            raise AssertionError(f"sharded {name}: depths differ at "
                                 f"{np.flatnonzero(got[0] != want)[:5]}")
    elif base in ("sssp", "mesh_sssp"):
        close(f"sharded {name}", got[0], want, 1e-5, 0.0)
    elif base == "pagerank":
        oracle = cpu_reference.pr(graph, 0.85, tol=0.0, max_iter=got[1])
        close(f"sharded {name}", got[0], oracle, 1e-4, 1e-9)
    elif base == "spmv":
        close(f"sharded {name}", got, want, 1e-4, 1e-6)
    elif base == "hits":
        if abs(got[2] - want[2]) > 1:
            raise AssertionError(f"sharded {name}: {got[2]} iterations, "
                                 f"single device {want[2]}")
        close(f"sharded {name} auth", got[0], want[0], 1e-4, 1e-6)
        close(f"sharded {name} hub", got[1], want[1], 1e-4, 1e-6)
    elif base in ("mesh_kcore", "tc"):
        if not np.array_equal(got[0], want[0]) or got[1] != want[1]:
            raise AssertionError(f"sharded {name}: differs from one device")
    elif base == "ppr":
        close(f"sharded {name}", got[0], want, 1e-4, 1e-6)
    elif base in ("color", "color_greedy"):
        c = got[0]
        src, dst = graph.host["edge_src"], graph.host["col_indices"]
        off = src != dst
        if (c < 0).any() or (c[src[off]] == c[dst[off]]).any():
            raise AssertionError(f"sharded {name}: not a proper coloring")
        if not np.array_equal(c, want):
            raise AssertionError(f"sharded {name}: differs from one device "
                                 f"under the same priorities")
    elif base == "bc":
        close(f"sharded {name}", got, want, 1e-4, 1e-3)
    elif base == "geo":
        for g, w in zip(got, want):
            if not np.array_equal(np.isnan(g), np.isnan(w)):
                raise AssertionError(f"sharded {name}: NaNs differ")
            ok = ~np.isnan(w)
            far = np.abs(g[ok] - w[ok]) > 2e-3 + 2e-3 * np.abs(w[ok])
            if far.sum() * 10_000 > max(ok.sum(), 1):
                raise AssertionError(f"sharded {name}: {int(far.sum())} of "
                                     f"{int(ok.sum())} located vertices off")
    elif base == "mst":
        close(f"sharded {name}", [got[0]], [want], 1e-5, 0.0)
    elif base == "spgemm_count":
        if got[0] != want[0]:
            raise AssertionError(f"sharded {name}: nnz {got[0]}, one "
                                 f"device {want[0]}")
        close(f"sharded {name} checksum", [got[1]], [want[1]], 1e-4, 0.0)
    else:
        raise AssertionError(f"no check for the sharded case {name}")


# the algorithms whose result ends with their rounds (iterations)
DIST_ROUNDS = {"bfs", "sssp", "pagerank", "ppr", "color", "color_greedy",
               "hits", "mst"}
# the wall times of a BFS round's pieces each rank must report
DIST_ROUND_KEYS = ("all_gather_f32_ms", "all_gather_bool_ms",
                   "pmax_scalar_ms", "loop_test_ms", "round_local_ms")
# the kernels each layout case must launch in every rank
DIST_KERNELS = {
    "bfs_layouts": ("chunk_activity", "bucketed_semiring_spmv_sparse"),
    "sssp_layouts": ("chunk_activity", "bucketed_semiring_spmv_sparse"),
    "mesh_bfs_layouts": ("chunk_activity", "bucketed_semiring_spmv_sparse"),
    "mesh_sssp_layouts": ("chunk_activity", "bucketed_semiring_spmv_sparse"),
    "pagerank_layouts": ("bucketed_semiring_spmv",),
    "spmv_layouts": ("bucketed_semiring_spmv",),
    "hits_layouts": ("bucketed_semiring_spmv",),
}


def distributed_run(info: dict, graphs: dict, refs: dict, ranks: int,
                    backend: str) -> tuple:
    """Check one ``run_cases`` run: its backend and ranks, no jax in any
    rank, the collectives' numpy answers, every result against the single
    device, and each layout case's kernels launched in every rank.
    Returns (per-case summary, launches summed over ranks and cases)."""
    import numpy as np

    from gunrock_tpu_torch.probes.mesh import collectives_expected

    if info["backend"] != backend or info["ranks"] != ranks:
        raise AssertionError(f"distributed run: backend {info['backend']}, "
                             f"{info['ranks']} ranks; want {backend}, {ranks}")
    if any(info["foreign_modules"]):
        raise AssertionError(f"a rank imported {info['foreign_modules']}")
    summary, launches = {}, {}
    for case in info["cases"]:
        name = case["name"]
        if case["algo"] == "collectives":
            want = collectives_expected(SEED, ranks)
            for r, (g, w) in enumerate(zip(case["result"]["ranks"], want)):
                for k in w:
                    if not np.allclose(np.asarray(g[k], np.float64),
                                       np.asarray(w[k], np.float64),
                                       rtol=1e-6, atol=0.0):
                        raise AssertionError(f"collective {k} on rank {r}: "
                                             f"{g[k]} != {w[k]}")
            continue
        if case["algo"] == "round":
            by_rank = case["result"]
            if [r["rank"] for r in by_rank] != list(range(ranks)) or any(
                    r[k] <= 0 for r in by_rank for k in DIST_ROUND_KEYS):
                raise AssertionError(f"round costs: {by_rank}")
            if "bfs_profile" not in by_rank[0]:
                raise AssertionError("round costs: rank 0 profiled no BFS")
            summary[name] = {"by_rank": by_rank}
            continue
        key = "mesh" if name.startswith("mesh") else "rmat"
        check_distributed(graphs[key], case, refs)
        # every rank launched the case's kernels, but one whose layouts
        # hold no chunk (no edge into its shard): it returns the identity
        for kernel in DIST_KERNELS.get(name, ()):
            counts = [rank.get(kernel, 0) for rank in case["launches"]]
            edges = [sum(c) > 0 for c in case["layout_chunks"]]
            if any((n > 0) != e for n, e in zip(counts, edges)):
                raise AssertionError(f"sharded {name}: {kernel} launched "
                                     f"{counts} times by rank, layout "
                                     f"chunks {case['layout_chunks']}")
            if not any(edges):
                raise AssertionError(f"sharded {name}: no rank has an edge")
        for rank in case["launches"]:
            for k, v in rank.items():
                launches[k] = launches.get(k, 0) + v
        res = case["result"]
        summary[name] = {
            "ms": case["ms"][-1], "ms_runs": case["ms"],
            "setup_ms": case["setup_ms"], "case_ms": case["case_ms"],
            "single_ms": refs[name.replace("_layouts", "")][1],
            "mode": case["mode"], "bytes_per_exchange": case["bytes"],
            "rounds": res[-1] if case["algo"] in DIST_ROUNDS else None,
            "launches_by_rank": case["launches"] if name in DIST_KERNELS
            else None,
            "layout_chunks_by_rank": case["layout_chunks"]
            if name in DIST_KERNELS else None}
    return summary, launches


def distributed_path(torch, graph, smi: str) -> dict:
    """Phase 3h, the distributed layer (``parallel/``) on the card. Four
    ranks share it under gloo (collectives staged through the host) and
    run ``distributed_cases`` on the R-MAT graph (all_gather) and the
    2^18-point Delaunay mesh (the picked mode, halo); one rank runs BFS and
    SSSP through their kernels and PageRank under NCCL. Every result is
    held against the single-device port on the card
    (``check_distributed``), the layout cases' kernels must launch in every
    rank, and the bfs and pr CLIs run with ``--devices 4 --validate`` on
    the R-MAT graph written as a binary CSR. Returns the summary line's
    dict with the launches of the phase summed over ranks."""
    import numpy as np

    from gunrock_tpu_torch.examples.geo import default_labels
    from gunrock_tpu_torch.formats import Csr
    from gunrock_tpu_torch.io.generators import delaunay_graph
    from gunrock_tpu_torch.parallel.mesh import spawn
    from gunrock_tpu_torch.probes.mesh import run_cases

    t_start = time.perf_counter()
    dev = graph.device
    V = graph.n_vertices
    mesh = delaunay_graph(ac.MESH_POINTS, seed=ac.MESH_SEED, device=dev)
    top, mtop = ac.top_vertex(graph), ac.top_vertex(mesh)
    x = np.random.default_rng(SEED).random(V).astype(np.float32)
    lat, lon = default_labels(V)
    perm = torch.randperm(V, generator=torch.Generator().manual_seed(
        SEED)).numpy()
    graphs = {"rmat": graph, "mesh": mesh}
    t0 = time.perf_counter()
    refs = distributed_refs(torch, graph, mesh, top, mtop, x, lat, lon, perm)
    refs_s = time.perf_counter() - t0

    t0, wall0 = time.perf_counter(), time.time()
    info = spawn(run_cases, DIST_RANKS, graphs,
                 distributed_cases(top, mtop, x, lat, lon, perm), dev.type,
                 device=dev)
    gloo_s = time.perf_counter() - t0
    # the ranks' start (processes, imports, contexts, the graphs) and end
    gloo_start_s = info["entered"] - wall0
    gloo_end_s = time.time() - info["left"]
    cases, launches = distributed_run(info, graphs, refs, DIST_RANKS, "gloo")
    if info["staged"] != (dev.type == "cuda"):
        raise AssertionError("four ranks on one card: collectives must go "
                             "through the host")
    if cases["mesh_bfs"]["mode"] != "halo":
        raise AssertionError(f"the Delaunay mesh took "
                             f"{cases['mesh_bfs']['mode']}, not halo")

    t0 = time.perf_counter()
    sole = [c for c in distributed_cases(top, mtop, x, lat, lon, perm)
            if c["name"] in ("collectives", "round", "bfs_layouts",
                             "sssp_layouts", "pagerank")]
    info1 = spawn(run_cases, 1, {"rmat": graph}, sole, dev.type, device=dev)
    nccl_s = time.perf_counter() - t0
    cases1, launches1 = distributed_run(info1, graphs, refs, 1,
                                        DIST_SOLE_BACKEND)
    for k, v in launches1.items():
        launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    path = Path(tmp.name) / "rmat18.csr"
    h = graph.host
    Csr(V, V, h["row_offsets"], h["col_indices"], h["values"]).write_binary(
        path)
    clis = run_clis([
        ["gunrock_tpu_torch.examples.bfs", "--market", str(path), "--src",
         str(top), "--devices", str(DIST_RANKS), "--validate"],
        ["gunrock_tpu_torch.examples.pr", "--market", str(path), "--devices",
         str(DIST_RANKS), "--validate"]])
    tmp.cleanup()
    clis_s = time.perf_counter() - t0
    return {
        "ranks": DIST_RANKS, "backend": info["backend"],
        "staged": info["staged"], "cases": cases,
        "sole_rank": {"backend": info1["backend"], "cases": cases1},
        "mesh_mode": cases["mesh_bfs"]["mode"],
        "mesh_bytes_per_exchange": cases["mesh_bfs"]["bytes_per_exchange"],
        "mesh_bytes_detail": [c for c in info["cases"]
                              if c["name"] == "mesh_bfs"][0]["bytes_detail"],
        "rmat_bytes_per_exchange": cases["bfs"]["bytes_per_exchange"],
        "clis": clis, "launches": launches,
        "seconds": {"single_device_refs": refs_s, "gloo_ranks": gloo_s,
                    "gloo_rank_start": gloo_start_s,
                    "gloo_rank_end": gloo_end_s,
                    "nccl_rank": nccl_s, "clis": clis_s,
                    "total": time.perf_counter() - t_start},
        "name_power_limit": smi}


def write_mtx(path: Path, banner: str, n: int, rows, cols, vals=None) -> float:
    """Write 0-based entries as a 1-based .mtx in slices of 2^18 lines; a
    value as %.9g, which carries a float32 exactly through its decimal
    form. Returns the seconds it took."""
    t0 = time.perf_counter()
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {banner}\n"
                f"{n} {n} {len(rows)}\n")
        step = 1 << 18
        for i in range(0, len(rows), step):
            cells = [(rows[i:i + step] + 1).tolist(),
                     (cols[i:i + step] + 1).tolist()]
            if vals is not None:
                cells.append(vals[i:i + step].astype("float64").tolist())
            line = " ".join(["%d", "%d", "%.9g"][:len(cells)]) + "\n"
            flat = [x for entry in zip(*cells) for x in entry]
            f.write((line * len(cells[0])) % tuple(flat))
    return time.perf_counter() - t0


@contextlib.contextmanager
def native_io(on: bool):
    """The port's graph loading with its native parse and sort (``on``) or
    with numpy's: ``_load_native`` switched off and the sort threshold
    above any graph."""
    from gunrock_tpu_torch.formats import formats
    from gunrock_tpu_torch.io import matrix_market as mm

    saved = mm._load_native, formats.NATIVE_SORT_MIN_EDGES
    if not on:
        mm._load_native = lambda path: None
        formats.NATIVE_SORT_MIN_EDGES = 1 << 62
    try:
        yield
    finally:
        mm._load_native, formats.NATIVE_SORT_MIN_EDGES = saved


@contextlib.contextmanager
def timed_pieces(sync, times: dict):
    """Time the pieces of a graph load as it runs: the parse
    (``load_matrix_market``), each sort (``_counting_sort_to_compressed``)
    and the host-to-device copies (``Graph.from_arrays``, synchronised)."""
    from gunrock_tpu_torch.formats import formats
    from gunrock_tpu_torch.graph.graph import Graph
    from gunrock_tpu_torch.io import matrix_market as mm

    sort, parse = formats._counting_sort_to_compressed, mm.load_matrix_market
    from_arrays = Graph.__dict__["from_arrays"]

    def timed(key, fn, with_sync=False):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if with_sync:
                sync()
            times.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return run

    formats._counting_sort_to_compressed = timed("sort_s", sort)
    mm.load_matrix_market = timed("parse_s", parse)
    Graph.from_arrays = classmethod(timed("h2d_s", from_arrays.__func__, True))
    try:
        yield
    finally:
        formats._counting_sort_to_compressed = sort
        mm.load_matrix_market = parse
        Graph.from_arrays = from_arrays


def assert_same_graph(torch, what: str, a, b) -> None:
    """Every array of two Graphs equal bit for bit, on the card."""
    from gunrock_tpu_torch.graph.graph import ARRAYS

    if (a.n_vertices, a.n_edges, a.properties) != (b.n_vertices, b.n_edges,
                                                   b.properties):
        raise AssertionError(f"{what}: {a.n_vertices} vertices, {a.n_edges} "
                             f"edges, {a.properties} against {b.n_vertices}, "
                             f"{b.n_edges}, {b.properties}")
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.dtype != y.dtype or x.device != y.device or not torch.equal(x, y):
            raise AssertionError(f"{what}: {name} differs")


def ingest_path(torch, smi: str, device: str = "cuda") -> dict:
    """Phase 3i, graph loading through the native host IO
    (``gunrock_tpu_torch/_native``): the main path's R-MAT graph before
    ``degree_sort`` written as a ``real general`` .mtx, and its
    symmetrized edges as a ``pattern symmetric`` one (the lower triangle,
    which the format stores); each loaded onto the card by
    ``load_graph_file`` through the native parse and sort and through
    numpy's, every Graph array bit-equal between the two and, for the
    general file, with ``rmat_graph``'s; the pieces of each load timed;
    the main path's setup timed both ways; then the bfs and sssp CLIs on
    the general file and bfs on the symmetric one with ``--validate``.
    Fails if the native library is unavailable: the card's machine has a
    C++ compiler. ``device="cpu"`` rehearses the phase without a card."""
    import numpy as np

    from gunrock_tpu_torch import _native
    from gunrock_tpu_torch.graph.reorder import degree_sort
    from gunrock_tpu_torch.io.generators import rmat_graph
    from gunrock_tpu_torch.io.loader import load_graph_file

    t_start = time.perf_counter()
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    if not _native.available():
        raise AssertionError("ingest: no native library (no C++ compiler)")
    setup, made = {}, {}
    for mode in ("native", "numpy"):
        times = {}
        with native_io(mode == "native"), timed_pieces(sync, times):
            calls = sum(_native.CALLS.values())
            t0 = time.perf_counter()
            g = rmat_graph(SCALE, EDGE_FACTOR, seed=SEED, device=device)
            sync()
            t1 = time.perf_counter()
            sorted_g, _ = degree_sort(g)
            sync()
            t2 = time.perf_counter()
        setup[mode] = {"rmat_graph_s": t1 - t0, "degree_sort_s": t2 - t1,
                       "total_s": t2 - t0, **times,
                       "native_calls": sum(_native.CALLS.values()) - calls}
        made[mode] = g, sorted_g
    if setup["native"]["native_calls"] == 0 or setup["numpy"]["native_calls"]:
        raise AssertionError(f"ingest: setup took the wrong sort: {setup}")
    assert_same_graph(torch, "rmat_graph native/numpy", made["native"][0],
                      made["numpy"][0])
    assert_same_graph(torch, "degree_sort native/numpy", made["native"][1],
                      made["numpy"][1])
    rmat = made["native"][0]
    del made

    tmp = tempfile.TemporaryDirectory()
    V = rmat.n_vertices
    src, dst = rmat.host["edge_src"], rmat.host["col_indices"]
    general = Path(tmp.name) / "rmat18.mtx"
    symmetric = Path(tmp.name) / "rmat18_sym.mtx"
    keep = src != dst
    pairs = np.unique(np.maximum(src[keep], dst[keep]).astype(np.int64) * V
                      + np.minimum(src[keep], dst[keep]))
    files = {
        "general": {"write_s": write_mtx(general, "real general", V, src, dst,
                                         rmat.host["values"]),
                    "entries": int(src.size)},
        "symmetric": {"write_s": write_mtx(symmetric, "pattern symmetric", V,
                                           pairs // V, pairs % V),
                      "entries": int(pairs.size)},
    }
    out = {"files": files}
    for key, path in (("general", general), ("symmetric", symmetric)):
        files[key]["bytes"] = path.stat().st_size
        runs = {}
        for mode in ("native", "python"):
            times = {}
            calls = dict(_native.CALLS)
            with native_io(mode == "native"), timed_pieces(sync, times):
                sync()
                t0 = time.perf_counter()
                g, _ = load_graph_file(path, device=device)
                sync()
                times["total_s"] = time.perf_counter() - t0
            times["native_calls"] = {k: v - calls.get(k, 0)
                                     for k, v in _native.CALLS.items()}
            runs[mode] = g
            out.setdefault(key, {})[mode] = times
        took = out[key]["native"]["native_calls"]
        if not (took.get("parse_mtx") and took.get("coo_to_compressed")) or any(
                out[key]["python"]["native_calls"].values()):
            raise AssertionError(f"ingest {key}: wrong path taken: {out[key]}")
        assert_same_graph(torch, f"{key} .mtx native/python", runs["native"],
                          runs["python"])
        if key == "general":
            assert_same_graph(torch, "general .mtx/rmat_graph", runs["native"],
                              rmat)
        out[key]["n_vertices"] = runs["native"].n_vertices
        out[key]["n_edges"] = runs["native"].n_edges
        del runs

    t0 = time.perf_counter()
    on = ["--validate"] + (["--device", "cpu"] if device == "cpu" else [])
    lines = run_clis([
        ["gunrock_tpu_torch.examples.bfs", "--market", str(general), "--src",
         "0", *on],
        ["gunrock_tpu_torch.examples.sssp", "--market", str(general), "--src",
         "0", *on],
        ["gunrock_tpu_torch.examples.bfs", "--market", str(symmetric), "--src",
         "0", *on],
    ])
    if not all(line.endswith("validation: PASSED") for line in lines):
        raise AssertionError(f"ingest CLIs: {lines}")
    out["clis"] = lines
    out["clis_s"] = time.perf_counter() - t0
    tmp.cleanup()
    out["setup"] = setup
    out["seconds"] = time.perf_counter() - t_start
    out["name_power_limit"] = smi
    return out


def symmetric_loopfree(graph):
    """The undirected simple graph that triangle counting counts on
    (``tc._symmetrized_edges``, self loops dropped), built on the graph's
    device."""
    import numpy as np

    from gunrock_tpu_torch.algorithms import tc
    from gunrock_tpu_torch.formats import Coo
    from gunrock_tpu_torch.graph import GraphProperties, build_graph

    src, dst, _ = tc._symmetrized_edges(graph)
    keep = src != dst
    src, dst = src[keep].astype(np.int32), dst[keep].astype(np.int32)
    V = graph.n_vertices
    return build_graph(Coo(V, V, src, dst, np.ones(src.size, np.float32)),
                       GraphProperties(directed=False, symmetric=True),
                       device=graph.device)


def intersection_oracle(offsets, cols, u, v) -> np.ndarray:
    """JAX's count for each pair: the entries of the smaller row (u's on a
    tie) found in the other row, repeats counted."""
    import numpy as np

    out = np.empty(len(u), np.int64)
    for i, (a, b) in enumerate(zip(u.tolist(), v.tolist())):
        ra, rb = (cols[offsets[x]:offsets[x + 1]] for x in (a, b))
        small, big = (ra, rb) if ra.size <= rb.size else (rb, ra)
        out[i] = int(np.isin(small, big).sum())
    return out


def graph_accessors_path(torch, graph, smi: str) -> dict:
    """Phase 3j, Graph's accessors and degree statistics on the graph's
    device, batched over the whole graph, each checked against numpy on
    the host arrays: the counts and degrees of every vertex, the source of
    every edge, ``get_edge`` of every edge and as many seeded pairs, the
    intersection count of every undirected edge of the symmetrized
    loop-free graph (their sum is 3 x ``tc.run``'s triangles) and of
    sampled and top-degree pairs, ``intersect_neighbors`` of the two top
    hubs, the three statistics, the histogram at degrees around every
    power of two up to 2^16, and ``Timer.end(x)``. Returns the phase's
    summary line."""
    import numpy as np

    from gunrock_tpu_torch.algorithms import tc
    from gunrock_tpu_torch.formats import Coo
    from gunrock_tpu_torch.graph import Graph, GraphProperties, build_graph
    from gunrock_tpu_torch.graph import graph as graph_module
    from gunrock_tpu_torch.utils.timer import Timer

    dev = graph.device
    cuda = dev.type == "cuda"
    V, E = graph.n_vertices, graph.n_edges
    h = graph.host
    ro, cols = h["row_offsets"], h["col_indices"]
    rng = np.random.default_rng(SEED)
    ms = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def call(name, fn):
        """fn() once to warm up, then once timed (wall ms, synchronised)."""
        fn()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms[name] = (time.perf_counter() - t0) * 1e3
        if isinstance(out, torch.Tensor) and out.device != dev:
            raise AssertionError(f"{name}: result on {out.device}, not {dev}")
        return out

    def equal(what, got, want):
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        want = np.asarray(want)
        if got.shape != want.shape or not np.array_equal(got, want):
            bad = np.flatnonzero(got.ravel() != want.ravel())[:5] \
                if got.shape == want.shape else "shape"
            raise AssertionError(f"graph accessors: {what} differs from "
                                 f"numpy at {bad}")

    # counts and degrees of every vertex, the source of every edge
    if (graph.get_number_of_vertices(), graph.get_number_of_edges()) != (V, E):
        raise AssertionError("graph accessors: vertex or edge count")
    vs = torch.arange(V, device=dev)
    es = torch.arange(E, device=dev)
    equal("get_number_of_neighbors", call(
        "get_number_of_neighbors", lambda: graph.get_number_of_neighbors(vs)),
        np.diff(ro))
    equal("get_in_degree", call("get_in_degree",
                                lambda: graph.get_in_degree(vs)),
          np.diff(h["csc_offsets"]))
    equal("in_degrees", call("in_degrees", graph.in_degrees),
          np.diff(h["csc_offsets"]))
    equal("get_starting_edge", call(
        "get_starting_edge", lambda: graph.get_starting_edge(vs)), ro[:-1])
    equal("get_source_vertex", call(
        "get_source_vertex", lambda: graph.get_source_vertex(es)),
        h["edge_src"])
    equal("get_destination_vertex", call(
        "get_destination_vertex", lambda: graph.get_destination_vertex(es)),
        cols)
    equal("get_edge_weight", call(
        "get_edge_weight", lambda: graph.get_edge_weight(es)), h["values"])

    # get_edge: every edge, and as many seeded pairs
    u = np.concatenate([h["edge_src"], rng.integers(0, V, E)]).astype(np.int32)
    v = np.concatenate([cols, rng.integers(0, V, E)]).astype(np.int32)
    keys = h["edge_src"].astype(np.int64) * V + cols
    q = u.astype(np.int64) * V + v
    pos = np.searchsorted(keys, q)
    found = (pos < E) & (keys[np.minimum(pos, E - 1)] == q)
    tu, tv = torch.from_numpy(u).to(dev), torch.from_numpy(v).to(dev)
    equal("get_edge", call("get_edge", lambda: graph.get_edge(tu, tv)),
          np.where(found, pos, -1))
    pairs_found = int(found[E:].sum())

    # intersection counts: every undirected edge {u < v} of the symmetrized
    # loop-free graph sums to 3 x the triangles
    t0 = time.perf_counter()
    sym = symmetric_loopfree(graph)
    sym_s = time.perf_counter() - t0
    sh = sym.host
    upper = sh["edge_src"] < sh["col_indices"]
    eu = torch.from_numpy(sh["edge_src"][upper]).to(dev)
    ev = torch.from_numpy(sh["col_indices"][upper]).to(dev)
    sdeg = np.diff(sh["row_offsets"]).astype(np.int64)
    products = int(np.minimum(sdeg[sh["edge_src"][upper]],
                              sdeg[sh["col_indices"][upper]]).sum())
    if cuda:
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    counts = call("get_intersection_count",
                  lambda: sym.get_intersection_count(eu, ev))
    peak = torch.cuda.max_memory_allocated() - base if cuda else None
    total = int(counts.sum(dtype=torch.int64))
    triangles = tc.run(graph, device=dev).n_triangles
    if total != 3 * triangles:
        raise AssertionError(f"graph accessors: intersection counts over the "
                             f"undirected edges sum to {total}, not 3 x "
                             f"{triangles} triangles")
    # sampled and top-degree pairs against the numpy oracle, on the
    # symmetric graph and on the directed one
    top = np.argsort(-sdeg, kind="stable")[:33]
    su = np.concatenate([rng.integers(0, V, 10_000), top[:-1]])
    sv = np.concatenate([rng.integers(0, V, 10_000), top[1:]])
    for what, g in (("symmetric", sym), ("directed", graph)):
        gh = g.host
        got = g.get_intersection_count(torch.from_numpy(su).to(dev),
                                       torch.from_numpy(sv).to(dev))
        equal(f"get_intersection_count ({what}, sampled and top pairs)", got,
              intersection_oracle(gh["row_offsets"], gh["col_indices"], su, sv))

    # intersect_neighbors of the two top hubs: count and id sum
    a, b = int(top[0]), int(top[1])
    common = np.intersect1d(sh["col_indices"][sh["row_offsets"][a]:
                                              sh["row_offsets"][a + 1]],
                            sh["col_indices"][sh["row_offsets"][b]:
                                              sh["row_offsets"][b + 1]])
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    n_common = call("intersect_neighbors_count", lambda: sym.intersect_neighbors(
        a, b, lambda acc, y: acc + 1, zero))
    id_sum = call("intersect_neighbors_sum", lambda: sym.intersect_neighbors(
        a, b, lambda acc, y: acc + y, zero))
    if (int(n_common), int(id_sum)) != (common.size, int(common.sum())):
        raise AssertionError(f"graph accessors: hubs {a}, {b} have "
                             f"{common.size} common neighbours summing to "
                             f"{int(common.sum())}; intersect_neighbors gives "
                             f"{int(n_common)} and {int(id_sum)}")

    # the statistics against numpy's float64 values
    d = np.diff(ro).astype(np.float64)
    stats = {}
    for name, want in (("get_average_degree", d.mean()),
                       ("get_degree_standard_deviation", d.std())):
        got = call(name, getattr(graph, name))
        if got.dtype != torch.float32 or got.device != dev:
            raise AssertionError(f"graph accessors: {name} is {got.dtype} on "
                                 f"{got.device}")
        stats[name] = float(got)
        if abs(stats[name] - want) > 1e-5 * abs(want):
            raise AssertionError(f"graph accessors: {name} {stats[name]} "
                                 f"against numpy's {want}")

    def histogram(deg):
        bins = np.where(deg > 0, np.ceil(np.log2(
            deg.astype(np.float32).astype(np.float64) + 1)), 0)
        return np.bincount(bins.astype(np.int64), minlength=33)

    hist = call("build_degree_histogram", graph.build_degree_histogram)
    equal("build_degree_histogram", hist, histogram(np.diff(ro)))
    # and at degrees 0-4 and 2^k - 1, 2^k, 2^k + 1 up to 2^16
    degs = [0, 1, 2, 3, 4] + [2**k + i for k in range(1, 17) for i in (-1, 0, 1)]
    pv = 2**16 + 2
    psrc = np.repeat(np.arange(len(degs)), degs).astype(np.int32)
    pdst = np.concatenate([np.arange(x) for x in degs]).astype(np.int32)
    powers = build_graph(Coo(pv, pv, psrc, pdst, np.ones(psrc.size, np.float32)),
                         GraphProperties(), device=dev)
    equal("build_degree_histogram (powers of two)",
          powers.build_degree_histogram(),
          histogram(np.diff(powers.host["row_offsets"])))
    # the bin of each degree around every power of two up to 2^24, on the
    # device and on the CPU, through a stand-in for the graph
    from types import SimpleNamespace

    def bins_on(device, degrees):
        t = torch.from_numpy(degrees).to(device)
        return Graph.build_degree_histogram(SimpleNamespace(
            out_degrees=lambda: t, device=torch.device(device)))

    for d in [2**k + i for k in range(1, 25) for i in (-1, 0, 1)]:
        one = np.array([d], np.int32)
        equal(f"build_degree_histogram of degree {d} on {dev} and the cpu",
              bins_on(dev, one), bins_on("cpu", one).numpy())

    # Timer.end(x) waits for x's device; milliseconds() is its value
    timers = {}
    for kind in (("cuda",) if cuda else ()) + ("cpu",):
        timer = Timer(kind)
        timer.begin()
        x = sym.get_intersection_count(eu[:100_000], ev[:100_000])
        got = timer.end(x)
        if not got > 0 or timer.milliseconds() != got:
            raise AssertionError(f"graph accessors: Timer({kind!r}).end(x) "
                                 f"gave {got}, milliseconds() "
                                 f"{timer.milliseconds()}")
        timer.reset()
        if timer.milliseconds() != 0.0:
            raise AssertionError("graph accessors: Timer.reset()")
        timers[kind] = got
    return {
        "vertices": V, "edges": E, "ms": ms,
        "get_edge_pairs": int(u.size), "get_edge_random_found": pairs_found,
        "symmetric_edges": sym.n_edges, "undirected_edges": int(eu.numel()),
        "symmetric_build_s": sym_s,
        "intersection_products": products,
        "intersection_blocks": -(-products // graph_module.INTERSECT_BLOCK),
        "intersection_peak_bytes": peak,
        "intersection_sum": total, "triangles": triangles,
        "hubs": [a, b], "hub_common": int(n_common),
        "hub_common_id_sum": int(id_sum), **stats,
        "histogram": hist.tolist(), "timer_end_ms": timers,
        "name_power_limit": smi,
    }


def check_export(path: Path, name: str) -> dict:
    """The bfs CLI's metrics JSON: the reference's key set and schema, the
    card named in gpuinfo, mteps from the recorded times."""
    out = json.loads(path.read_text())
    if set(out) != EXPORT_KEYS or out["schema"] != "2022-10-28":
        raise AssertionError(f"metrics JSON: keys {sorted(set(out) ^ EXPORT_KEYS)} "
                             f"differ, schema {out.get('schema')}")
    if out["gpuinfo"]["name"] != name or out["tags"] != ["smoke"]:
        raise AssertionError(f"metrics JSON: gpuinfo {out['gpuinfo']}, tags "
                             f"{out['tags']}")
    if out["mteps"] != [out["edges_visited"] / t / 1000
                        for t in out["process_times"]]:
        raise AssertionError("metrics JSON: mteps is not edges / time")
    return {k: out[k] for k in ("primitive", "edges_visited", "nodes_visited",
                                "search_depths", "srcs", "avg_mteps", "gpuinfo")}


def run_clis(argvs: list) -> list:
    """Run the CLIs in subprocesses, all started together; raise unless
    each exits 0. Returns their last lines, in order."""
    cmds = [[sys.executable, "-m", *argv] for argv in argvs]
    procs = [subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    lines, failures = [], []
    deadline = time.monotonic() + 300
    for cmd, proc in zip(cmds, procs):
        try:
            stdout, stderr = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
            failures.append(f"{' '.join(cmd)} timed out:\n{stdout}\n{stderr}")
            continue
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                            f"{stdout}\n{stderr}")
        else:
            lines.append(stdout.strip().splitlines()[-1])
    if failures:
        raise AssertionError("\n".join(failures))
    return lines


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from gunrock_tpu_torch.algorithms import color, mst
    from gunrock_tpu_torch.graph.reorder import degree_sort
    from gunrock_tpu_torch.io.generators import rmat_graph
    from gunrock_tpu_torch.ops.kernels import _build
    from gunrock_tpu_torch.ops.kernels.layout import (
        dense_window_chunk,
        pull_layout,
        push_layout,
    )
    from gunrock_tpu_torch.ops.kernels.semiring import _BIG

    # 1. setup
    t_start = time.perf_counter()
    seconds = {}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc "
          f"{nvcc.strip().splitlines()[-1]}")
    print(f"built kernels in {_build.build():.1f} s")
    name = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    graph, reordering = degree_sort(rmat_graph(SCALE, EDGE_FACTOR, seed=SEED))
    # every layout of the four paths, cached on the graph for the paths
    # to reuse
    dense_w, dense_c = dense_window_chunk(graph.n_vertices)
    layouts = {
        "unit": pull_layout(graph, unit=True),
        "valued": pull_layout(graph),
        "big": pull_layout(graph, pad_value=_BIG),
        "pr": pull_layout(graph, window=dense_w, chunk=dense_c),
        "hits": push_layout(graph, window=dense_w, chunk=dense_c, unit=True),
        "spmv": push_layout(graph, window=2048, chunk=256),
        "geo": push_layout(graph, unit=True),
        "color": color._color_layout(graph),
        "rank": color._rank_color_layout(graph),
    }
    layouts["mst"], layouts["mst_ranks"] = mst._mst_rank_layout(graph)
    lay = layouts["unit"]
    print(f"R-MAT {SCALE}: {graph.n_vertices} vertices, {graph.n_edges} edges, "
          f"{lay.n_chunks} chunks at W={lay.window}/C={lay.chunk}, "
          f"{layouts['pr'].n_chunks} at W={dense_w}/C={dense_c}")
    seconds["setup"] = time.perf_counter() - t_start

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    check_edge_shapes(torch, graph.device)
    rows = check_kernels(torch, graph, layouts)
    t1 = time.perf_counter()
    rows.update(async_kernel_rows(torch, graph))
    seconds["async_kernels"] = time.perf_counter() - t1
    for k, r in rows.items():
        print(f"{k}: max_abs_err {r['max_abs_err']} ms {r['ms']:.4f} device "
              f"{r['device_ms']} plain {r['plain_ms']:.4f} bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) library "
              f"{r['library_ms']} (device {r['library_device_ms']})")
    seconds["kernels"] = time.perf_counter() - t0
    print(f"float plus_times checks: largest error {LIMIT_SHARE['max']:.4f} "
          "of its f32 summation limit")

    # the edge shapes again on the range-checking build: every computed
    # index tested before use, every launch synchronised
    t0 = time.perf_counter()
    runs = run_edge_shapes(torch, True, CHECKED_RUNS)
    print(json.dumps({"checked_edge_shapes": {
        "runs": len(runs), "faults": 0, "launches_per_run": runs[-1]}}))
    seconds["checked_edge_shapes"] = time.perf_counter() - t0

    # 3. the main paths, launches counted from zero before each
    bfs_kernels = ("chunk_activity", "bucketed_semiring_spmv_sparse",
                   "bfs_push_step", "bfs_predecessors", "msbfs_start",
                   "msbfs_pull")
    family_kernels = ("chunk_activity", "bucketed_semiring_spmv_sparse",
                      "sssp_push_step", "bucketed_semiring_spmv",
                      "hits_fused_pass", "bucketed_spmm", "sssp_predecessors")
    t0 = time.perf_counter()
    _build.reset_launches()
    bench, per_bfs = main_path(torch, graph, lay)
    launches_bfs = dict(_build.LAUNCHES)
    missing = [k for k in bfs_kernels if launches_bfs.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"BFS path launched no {missing}: {launches_bfs}")
    bench["device"] = name
    bench["name_power_limit"] = smi
    bench["roofline"] = roof(graph, "bfs", bench["avg_ms"],
                             bench["value"] * bench["avg_ms"] * 1e3,
                             search_depth=max(bench["depths"]))
    bench["launches"] = launches_bfs
    bench["launches_per_bfs"] = per_bfs
    print(json.dumps(bench))
    seconds["bfs_path"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print(json.dumps({"level_graphs": level_graph_check(torch, graph,
                                                        layouts)}))
    seconds["level_graphs"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _build.reset_launches()
    family = semiring_path(torch, graph)
    launches_family = dict(_build.LAUNCHES)
    missing = [k for k in family_kernels if launches_family.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"semiring-family path launched no {missing}: "
                             f"{launches_family}")
    family["launches"] = launches_family
    family["roofline"] = family_rooflines(graph, "semiring", family)
    family["sum_check_limit_share"] = LIMIT_SHARE["max"]
    family["name_power_limit"] = smi
    print(json.dumps({"semiring_family": family}))
    seconds["semiring_path"] = time.perf_counter() - t0

    frontier_kernels = ("chunk_activity", "bucketed_semiring_spmv_sparse",
                        "bucketed_spmm", "bucketed_semiring_spmv_sparse_minmax",
                        "bucketed_spmm_sparse", "bucketed_min_rank_cut")
    t0 = time.perf_counter()
    _build.reset_launches()
    frontier = frontier_path(torch, graph)
    launches_frontier = dict(_build.LAUNCHES)
    missing = [k for k in frontier_kernels if launches_frontier.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"frontier-family path launched no {missing}: "
                             f"{launches_frontier}")
    frontier["launches"] = launches_frontier
    frontier["roofline"] = family_rooflines(graph, "frontier", frontier)
    frontier["name_power_limit"] = smi
    print(json.dumps({"frontier_family": frontier}))
    seconds["frontier_path"] = time.perf_counter() - t0

    analysis_kernels = ("chunk_activity", "bucketed_semiring_spmv_sparse",
                        "bucketed_spmm", "bucketed_spmm_sparse",
                        "weiszfeld_step_sums_sparse", "banded_gather")
    t0 = time.perf_counter()
    _build.reset_launches()
    analysis = analysis_path(torch, graph, reordering.order)
    launches_analysis = dict(_build.LAUNCHES)
    missing = [k for k in analysis_kernels if launches_analysis.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"analysis-family path launched no {missing}: "
                             f"{launches_analysis}")
    analysis["launches"] = launches_analysis
    analysis["roofline"] = family_rooflines(graph, "analysis", analysis)
    analysis["name_power_limit"] = smi
    print(json.dumps({"analysis_family": analysis}))
    seconds["analysis_path"] = time.perf_counter() - t0

    measure_kernels = ("semiring_floor_dma", "semiring_floor_gather",
                       "bucketed_semiring_spmv", "gather", "block_copy_sum")
    t0 = time.perf_counter()
    _build.reset_launches()
    measure = measurement_path(torch, graph, layouts)
    launches_measure = dict(_build.LAUNCHES)
    missing = [k for k in measure_kernels if launches_measure.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"measurement path launched no {missing}: "
                             f"{launches_measure}")
    measure["launches"] = launches_measure
    measure["name_power_limit"] = smi
    print(json.dumps({"measurement": measure}))
    seconds["measurement_path"] = time.perf_counter() - t0

    operator_kernels = ("chunk_activity", "bucketed_semiring_spmv",
                        "bucketed_semiring_spmv_sparse")
    t0 = time.perf_counter()
    _build.reset_launches()
    operators = operators_path(torch, graph)
    launches_operators = dict(_build.LAUNCHES)
    missing = [k for k in operator_kernels if launches_operators.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"operator path launched no {missing}: "
                             f"{launches_operators}")
    operators["launches"] = launches_operators
    operators["name_power_limit"] = smi
    operators["sum_check_limit_share"] = LIMIT_SHARE["max"]
    print(json.dumps({"operators": operators}))
    seconds["operators_path"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    asyncs = async_path(torch, graph, smi)  # counts reset inside, per search
    launches_async = asyncs["launches"]
    missing = [k for k in ("gs_sweep_min", "gs_sweep_pr")
               if launches_async.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"async path launched no {missing}: "
                             f"{launches_async}")
    print(json.dumps({"async": asyncs}))
    seconds["async_path"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    distributed = distributed_path(torch, graph, smi)  # counts per rank
    launches_dist = distributed["launches"]
    print(json.dumps({"distributed": distributed}))
    seconds["distributed_path"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print(json.dumps({"ingest": ingest_path(torch, smi)}))
    seconds["ingest_path"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _build.reset_launches()
    accessors = graph_accessors_path(torch, graph, smi)
    accessors["launches"] = dict(_build.LAUNCHES)  # tc.run's, for the check
    print(json.dumps({"graph_accessors": accessors}))
    seconds["graph_accessors"] = time.perf_counter() - t0

    # 4. the CLIs, validated against the CPU oracles (chesapeake is
    # symmetric, so the hits CLI takes the symmetric dense pass)
    t0 = time.perf_counter()
    market = ["--market", "datasets/chesapeake.mtx", "--validate"]
    export_dir = tempfile.TemporaryDirectory()
    for line in run_clis([argv + market for argv in (
            ["gunrock_tpu_torch.examples.bfs", "--src", "0", "--export_metrics",
             "-d", export_dir.name, "-f", "out.json", "-t", "smoke"],
            ["gunrock_tpu_torch.examples.bfs", "--src", "0",
             "--reorder", "degree"],
            ["gunrock_tpu_torch.examples.sssp", "--src", "0"],
            ["gunrock_tpu_torch.examples.pr"],
            ["gunrock_tpu_torch.examples.hits"],
            ["gunrock_tpu_torch.examples.spmv"],
            ["gunrock_tpu_torch.examples.color"],
            ["gunrock_tpu_torch.examples.mst"],
            ["gunrock_tpu_torch.examples.kcore"],
            ["gunrock_tpu_torch.examples.ppr", "--src", "0"],
            ["gunrock_tpu_torch.examples.bc", "--src", "0"],
            ["gunrock_tpu_torch.examples.bc", "--all_sources"],
            ["gunrock_tpu_torch.examples.tc", "-r"],
            ["gunrock_tpu_torch.examples.spgemm", "--strategy", "esc"],
            ["gunrock_tpu_torch.examples.spgemm", "--strategy", "dense"],
            ["gunrock_tpu_torch.examples.geo"],
            ["gunrock_tpu_torch.examples.bfs", "--src", "0", "--mode",
             "async"],
            ["gunrock_tpu_torch.examples.sssp", "--src", "0", "--mode",
             "async", "--ordering", "rcm"])]):
        print(line)
    print(json.dumps({"export": check_export(Path(export_dir.name) / "out.json",
                                             name)}))
    export_dir.cleanup()
    seconds["clis"] = time.perf_counter() - t0

    # 5. the regression battery on the card: one process per family, all
    # started together, each running its CLI list and invariants
    from gunrock_tpu_torch.examples.regression import FAMILIES

    t0 = time.perf_counter()
    battery = {}
    for line in run_clis([["gunrock_tpu_torch.examples.regression",
                           "--families", fam] for fam in FAMILIES]):
        res = json.loads(line)["regression"]
        if res["failures"] or res["device"] != "cuda":
            raise AssertionError(f"regression battery: {res}")
        battery.update(res["seconds"])
    print(json.dumps({"regression_battery": {
        "families": len(battery), "seconds": battery,
        "name_power_limit": smi}}))
    seconds["regression"] = time.perf_counter() - t0
    seconds["total"] = time.perf_counter() - t_start
    print(json.dumps({"seconds": seconds}))

    table = [{"name": k, "launches": launches_bfs.get(k, 0)
              + launches_family.get(k, 0) + launches_frontier.get(k, 0)
              + launches_analysis.get(k, 0) + launches_measure.get(k, 0)
              + launches_operators.get(k, 0) + launches_async.get(k, 0)
              + launches_dist.get(k, 0), **r}
             for k, r in rows.items()]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
