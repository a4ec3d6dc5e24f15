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
   computing the same function.
   The semiring family's kernels (dense pass, fused HITS pass, SSSP push
   step) are checked the same way, also with negative values and a row
   window no chunk reaches, at the W=2048/C=256 pull layouts and the
   W=4096/C=1024 PageRank and HITS layouts.
   The frontier family's kernels (fused max/min pass, frontier-sparse
   SpMM, Boruvka min-cut pass) likewise, over the symmetrized coloring
   layouts and the doubled canonical MST layout.
   The analysis family's kernels (the Weiszfeld step, dense and
   chunk-skipping, and the banded gather) likewise,
   over the unit push layout with 10% of the vertices labeled and a real
   slab of the slabbed triangle count; with them the frontier-sparse
   semiring pass on every level of a BC search, the SpMM on every
   backward level of a BC batch, and the frontier-sparse SpMM on a row
   block of A, as the dense SpGEMM calls it.
   The probes' kernels likewise: the dense pass's floor modes (stream,
   gather) on the valued pull layout, the gather at every shape of the two
   gather probes, the bulk block copy at the dma probe's case and at one
   x-window per chunk.
3. main paths, each with launch counts reset just before and read just
   after; every kernel of the path must have launched:
   a. BFS: ``bfs.run`` (direction-optimizing BFS) from the 8
      highest-degree vertices, each checked against the CPU oracle, then
      multi-source BFS over the 32 highest-degree vertices;
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
      (the invariants oracle) against the scatter-sum path;
   e. the measurement path: the four probe drivers
      (``gunrock_tpu_torch.probes``): the dense pass split into stream,
      gather and scatter at R-MAT 18, W=2048/C=256 with the card's bound,
      the gathers (checked against numpy) and their rates, the block copy
      at the dma probe's case and at one window per chunk, with its rate
      beside ``x.view(-1, W)[meta].sum()``; each time comes with the
      device time of a ``torch.profiler`` trace (``utils/trace_stats``).
4. CLIs: bfs (twice; the first also with ``--export_metrics``, whose JSON
   is checked: the reference's keys, the card in ``gpuinfo``), sssp, pr,
   hits, spmv, color, mst, kcore, ppr, bc (one source, all sources), tc,
   spgemm (esc, dense) and geo with ``--validate``, all started together.

Output: the ``nvidia-smi`` name/power-limit line first, a bench line with
bench.py's keys, a ``{"semiring_family": ...}`` line, a
``{"frontier_family": ...}`` line, an ``{"analysis_family": ...}`` line
(each with roofline columns from ``utils/roofline``), the probes' lines
and a ``{"measurement": ...}`` line, an ``{"export": ...}`` line, the
seconds of each phase, then the kernel table as one JSON line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, without a CUDA
device or without the package beside it.

``edge_shapes_main()`` runs only the build and the edge-shape checks, for
``compute-sanitizer``; ``edge_shapes_main(checked=True, repeat=20)`` runs
them on the range-checking build of the kernels (``_build.py``), which
stands in where no sanitizer runs.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
try:  # the bound column (the card's published peaks) and the profiles
    from gunrock_tpu_torch.utils.roofline import bound_ms, roofline
    from gunrock_tpu_torch.utils.trace_stats import device_profile
except ImportError as exc:  # run without the package beside it
    sys.exit(f"chip_smoke: gunrock_tpu_torch is not beside this script ({exc})")

SCALE, EDGE_FACTOR, SEED, K = 18, 16, 1, 32
TC_SLABS = 5  # slabs of the slabbed triangle-counting run
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

    for active in (full, tenth):
        for om in (None, half):
            (ch, queue, count), (want, _, _) = both(
                torch, chunkplan.chunk_activity, chunkplan.chunk_activity_plain,
                lay, active, om)
            err("chunk_activity", ch, want, True, "mask")
            ids = torch.sort(queue[: int(count)]).values
            if not torch.equal(ids, torch.nonzero(want).flatten().to(torch.int32)):
                raise AssertionError("chunk_activity: queue != active chunk ids")

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

    reached = torch.rand(V, device=dev, generator=gen) < 0.3
    dist0 = torch.where(reached, 1, UNREACHED).to(torch.int32)
    for p in (0.002, 0.2):
        front = reached & (torch.rand(V, device=dev, generator=gen) < p)
        d_k, d_p = dist0.clone(), dist0.clone()
        new_k, _ = bfs.bfs_push_step(graph, front, d_k, 1, 0)
        torch.cuda.synchronize()
        new_p, _ = bfs.bfs_push_step_plain(graph, front, d_p, 1)
        err("bfs_push_step", new_k, new_p, True, "new_mask")
        err("bfs_push_step", d_k, d_p, True, "distances")
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
    for front, dist in sssp_frontiers(torch, graph, source):
        imp_k, new_k = sssp.sssp_push_step(graph, front, dist, 0)
        torch.cuda.synchronize()
        imp_p, new_p = sssp.sssp_push_step_plain(graph, front, dist)
        err(name, imp_k, imp_p, True, "improved")
        err(name, new_k, new_p, True, "distances")
    return errs


def compare_frontier_kernels(torch, graph, layouts, k: int,
                             k_batch: int = 8) -> dict:
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
    does (:func:`sum_check`)."""
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
    return errs


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


def banded_case(torch, gen, n_table: int, n_blocks: int, block_t: int,
                span_rows: int, dev):
    """(table2, idx, block_lo) for the banded gather: a random table
    padded by ``pad_table``, every block's window at a random row, 90% of
    its indices inside the window and the rest anywhere in the table or
    before it (out of window: the kernel must return the clamped
    element)."""
    from gunrock_tpu_torch.ops.kernels.banded import pad_table

    table = torch.randint(0, 1 << 30, (n_table,), generator=gen, device=dev,
                          dtype=torch.int32)
    table2 = torch.from_numpy(pad_table(table.cpu().numpy(), span_rows)).to(dev)
    n_rows = -(-n_table // 128)
    block_lo = torch.randint(0, n_rows, (n_blocks,), generator=gen,
                             device=dev, dtype=torch.int32)
    B = n_blocks * block_t
    inside = torch.randint(0, span_rows * 128, (B,), generator=gen, device=dev)
    anywhere = torch.randint(-128, table2.numel(), (B,), generator=gen,
                             device=dev)
    lo = torch.repeat_interleave(block_lo.long() * 128, block_t)
    out = torch.rand(B, device=dev, generator=gen) < 0.1
    idx = torch.where(out, anywhere, lo + inside).int()
    return table2, idx, block_lo


def compare_analysis_kernels(torch, graph, layouts, source: int,
                             block_rows: tuple, slab=None) -> dict:
    """The analysis family's kernels against their plain versions; raises
    on a mismatch. Returns {kernel: max abs error}. ``layouts``: "geo"
    (the unit push layout), "unit" and "valued" (pull layouts),
    optionally "empty_row". The two Weiszfeld-step passes by
    :func:`wstep_err`, with all, 10% and none of the rows still
    iterating; the banded gather exactly, on random windows with
    out-of-window indices, and on ``slab`` (a real slab's table,
    positions and window starts) when given. Also three kernels of the
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

    for key in [k for k in ("geo", "empty_row") if k in layouts]:
        L = layouts[key]
        for share in (0.1, 0.6):
            args = wstep_inputs(torch, L, gen, share)
            name = "weiszfeld_step_sums"
            keep(name, wstep_err(torch, f"{name} {key}", *both(
                torch, geo_step.weiszfeld_step_sums,
                geo_step.weiszfeld_step_sums_plain, L, *args)))
            name = "weiszfeld_step_sums_sparse"
            for p in (1.0, 0.1, 0.0):
                undone = torch.rand(V, device=dev, generator=gen) < p
                got, want = both(
                    torch, geo_step.weiszfeld_step_sums_sparse,
                    geo_step.weiszfeld_step_sums_sparse_plain, L, *args,
                    undone)
                keep(name, wstep_err(torch, f"{name} {key} undone {p}", got,
                                     want))
                if p == 0.0 and any(bool(y.any()) for y in got):
                    raise AssertionError(f"{name} {key}: sums without a row "
                                         "that iterates")

    name = "banded_gather"
    cases = [banded_case(torch, gen, 5000, 7, 256, 5, dev) + (256, 5),
             banded_case(torch, gen, 200_000, 33, 2048, 37, dev) + (2048, 37),
             banded_case(torch, gen, 300_000, 9, 2048, 120, dev) + (2048, 120)]
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
    analysis = compare_analysis_kernels(
        torch, graph, layouts, int(np.argmax(np.diff(graph.host["row_offsets"]))),
        (64, 32))
    for name, e in analysis.items():
        errs[name] = max(errs.get(name, 0.0), e)
    errs.update(compare_probe_kernels(torch, layouts, dev))
    empty = np.zeros(0, np.int32)
    edgeless = layout(empty, empty, empty.astype(np.float32))
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
    torch.cuda.synchronize()
    print(f"edge shapes (V={V}, W={W}, {layouts['unit'].n_chunks} chunks; "
          f"negative values; an empty row window; edgeless): max abs err "
          f"{errs}")


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
    xg = torch.randn((3, 5, 7), device=dev, generator=gen)
    for axis in (0, 1, 2):
        shape = [3, 5, 7]
        shape[axis] = 4
        idx = torch.randint(0, xg.shape[axis], shape, device=dev,
                            generator=gen, dtype=torch.int32)
        record(torch, errs, "gather", *both(
            torch, probes.gather, probes.gather_plain, xg, idx, axis), True,
            f"axis {axis}")
    idx = torch.randint(0, xg.numel(), (999,), device=dev, generator=gen,
                        dtype=torch.int32)
    record(torch, errs, "gather", *both(
        torch, probes.gather, probes.gather_plain, xg, idx, None), True, "flat")
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
    from gunrock_tpu_torch.ops.kernels import _build

    print(f"built kernels in {_build.build(checked=checked):.1f} s "
          f"(checked={checked})")
    _build.use_checked(checked)
    try:
        for i in range(repeat):
            _build.reset_launches()
            check_edge_shapes(torch, torch.device("cuda"))
            print(f"edge shapes run {i + 1}/{repeat}: ok, no fault in "
                  f"{sum(_build.LAUNCHES.values())} launches "
                  f"(checked={checked})")
    finally:
        _build.use_checked(False)
    return 0


def check_kernels(torch, graph, layouts):
    """Phase 2 at the main path's shapes: every kernel against its plain
    version, then timed. Returns {name: row} for the kernel table (launches
    are filled in from the main path)."""
    from gunrock_tpu_torch.algorithms import bfs
    from gunrock_tpu_torch.ops.kernels import chunkplan, semiring, spmm
    from gunrock_tpu_torch.utils.limits import UNREACHED

    errs = compare_kernels(torch, graph, layouts, K)
    dev = graph.device
    V = graph.n_vertices
    lay = layouts["unit"]
    n_chunks = lay.n_chunks
    n_real = int((lay.row_local != lay.window).sum())
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    full = torch.ones(V, dtype=torch.bool, device=dev)
    rows, timed = {}, {}

    # chunk plan: masks in, mask + queue out
    b, by = bound_ms(2 * V + 16 * n_chunks + n_chunks + 4 * n_chunks,
                     4 * n_chunks)
    rows["chunk_activity"] = dict(
        route="cuda", source="gunrock_tpu_torch/csrc/chunkplan.cu",
        replaces="gunrock_tpu/ops/pallas/chunkplan.py:61",
        max_abs_err=errs["chunk_activity"],
        ms=time_ms(torch, timed.setdefault(
            "chunk_activity", lambda: chunkplan.chunk_activity(lay, full, full))),
        plain_ms=time_ms(torch, lambda: chunkplan.chunk_activity_plain(lay, full, full)),
        bound_ms=b, bound_by=by, library_ms=None)

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
        library_ms=time_ms(torch, lambda: torch.sparse.mm(A, xf[:, None])))
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
        library_ms=time_ms(torch, lambda: torch.sparse.mm(A, xr)))

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
    # the device's own busy time per call (ms above is wall time between
    # CUDA events, which the host's launch overhead can set); the push
    # step's includes its 1 MB distance copy
    for name, fn in timed.items():
        prof = device_profile(lambda: [fn() for _ in range(20)])
        rows[name]["device_ms"] = (prof["busy_us"] / 20e3 if "busy_us" in prof
                                   else None)
    return rows


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
            lambda: semiring.bucketed_semiring_spmv(lay, x, "plus_times"))),
        plain_ms=time_ms(torch, lambda: semiring.bucketed_semiring_spmv_plain(
            lay, x, "plus_times")),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(torch, lambda: torch.sparse.mm(A_pull, x[:, None])),
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
    # same two sums with two calls, A.auth and A^T.hub
    lay = layouts["hits"]
    auth = torch.rand(V, device=dev, generator=gen)
    hub = torch.rand(V, device=dev, generator=gen)
    ones = torch.ones(E, device=dev)
    A = csr(graph.row_offsets, graph.col_indices, ones)
    A_t = csr(graph.csc_offsets, graph.csc_rows, ones)
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
        library_ms=time_ms(torch, lambda: (torch.sparse.mm(A, auth[:, None]),
                                           torch.sparse.mm(A_t, hub[:, None]))),
        library="torch.sparse.mm x2 (A.auth, A^T.hub), two calls")

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
    from gunrock_tpu_torch.ops.kernels import mst_min, semiring, spmm

    dev = graph.device
    V = graph.n_vertices
    errs = compare_frontier_kernels(torch, graph, layouts, K)
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
        library_ms=time_ms(torch, lambda: torch.sparse.mm(A, x1)),
        library="torch.sparse.mm (CSR)")
    print(f"bucketed_spmm_sparse K={K}, full frontier, float X, ms:",
          time_ms(torch, lambda: spmm.bucketed_spmm_sparse(rlay, xr, full,
                                                           full)),
          "torch.sparse.mm:", time_ms(torch, lambda: torch.sparse.mm(A, xr)))
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
    from gunrock_tpu_torch.algorithms import tc
    from gunrock_tpu_torch.ops.kernels import banded, geo_step

    dev = graph.device
    V = graph.n_vertices
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    # one real slab of the slabbed sort-join: what the wrapper was given
    slab = []
    kernel = tc.banded_gather

    def capture(table2, idx, block_lo, *, span_rows, block_t):
        if not slab:
            slab.append((table2, idx, block_lo, block_t, span_rows))
        return kernel(table2, idx, block_lo, span_rows=span_rows,
                      block_t=block_t)

    rk = tc.ranked_dag(graph)
    tc.banded_gather = capture
    try:
        tc.run(graph, max_wedges=-(-rk["n_wedges"] // TC_SLABS), warmup=False,
               device=dev)
    finally:
        tc.banded_gather = kernel
    table2, idx, block_lo, block_t, span_rows = slab[0]
    errs = compare_analysis_kernels(torch, graph, layouts, 0, (512, 256),
                                    slab[0])
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
    reach = int(idx.max()) - int(idx.min()) + 1
    b, by = bound_ms(8 * idx.numel() + 4 * block_lo.numel() + 4 * reach)
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
        library_ms=time_ms(torch, lambda: flat.index_select(0, idx)),
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
    gather (P2) at every shape of the two gather probes, bit for bit; the
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
        library_ms=time_ms(torch, lambda: torch.take_along_dim(xt, il, dim=axis)))

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
    # the scatter-sum path, twice: both paths add in f32 in whatever order
    # the atomics land, a vertex that converges slowly stops where that
    # noise lets its step fall under eps, and so two runs of one path
    # already differ by several 1e-3 degrees on a few dozen vertices. The
    # JAX package's tolerance between its two paths (rtol 2e-3, atol 2e-3)
    # is therefore held on all but 1 in 10,000 of the located vertices,
    # beside the same count between two runs of each path.
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

    n_out, diff = outside(res, plain)
    n_out_plain, diff_plain = outside(again, plain)
    n_out_kernel, diff_kernel = outside(
        geo.run(graph, lat, lon, warmup=False, device=dev), res)
    if n_out * 10_000 > int(located.sum()):
        raise AssertionError(
            f"geo: {n_out} of {int(located.sum())} located vertices differ "
            f"between the kernel path and the scatter-sum path by more than "
            f"2e-3 + 2e-3 |x| (largest {diff}); two scatter-sum runs: "
            f"{n_out_plain} (largest {diff_plain}); two kernel-path runs: "
            f"{n_out_kernel} (largest {diff_kernel})")
    out["geo"] = {"ms": res.elapsed_ms, "plain_ms": plain.elapsed_ms,
                  "steps": res.steps, "plain_steps": plain.steps,
                  "labeled": int(np.isfinite(lat).sum()),
                  "located": int(located.sum()),
                  "outside_tolerance_vs_plain_path": n_out,
                  "max_abs_diff_vs_plain_path": diff,
                  "outside_tolerance_plain_rerun": n_out_plain,
                  "max_abs_diff_plain_rerun": diff_plain,
                  "outside_tolerance_kernel_rerun": n_out_kernel,
                  "max_abs_diff_kernel_rerun": diff_kernel}

    out["profile"] = {
        "bc": device_profile(lambda: bc.run(
            graph, top[0], warmup=False, device=dev)),
        "geo_2_outer": device_profile(lambda: geo.run(
            graph, lat, lon, total_iterations=2, warmup=False, device=dev)),
    }
    return out


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
    for k, r in rows.items():
        print(f"{k}: max_abs_err {r['max_abs_err']} ms {r['ms']:.4f} device "
              f"{r['device_ms']} plain {r['plain_ms']:.4f} bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) library "
              f"{r['library_ms']}")
    seconds["kernels"] = time.perf_counter() - t0
    print(f"float plus_times checks: largest error {LIMIT_SHARE['max']:.4f} "
          "of its f32 summation limit")

    # 3. the main paths, launches counted from zero before each
    bfs_kernels = ("chunk_activity", "bucketed_semiring_spmv_sparse",
                   "bucketed_spmm", "bfs_push_step")
    family_kernels = ("chunk_activity", "bucketed_semiring_spmv_sparse",
                      "sssp_push_step", "bucketed_semiring_spmv",
                      "hits_fused_pass", "bucketed_spmm")
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
            ["gunrock_tpu_torch.examples.geo"])]):
        print(line)
    print(json.dumps({"export": check_export(Path(export_dir.name) / "out.json",
                                             name)}))
    export_dir.cleanup()
    seconds["clis"] = time.perf_counter() - t0
    seconds["total"] = time.perf_counter() - t_start
    print(json.dumps({"seconds": seconds}))

    table = [{"name": k, "launches": launches_bfs.get(k, 0)
              + launches_family.get(k, 0) + launches_frontier.get(k, 0)
              + launches_analysis.get(k, 0) + launches_measure.get(k, 0), **r}
             for k, r in rows.items()]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
