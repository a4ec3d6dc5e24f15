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
3. main path: ``bfs.run`` (direction-optimizing BFS) from the 8
   highest-degree vertices, each checked against the CPU oracle, then
   multi-source BFS over the 32 highest-degree vertices, each column
   checked the same way. Launch counts are reset just before and read
   just after; every kernel of the path must have launched.
4. CLI: ``python -m gunrock_tpu_torch.examples.bfs --validate``.

Output: the ``nvidia-smi`` name/power-limit line first, a bench line with
bench.py's keys, then the kernel table as one JSON line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or without the package beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's published peaks (H100 SXM data sheet), for the bound column
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
SCALE, EDGE_FACTOR, SEED, K = 18, 16, 1, 32


def bound_ms(n_bytes: float, n_ops: float = 0.0) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def device_profile(torch, fn) -> dict:
    """One warm call of ``fn`` under torch.profiler: wall time, the device's
    busy time (the sum of device self times; one stream, so no overlap)
    and its idle share, and the kernels that took the most device time.
    The profiler adds host time, so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0.0)

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in events)
    if busy_us == 0:
        return {"wall_us": wall_us, "device": "not measured"}
    top = sorted(events, key=dev_us, reverse=True)[:6]
    return {"wall_us": wall_us, "busy_us": busy_us,
            "idle_share": 1 - busy_us / wall_us,
            "top_us": {e.key[:60]: [dev_us(e), e.count] for e in top}}


def compare_kernels(torch, graph, layouts, k: int) -> dict:
    """Each kernel against its plain version on ``graph``'s shapes; raises
    on a mismatch. Returns {kernel: max abs error}. Exact for the chunk
    plan, the push step, max/min and 0/1 counts; plus_times on floats
    within rtol 1e-5 (f32 atomics sum in another order than the plain
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
        e = max_abs_err(torch, got, want, exact, what=f"{name} {what}")
        errs[name] = max(errs.get(name, 0.0), e)

    def both(kernel, plain, *args, **kw):
        got = kernel(*args, **kw)
        torch.cuda.synchronize()  # a fault surfaces at the kernel that made it
        return got, plain(*args, **kw)

    for active in (full, tenth):
        for om in (None, half):
            (ch, queue, count), (want, _, _) = both(
                chunkplan.chunk_activity, chunkplan.chunk_activity_plain,
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
                        semiring.bucketed_semiring_spmv_sparse,
                        semiring.bucketed_semiring_spmv_sparse_plain,
                        L, x, active, sr, out_mask=om, unit=unit)
                    err(name, got, want, sr != "plus_times", f"{sr} unit={unit}")
    for active in (full, tenth):  # the BFS pull itself: 0/1 counts, exact
        got, want = both(
            semiring.bucketed_semiring_spmv_sparse,
            semiring.bucketed_semiring_spmv_sparse_plain,
            lay, active.float(), active, "plus_times", out_mask=half, unit=True)
        err(name, got, want, True, "0/1")

    x01 = (torch.rand((V, k), device=dev, generator=gen) < 0.05).float()
    xr = torch.rand((V, k), device=dev, generator=gen)
    err("bucketed_spmm",
        *both(spmm.bucketed_spmm, spmm.bucketed_spmm_plain, lay, x01), True, "0/1")
    err("bucketed_spmm",
        *both(spmm.bucketed_spmm, spmm.bucketed_spmm_plain, lay, xr), False, "float")

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


def check_edge_shapes(torch, dev) -> None:
    """The kernels at shapes the main path does not have: V = 1000 is no
    multiple of the window (128) or of a warp, so the last window and the
    last warp run past V; and an edgeless layout."""
    import numpy as np

    from gunrock_tpu_torch.formats import Coo
    from gunrock_tpu_torch.graph import build_graph
    from gunrock_tpu_torch.ops.kernels import semiring, spmm
    from gunrock_tpu_torch.ops.kernels.layout import build_bucketed_layout, pull_layout

    V = 1000
    rng = np.random.default_rng(SEED)
    rows = (V * rng.random(20_000) ** 3).astype(np.int32)  # skewed: hub rows
    cols = rng.integers(0, V, 20_000).astype(np.int32)
    vals = (rng.random(20_000) + 0.1).astype(np.float32)
    graph = build_graph(Coo(V, V, rows, cols, vals), device=dev)
    layouts = {
        "unit": pull_layout(graph, window=128, chunk=128, unit=True),
        "valued": pull_layout(graph, window=128, chunk=128),
        "big": pull_layout(graph, window=128, chunk=128,
                           pad_value=semiring._BIG),
    }
    errs = compare_kernels(torch, graph, layouts, 5)
    empty = np.zeros(0, np.int32)
    edgeless = build_bucketed_layout(empty, empty, empty.astype(np.float32),
                                     V, window=128, chunk=128, device=dev)
    x = torch.ones(V, device=dev)
    act = torch.ones(V, dtype=torch.bool, device=dev)
    if not (bool((semiring.bucketed_semiring_spmv_sparse(
            edgeless, x, act, "min_plus") == torch.inf).all())
            and bool((spmm.bucketed_spmm(edgeless, x[:, None]) == 0).all())):
        raise AssertionError("edgeless layout: not the identity")
    print(f"edge shapes (V={V}, W=128, {layouts['unit'].n_chunks} chunks; "
          f"edgeless): max abs err {errs}")


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
    n_chunks, C = lay.n_chunks, lay.chunk
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
    b, by = bound_ms(8 * n_chunks * C + 4 * V + 2 * V + 4 * V + 16 * n_chunks,
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
    b, by = bound_ms(12 * n_chunks * C + 2 * 4 * V * K, 2 * n_real * K)
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
    # the device's own busy time per call (ms above is wall time between
    # CUDA events, which the host's launch overhead can set); the push
    # step's includes its 1 MB distance copy
    for name, fn in timed.items():
        prof = device_profile(torch, lambda: [fn() for _ in range(20)])
        rows[name]["device_ms"] = (prof["busy_us"] / 20e3 if "busy_us" in prof
                                   else None)
    return rows


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
        "bfs": device_profile(torch, lambda: bfs.run(
            graph, sources[0], warmup=False, device=graph.device)),
        "msbfs_k32": device_profile(torch, lambda: bfs.msbfs_kernel(
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from gunrock_tpu_torch.graph.reorder import degree_sort
    from gunrock_tpu_torch.io.generators import rmat_graph
    from gunrock_tpu_torch.ops.kernels import _build
    from gunrock_tpu_torch.ops.kernels.layout import pull_layout
    from gunrock_tpu_torch.ops.kernels.semiring import _BIG

    # 1. setup
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
    graph, _ = degree_sort(rmat_graph(SCALE, EDGE_FACTOR, seed=SEED))
    layouts = {
        "unit": pull_layout(graph, unit=True),
        "valued": pull_layout(graph),
        "big": pull_layout(graph, pad_value=_BIG),
    }
    lay = layouts["unit"]
    print(f"R-MAT {SCALE}: {graph.n_vertices} vertices, {graph.n_edges} edges, "
          f"{lay.n_chunks} chunks at W={lay.window}/C={lay.chunk}, set up in "
          f"{time.perf_counter() - t0:.1f} s")

    # 2. kernels against their plain versions
    check_edge_shapes(torch, graph.device)
    rows = check_kernels(torch, graph, layouts)
    for k, r in rows.items():
        print(f"{k}: max_abs_err {r['max_abs_err']} ms {r['ms']:.4f} device "
              f"{r['device_ms']} plain {r['plain_ms']:.4f} bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")

    # 3. main path, launches counted from zero
    _build.reset_launches()
    bench, per_bfs = main_path(torch, graph, lay)
    launches = dict(_build.LAUNCHES)
    missing = [k for k in rows if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}: {launches}")
    bench["device"] = name
    bench["name_power_limit"] = smi
    bench["launches"] = launches
    bench["launches_per_bfs"] = per_bfs
    print(json.dumps(bench))

    # 4. the CLI, validated against the CPU oracle
    for extra in ([], ["--reorder", "degree"]):
        cmd = [sys.executable, "-m", "gunrock_tpu_torch.examples.bfs",
               "--market", "datasets/chesapeake.mtx", "--src", "0",
               "--validate", *extra]
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"{' '.join(cmd)} exited {out.returncode}:\n"
                                 f"{out.stdout}\n{out.stderr}")
        print(out.stdout.strip().splitlines()[-1])

    table = [{"name": k, "launches": launches[k], **r} for k, r in rows.items()]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
