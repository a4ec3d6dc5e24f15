"""The async sweep of the PyTorch port (``experimental/async_sweep.py`` on
``ops/kernels/async_sweep.py``'s plain versions) against the JAX
package's, on the CPU.

Tolerances: the min-plus sweeps are exact (the same f32 additions, a min
over the same candidates, block by block), so distances are bit-equal and
the sweep and block-pass counts equal. PageRank sums in another order, so
its ranks are held within rtol 1e-5 and its sweeps equal; where the last
sweep's largest change lands within rounding of ``tol`` the two may stop
one sweep apart (ROADMAP C), and only that case allows one.

The numpy models at the end follow the CUDA kernels' pass schedules at a
small warp and grid (``model_sweep_min``, ``model_sweep_pr``): min-plus
bit-equal to the plain loop and to JAX, PageRank within rtol 1e-5 of both
with the same sweeps, and bit-equal whatever order its warps run in."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csg
import torch

import gunrock_tpu.experimental.async_sweep as jasync
import gunrock_tpu.io.generators as jgen

import gunrock_tpu_torch.experimental.async_sweep as tasync
import gunrock_tpu_torch.io.generators as tgen
from gunrock_tpu_torch.examples import cpu_reference
from gunrock_tpu_torch.graph import Graph, GraphProperties
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.ops.kernels import async_sweep as kernels

ROOT = Path(__file__).resolve().parent.parent
CHESAPEAKE = str(ROOT / "datasets" / "chesapeake.mtx")


def _carry(jg):
    """The JAX graph's arrays as a port graph on the CPU (own copies)."""
    return Graph.from_arrays(
        {k: np.array(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")


def _odd():
    sys.path.insert(0, str(ROOT))
    from tests.test_fuzz import _odd_graph

    jg, _ = _odd_graph(7)
    return jg, _carry(jg)


def _pair(kind):
    """(JAX graph, port graph, source)."""
    if kind == "grid32":
        return (jgen.grid2d_graph(32, weighted=True),
                tgen.grid2d_graph(32, weighted=True, device="cpu"), 0)
    if kind == "rmat10":
        jg = jgen.rmat_graph(10, 8, seed=2)
        tg = tgen.rmat_graph(10, 8, seed=2, device="cpu")
        top = int(np.argmax(np.diff(tg.host["row_offsets"])))
        return jg, tg, top
    if kind == "delaunay512":
        return (jgen.delaunay_graph(512, seed=3),
                tgen.delaunay_graph(512, seed=3, device="cpu"), 5)
    jg, tg = _odd()
    return jg, tg, int(np.argmax(np.diff(tg.host["row_offsets"])))


SEARCHES = [
    ("grid32", "natural", 32), ("grid32", "rcm", 32),
    ("rmat10", "natural", 32), ("rmat10", "rcm", 32),
    ("delaunay512", "natural", 32), ("delaunay512", "rcm", 32),
    ("delaunay512", "natural", 7),
    ("odd", "natural", 8), ("odd", "natural", 1), ("odd", "natural", 1000),
    ("odd", "rcm", 8),
]


@pytest.mark.parametrize("fn", ["sssp_async", "bfs_async"])
@pytest.mark.parametrize("kind,ordering,n_blocks", SEARCHES)
def test_min_plus_sweeps_match_jax(kind, ordering, n_blocks, fn):
    """Distances bit-equal, sweeps and block passes equal."""
    jg, tg, src = _pair(kind)
    jd, js, jp = getattr(jasync, fn)(jg, src, n_blocks=n_blocks,
                                     ordering=ordering)
    td, ts, tp = getattr(tasync, fn)(tg, src, n_blocks=n_blocks,
                                     ordering=ordering)
    assert td.dtype == (torch.float32 if fn == "sssp_async" else torch.int32)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert (ts, tp) == (js, jp)


@pytest.mark.parametrize("max_sweeps", [0, 1, 2])
def test_min_plus_sweep_cap_matches_jax(max_sweeps):
    jg, tg, src = _pair("delaunay512")
    jd, js, jp = jasync.sssp_async(jg, src, max_sweeps=max_sweeps)
    td, ts, tp = tasync.sssp_async(tg, src, max_sweeps=max_sweeps)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert (ts, tp) == (js, jp) and ts == max_sweeps


def test_async_sssp_matches_dijkstra():
    for kind in ("grid32", "rmat10", "delaunay512"):
        _, tg, src = _pair(kind)
        h = tg.host
        A = sp.csr_matrix((h["values"], h["col_indices"], h["row_offsets"]),
                          shape=(tg.n_vertices,) * 2)
        d, sweeps, passes = tasync.sssp_async(tg, src)
        np.testing.assert_allclose(d.numpy(), csg.dijkstra(A, indices=src),
                                   rtol=1e-5, atol=1e-5)
        assert sweeps >= 1 and passes >= sweeps


def test_async_bfs_beats_bsp_levels_on_grids():
    """The JAX package's target (tests/test_async_sweep.py:33-48): the
    64x64 grid (126 BSP levels) in at most 4 sweeps and 15 full-pass
    equivalents of work."""
    g = tgen.grid2d_graph(64, weighted=True, device="cpu")
    depth, sweeps, passes = tasync.bfs_async(g, 0, n_blocks=32)
    want = cpu_reference.bfs(g, 0)
    np.testing.assert_array_equal(depth.numpy(), want)
    assert want[want < 2**31 - 1].max() == 126
    assert sweeps <= 4, sweeps
    assert passes / 32 <= 15, passes


def test_rcm_is_cached_and_takes_no_more_sweeps():
    """ordering='rcm' relabels once a graph (graph.layouts[("rcm",)]) and
    maps results back to input ids; on the mesh it takes no more sweeps
    than the natural order."""
    _, tg, src = _pair("delaunay512")
    d_nat, s_nat, _ = tasync.sssp_async(tg, src)
    d_rcm, s_rcm, _ = tasync.sssp_async(tg, src, ordering="rcm")
    cached = tg.layouts[("rcm",)]
    tasync.bfs_async(tg, src, ordering="rcm")
    assert tg.layouts[("rcm",)] is cached
    torch.testing.assert_close(d_rcm, d_nat, rtol=1e-5, atol=1e-5)
    assert s_rcm <= s_nat
    with pytest.raises(ValueError, match="ordering"):
        tasync.sssp_async(tg, src, ordering="bogus")
    with pytest.raises(ValueError, match="out of range"):
        tasync.bfs_async(tg, tg.n_vertices)


PR_CASES = [("rmat10", 16, 1e-6), ("rmat10", 32, 1e-6),
            ("grid32", 32, 1e-6), ("delaunay512", 32, 1e-7),
            ("odd", 8, 1e-7), ("rmat10", 16, 1e-7)]


@pytest.mark.parametrize("kind,n_blocks,tol", PR_CASES)
def test_pr_async_matches_jax(kind, n_blocks, tol):
    jg, tg, _ = _pair(kind)
    jp, js = jasync.pr_async(jg, tol=tol, n_blocks=n_blocks)
    tp, ts = tasync.pr_async(tg, tol=tol, n_blocks=n_blocks)
    if (kind, n_blocks, tol) == ("rmat10", 16, 1e-7):
        # rounding decides the stop here: JAX 31 sweeps, the port 32
        # (ROADMAP C); at the same cap the ranks agree
        assert abs(ts - js) <= 1
        tp, ts = tasync.pr_async(tg, tol=tol, n_blocks=n_blocks,
                                 max_sweeps=js)
    assert ts == js
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=0)


def test_pr_async_near_the_float64_fixed_point():
    """As the JAX test holds its own (tests/test_async_sweep.py:99-124):
    within rtol 1e-4 of the float64 fixed point at tol 1e-7, within the
    JAX bounds of pr.run, and n_blocks=1 is Jacobi: pr.run's iteration
    count."""
    from gunrock_tpu_torch.algorithms import pr

    _, g, _ = _pair("rmat10")
    h = g.host
    V = g.n_vertices
    A = sp.csr_matrix((h["values"].astype(np.float64), h["col_indices"],
                       h["row_offsets"]), shape=(V, V))
    outw = np.asarray(A.sum(axis=1)).ravel()
    iw = np.where(outw != 0, 1 / np.maximum(outw, 1e-300), 0.0)
    p = np.full(V, 1 / V)
    for _ in range(2000):
        pn = (1 - 0.85 + 0.85 * p[outw == 0].sum()) / V + 0.85 * A.T.dot(p * iw)
        if np.abs(pn - p).max() < 1e-13:
            break
        p = pn
    p_gs, _ = tasync.pr_async(g, tol=1e-7, n_blocks=16)
    assert float(np.max(np.abs(p_gs.numpy().astype(np.float64) - p) / p)) < 1e-4
    ref = pr.run(g, tol=1e-7, device="cpu")
    np.testing.assert_allclose(p_gs.numpy(), ref.p.numpy(), rtol=1e-2,
                               atol=1e-6)
    _, s1 = tasync.pr_async(g, tol=1e-6, n_blocks=1)
    assert s1 == pr.run(g, tol=1e-6, device="cpu").iterations


def _plan(tg, n_blocks):
    v_starts, e_starts = tasync._block_plan(tg, n_blocks)
    return tg.csc_rows, tg.csc_values, tg.csc_dst, v_starts, e_starts


@pytest.mark.parametrize("kind,n_blocks", [("rmat10", 1), ("rmat10", 3),
                                           ("rmat10", 32), ("odd", 1000)])
def test_block_plan_matches_jax(kind, n_blocks):
    jg, tg, _ = _pair(kind)
    jv, _, je, _ = jasync._block_plan(jg, n_blocks)
    tv, te = tasync._block_plan(tg, n_blocks)
    assert tv.dtype == te.dtype == torch.int32
    np.testing.assert_array_equal(jv, tv.numpy())
    np.testing.assert_array_equal(je, te.numpy())


def test_wrappers_check_their_inputs():
    _, tg, src = _pair("grid32")
    rows, vals, dst, vs, es = _plan(tg, 4)
    V = tg.n_vertices
    dist0 = torch.full((V,), float("inf"))
    with pytest.raises(ValueError, match="dist0"):
        kernels.gs_sweep_min(rows, vals, dst, vs, es, dist0.double(), 10)
    with pytest.raises(ValueError, match="e_starts"):
        kernels.gs_sweep_min(rows, vals, dst, vs, es[:-1], dist0, 10)
    with pytest.raises(ValueError, match="csc_values"):
        kernels.gs_sweep_pr(rows, vals.double(), dst, vs, es,
                            torch.ones(V), torch.zeros(V, dtype=torch.bool),
                            torch.full((V,), 1.0 / V), 0.85, 1e-6, 10)
    meta = [t.to("meta") for t in (rows, vals, dst, vs, es, dist0)]
    with pytest.raises(ValueError, match="no gs_sweep_min kernel"):
        kernels.gs_sweep_min(*meta, 10)


def test_edgeless_graph_costs_one_pass_a_block():
    jg = jgen.grid2d_graph(1)  # one vertex, no edge
    tg = tgen.grid2d_graph(1, device="cpu")
    assert tg.n_edges == 0
    jd, js, jp = jasync.sssp_async(jg, 0, n_blocks=4)
    td, ts, tp = tasync.sssp_async(tg, 0, n_blocks=4)
    assert (ts, tp) == (js, jp) == (1, 1)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    jp_, js_ = jasync.pr_async(jg)
    tp_, ts_ = tasync.pr_async(tg)
    assert ts_ == js_
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp_), rtol=1e-6)


@pytest.mark.parametrize("cli,extra", [("bfs", ["--mode", "async"]),
                                       ("bfs", ["--mode", "async", "--ordering",
                                                "rcm"]),
                                       ("sssp", ["--mode", "async",
                                                 "--ordering", "rcm"]),
                                       ("sssp", ["--mode", "async"])])
def test_async_clis_validate_and_match_jax(cli, extra, capsys):
    """--mode async (and --ordering) on the bfs and sssp CLIs with
    --validate on chesapeake: the same ``async: N sweeps, M block
    passes`` line as the JAX CLI, and search_depth = the sweeps."""
    import importlib

    argv = ["--market", CHESAPEAKE, "--src", "0", "--validate", *extra]
    jmod = importlib.import_module(f"gunrock_tpu.examples.{cli}")
    tmod = importlib.import_module(f"gunrock_tpu_torch.examples.{cli}")
    jmod.main(argv)
    jout = capsys.readouterr().out
    assert tmod.main(argv + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    line = [ln for ln in jout.splitlines() if ln.startswith("async:")]
    assert line and line == [ln for ln in tout.splitlines()
                             if ln.startswith("async:")]
    sweeps = int(line[0].split()[1])
    assert f"search depth {sweeps}" in tout
    assert f"{cli} validation: PASSED" in tout


# ---------------------------------------------------------------------------
# numpy models of the CUDA kernels' pass schedules (csrc/async_sweep.cu),
# at a small "warp" (TILE lanes) and grid, so that destination runs cross
# tiles, a hub spans more tiles than the grid has warps, every sweep's
# turnaround repeats a block and plans hold edgeless blocks.

F32 = np.float32
INF = F32(np.inf)


def _plan_np(tg, n_blocks):
    rows, vals, dst, vs, es = _plan(tg, max(1, min(n_blocks, tg.n_vertices)))
    return (rows.numpy(), vals.numpy(), dst.numpy(), vs.numpy().tolist(),
            es.numpy().tolist() + [tg.n_edges])


def _tiles(e0, e1, tile):
    """The block's edges in tiles of ``tile`` slots aligned to ``tile``:
    (tile index of each edge, lane of each edge, number of tiles)."""
    base0 = e0 - e0 % tile
    e = np.arange(e0, e1)
    return (e - base0) // tile, (e - base0) % tile, (e1 - base0 + tile - 1) // tile


def model_sweep_min(rows, vals, dst, vs, es, dist0, max_sweeps, tile, seed):
    """gs_sweep_min's schedule: the commit deferred one pass over three
    buffers R[k % 3]. Pass k reads every distance as min(d, R[k-1]) while
    the commit of R[k-1] into d lands between the tiles' reads at a random
    point (seeded), folds each tile's runs by min, sends a run's min into
    R[k] only where it beats min(d, R[k-1]) of the destination (the flag),
    and clears pass k-2's R. An edgeless block counts its pass and leaves
    the commit pending. Returns (dist, sweeps, passes)."""
    rng = np.random.default_rng(seed)
    V = dist0.shape[0]
    n_blocks = len(vs) - 1
    d = dist0.astype(F32).copy()
    R = np.full((3, V), INF, F32)
    epoch, pv, qv = 0, (0, 0), (0, 0)
    sweeps = passes = 0
    changed = True
    while changed and sweeps < max_sweeps:
        order = range(n_blocks) if sweeps % 2 == 0 else range(n_blocks - 1, -1, -1)
        changed = False
        for b in order:
            v0, v1, e0, e1 = vs[b], vs[b + 1], es[b], es[b + 1]
            if e1 <= e0:
                passes += 1
                continue
            t_of, _, n_t = _tiles(e0, e1, tile)
            s, key, w = rows[e0:e1], dst[e0:e1], vals[e0:e1]
            while True:
                epoch += 1
                k = epoch
                cur, prev, nxt = R[k % 3], R[(k + 2) % 3], R[(k + 1) % 3]
                committed = d.copy()
                m = prev[pv[0]:pv[1]] != INF
                committed[pv[0]:pv[1]][m] = prev[pv[0]:pv[1]][m]
                early = rng.random(n_t) < 0.5  # tiles that read before the commit
                src_d = np.where(early[t_of], d[s], committed[s])
                key_d = np.where(early[t_of], d[key], committed[key])
                in_s = (s >= pv[0]) & (s < pv[1])
                in_k = (key >= pv[0]) & (key < pv[1])
                src_d = np.where(in_s, np.minimum(src_d, prev[s]), src_d)
                key_d = np.where(in_k, np.minimum(key_d, prev[key]), key_d)
                cand = (src_d + w).astype(F32)
                # runs: a new key or a new tile starts one
                start = np.ones(e1 - e0, bool)
                start[1:] = (key[1:] != key[:-1]) | (t_of[1:] != t_of[:-1])
                heads = np.flatnonzero(start)
                run_min = np.minimum.reduceat(cand, heads)
                low = run_min < key_d[heads]
                np.minimum.at(cur, key[heads][low], run_min[low])
                d = committed
                nxt[qv[0]:qv[1]] = INF
                qv, pv = pv, (v0, v1)
                passes += 1
                if not low.any():
                    break
                changed = True
        sweeps += 1
    last = R[epoch % 3]
    m = last[pv[0]:pv[1]] != INF
    d[pv[0]:pv[1]][m] = last[pv[0]:pv[1]][m]
    return d, sweeps, passes


def _warp_tree(x, width):
    """__shfl_down_sync's sum tree over ``width`` lanes: lane 0's result."""
    x = list(x)
    off = width // 2
    while off:
        x = [x[lane] + x[lane + off] if lane + off < width else x[lane]
             for lane in range(width)]
        off //= 2
    return x[0]


def _butterfly(x, width):
    """__shfl_xor_sync's sum tree over ``width`` lanes (every lane ends
    with the same bits): lane 0's result."""
    x = list(x)
    off = width // 2
    while off:
        x = [x[lane] + x[lane ^ off] for lane in range(width)]
        off //= 2
    return x[0]


def model_sweep_pr(rows, vals, dst, vs, es, iw, dangling, p0, alpha, tol,
                   max_sweeps, tile, grid, warps_per_cta, seed):
    """gs_sweep_pr's schedule with ``tile`` lanes a warp, ``warps_per_cta``
    warps a CTA and ``grid`` CTAs: warp w takes tiles w, w + n_warps, ...,
    two at a time, folds each tile's runs by the segmented suffix tree; a
    run whole in its tile finishes its vertex, a crossing run publishes its
    partial, and the warp holding the vertex's last tile adds the partials
    (lane l: tiles ta + l, ta + l + tile, ..., then the butterfly, then its
    own); vertices without in-edges take base; new ranks and p * iw stage
    by pass parity. Each thread sums its dangling changes in the order it
    finishes vertices; a CTA folds its threads by the warp tree and then
    warp by warp; the slots fold lane by lane and by the butterfly. The
    warps run in a random order (seeded): the bits must not depend on it.
    Returns (p, sweeps)."""
    rng = np.random.default_rng(seed)
    V = p0.shape[0]
    n_blocks = len(vs) - 1
    alpha32, oma = F32(alpha), F32(1.0 - alpha)
    n_warps = grid * warps_per_cta
    n_threads = n_warps * tile
    p = p0.astype(F32).copy()
    q = (p * iw).astype(F32)
    st = np.zeros((2, V), F32)
    qst = np.zeros((2, V), F32)
    indeg = np.zeros(V, np.int64)
    np.add.at(indeg, dst, 1)
    offsets = np.concatenate([[0], np.cumsum(indeg)])

    def fold_cta(acc_s, acc_m):
        """Each CTA's (sum, max) slot from its threads' accumulators."""
        slots = []
        per = warps_per_cta * tile
        for c in range(grid):
            ws, wm = [], []
            for wl in range(warps_per_cta):
                lo = c * per + wl * tile
                ws.append(_warp_tree(acc_s[lo:lo + tile], tile))
                wm.append(max(acc_m[lo:lo + tile]))
            s, m = F32(0), F32(0)
            for x in ws:
                s = F32(s + x)
            slots.append((s, max([m] + wm)))
        lanes_s = [F32(0)] * tile
        lanes_m = [F32(0)] * tile
        for g, (s, m) in enumerate(slots):
            lanes_s[g % tile] = F32(lanes_s[g % tile] + s)
            lanes_m[g % tile] = max(lanes_m[g % tile], m)
        return _butterfly(lanes_s, tile), max(lanes_m)

    # the dangling mass: thread tid adds alpha * p0[v] for v = tid, tid +
    # n_threads, ...
    acc = [F32(0)] * n_threads
    for v in range(V):
        if dangling[v]:
            acc[v % n_threads] = F32(acc[v % n_threads] + alpha32 * p[v])
    dsum = fold_cta(acc, [F32(0)] * n_threads)[0]
    sweeps, err = 0, np.inf
    pv = (0, 0)
    epoch = 1
    while err >= tol and sweeps < max_sweeps:
        order = range(n_blocks) if sweeps % 2 == 0 else range(n_blocks - 1, -1, -1)
        err = F32(0)
        for b in order:
            v0, v1, e0, e1 = vs[b], vs[b + 1], es[b], es[b + 1]
            if v1 <= v0:
                continue
            epoch += 1
            k = epoch
            new, old_st = st[k & 1], st[(k - 1) & 1]
            qnew, qold = qst[k & 1], qst[(k - 1) & 1]
            base = F32(F32(oma + dsum) / F32(V))

            def rank(x):
                return np.where((x >= pv[0]) & (x < pv[1]), old_st[x], p[x])

            def qrank(x):
                return np.where((x >= pv[0]) & (x < pv[1]), qold[x], q[x])

            acc_s = [F32(0)] * n_threads
            acc_m = [F32(0)] * n_threads

            def finish(thread, v, s, old):
                nw = F32(base + s)
                new[v] = nw
                qnew[v] = F32(nw * iw[v])
                d = F32(nw - old)
                if dangling[v]:
                    acc_s[thread] = F32(acc_s[thread] + d)
                acc_m[thread] = max(acc_m[thread], abs(d))

            base0 = e0 - e0 % tile
            n_t = (e1 - base0 + tile - 1) // tile if e1 > e0 else 0
            # lanes of every tile: key -1 off the block
            e_all = base0 + np.arange(n_t * tile)
            real = (e_all >= e0) & (e_all < e1)
            ec = np.clip(e_all, 0, max(len(rows) - 1, 0))
            key = np.where(real, dst[ec] if len(rows) else -1, -1).reshape(n_t, tile)
            term = np.where(real, qrank(rows[ec]) * vals[ec] if len(rows) else 0,
                            F32(0)).astype(F32).reshape(n_t, tile)
            # the segmented suffix tree of each tile
            x = term.copy()
            off = 1
            while off < tile:
                sh = np.zeros_like(x)
                sk = np.full_like(key, -2)
                sh[:, :-off], sk[:, :-off] = x[:, off:], key[:, off:]
                x = np.where(sk == key, (x + sh).astype(F32), x)
                off *= 2
            part_first, part_last = {}, {}
            finishers = []  # (warp, batch, r, tile, v)
            for t in range(n_t):
                kt = key[t]
                for lane in range(tile):
                    v = kt[lane]
                    if v < 0 or (lane > 0 and kt[lane - 1] == v):
                        continue
                    e = base0 + t * tile + lane
                    before = lane == 0 and e - 1 >= e0 and dst[e - 1] == v
                    last = lane + 1 + int(np.sum(kt[lane + 1:] == v))
                    after = (last == tile and base0 + (t + 1) * tile < e1
                             and dst[base0 + (t + 1) * tile] == v)
                    if before and after:
                        part_first[t] = x[t, lane]
                    elif after:
                        part_last[t] = x[t, lane]
                    elif not before:
                        finishers.append(("whole", t, lane, v, x[t, lane]))
                    else:
                        finishers.append(("last", t, lane, v, x[t, lane]))
            # each warp's events in its own order; the warps in random order
            by_warp = {}
            for kind, t, lane, v, xv in finishers:
                w = t % n_warps
                r0 = (t // n_warps) // 2
                by_warp.setdefault(w, []).append(
                    ((r0, 0 if kind == "whole" else 1, t), kind, t, lane, v, xv))
            for w in rng.permutation(sorted(by_warp)):
                for _, kind, t, lane, v, xv in sorted(by_warp[w],
                                                      key=lambda z: z[0]):
                    old = rank(np.array([v]))[0]
                    if kind == "whole":
                        finish(w * tile + lane, v, xv, old)
                        continue
                    ta = (offsets[v] - base0) // tile
                    lanes = [F32(0)] * tile
                    for qq in range(ta, t):
                        val = part_last[qq] if qq == ta else part_first[qq]
                        lanes[(qq - ta) % tile] = F32(lanes[(qq - ta) % tile] + val)
                    finish(w * tile, v, F32(_butterfly(lanes, tile) + xv), old)
            # vertices without in-edges: thread tid takes v0 + tid + j *
            # n_threads, in increasing v
            for v in range(v0, v1):
                if indeg[v] == 0:
                    finish((v - v0) % n_threads, v, F32(0), rank(np.array([v]))[0])
            p[pv[0]:pv[1]] = old_st[pv[0]:pv[1]]
            q[pv[0]:pv[1]] = qold[pv[0]:pv[1]]
            s, m = fold_cta(acc_s, acc_m)
            dsum = F32(dsum + F32(alpha32 * s))
            err = max(err, m)
            pv = (v0, v1)
        sweeps += 1
    p[pv[0]:pv[1]] = st[epoch & 1][pv[0]:pv[1]]
    return p, sweeps


MODEL_MIN_CASES = [("grid32", 32, 4), ("rmat10", 32, 4), ("rmat10", 2, 8),
                   ("delaunay512", 7, 4), ("odd", 1000, 4), ("odd", 8, 2),
                   ("rmat10", 1, 4)]


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("kind,n_blocks,tile", MODEL_MIN_CASES)
def test_min_plus_schedule_model_matches_plain_and_jax(kind, n_blocks, tile,
                                                       unit):
    """The deferred commit over three buffers gives the plain loop's (and
    JAX's) distances bit for bit and the same sweeps and passes, wherever
    the commit lands among the tiles' reads (two seeds)."""
    jg, tg, src = _pair(kind)
    rows, vals, dst, vs, es = _plan_np(tg, n_blocks)
    if unit:
        vals = np.ones_like(vals)
    V = tg.n_vertices
    dist0 = np.full(V, np.inf, F32)
    dist0[src] = 0
    pd, ps, pp = kernels.gs_sweep_min_plain(
        *(torch.from_numpy(a) for a in (rows, vals, dst)),
        torch.tensor(vs, dtype=torch.int32),
        torch.tensor(es[:-1], dtype=torch.int32), torch.from_numpy(dist0),
        2 * V)
    for seed in (0, 1):
        d, s, p = model_sweep_min(rows, vals, dst, vs, es, dist0, 2 * V, tile,
                                  seed)
        np.testing.assert_array_equal(d, pd.numpy())
        assert (s, p) == (ps, pp)
    fn = jasync.bfs_async if unit else jasync.sssp_async
    jd, js, jp = fn(jg, src, n_blocks=len(vs) - 1)
    assert (s, p) == (js, jp)
    if unit:  # JAX's depths: int32, unreached as int32 max
        jd = np.asarray(jd)
        np.testing.assert_array_equal(np.isinf(d), jd == np.iinfo(np.int32).max)
        np.testing.assert_array_equal(d[~np.isinf(d)], jd[~np.isinf(d)])
    else:
        np.testing.assert_array_equal(d, np.asarray(jd))


@pytest.mark.parametrize("max_sweeps", [0, 1])
def test_min_plus_schedule_model_sweep_cap(max_sweeps):
    _, tg, src = _pair("delaunay512")
    rows, vals, dst, vs, es = _plan_np(tg, 7)
    dist0 = np.full(tg.n_vertices, np.inf, F32)
    dist0[src] = 0
    d, s, p = model_sweep_min(rows, vals, dst, vs, es, dist0, max_sweeps, 4, 0)
    pd, ps, pp = kernels.gs_sweep_min_plain(
        *(torch.from_numpy(a) for a in (rows, vals, dst)),
        torch.tensor(vs, dtype=torch.int32),
        torch.tensor(es[:-1], dtype=torch.int32), torch.from_numpy(dist0),
        max_sweeps)
    np.testing.assert_array_equal(d, pd.numpy())
    assert (s, p) == (ps, pp) and s == max_sweeps


MODEL_PR_CASES = [("rmat10", 16, 1e-6, 4, 3, 2), ("rmat10", 2, 1e-6, 8, 2, 2),
                  ("grid32", 32, 1e-6, 4, 4, 2), ("delaunay512", 32, 1e-7, 4, 3, 2),
                  ("odd", 8, 1e-7, 2, 2, 1), ("rmat10", 1, 1e-6, 4, 1, 1)]


def _pr_inputs(tg, n_blocks, alpha=0.85):
    from gunrock_tpu_torch.algorithms.pr import compute_iweights

    rows, vals, dst, vs, es = _plan_np(tg, n_blocks)
    iw = compute_iweights(tg, 1.0).numpy()
    return (rows, (vals * F32(alpha)).astype(F32), dst, vs, es, iw, iw == 0,
            np.full(tg.n_vertices, 1.0 / tg.n_vertices, F32))


@pytest.mark.parametrize("kind,n_blocks,tol,tile,grid,wpc", MODEL_PR_CASES)
def test_pagerank_schedule_model_matches_plain_and_jax(kind, n_blocks, tol,
                                                       tile, grid, wpc):
    """Edge tiles with tagged partials finished by the vertex's last tile,
    parity staging and slot folds: within rtol 1e-5 of the plain loop and
    of JAX with the same sweeps (no case here stops within rounding of
    tol), and bit-equal across two runs whose warps go in different
    orders."""
    jg, tg, _ = _pair(kind)
    rows, vals, dst, vs, es, iw, dang, p0 = _pr_inputs(tg, n_blocks)
    args = (rows, vals, dst, vs, es, iw, dang, p0, 0.85, tol, 10_000, tile,
            grid, wpc)
    p1, s1 = model_sweep_pr(*args, seed=0)
    p2, s2 = model_sweep_pr(*args, seed=1)
    np.testing.assert_array_equal(p1, p2)
    assert s1 == s2
    pp, ps = kernels.gs_sweep_pr_plain(
        *(torch.from_numpy(a) for a in (rows, vals, dst)),
        torch.tensor(vs, dtype=torch.int32),
        torch.tensor(es[:-1], dtype=torch.int32), torch.from_numpy(iw),
        torch.from_numpy(dang), torch.from_numpy(p0), 0.85, tol, 10_000)
    jp, js = jasync.pr_async(jg, tol=tol, n_blocks=len(vs) - 1)
    assert s1 == ps == js
    np.testing.assert_allclose(p1, pp.numpy(), rtol=1e-5, atol=0)
    np.testing.assert_allclose(p1, np.asarray(jp), rtol=1e-5, atol=0)


@pytest.mark.parametrize("max_sweeps", [0, 1])
def test_pagerank_schedule_model_sweep_cap(max_sweeps):
    _, tg, _ = _pair("rmat10")
    rows, vals, dst, vs, es, iw, dang, p0 = _pr_inputs(tg, 16)
    p, s = model_sweep_pr(rows, vals, dst, vs, es, iw, dang, p0, 0.85, 1e-7,
                          max_sweeps, 4, 3, 2, seed=0)
    pp, ps = kernels.gs_sweep_pr_plain(
        *(torch.from_numpy(a) for a in (rows, vals, dst)),
        torch.tensor(vs, dtype=torch.int32),
        torch.tensor(es[:-1], dtype=torch.int32), torch.from_numpy(iw),
        torch.from_numpy(dang), torch.from_numpy(p0), 0.85, 1e-7, max_sweeps)
    assert s == ps == max_sweeps
    np.testing.assert_allclose(p, pp.numpy(), rtol=1e-5, atol=0)


def test_schedule_models_cover_the_shapes():
    """The models' cases hold what the kernels can get wrong: runs that
    cross tiles, a hub over more tiles than the model's grid has warps, a
    block that every turnaround repeats (2 blocks), edgeless blocks, and a
    block plan clamped to V."""
    _, tg, _ = _pair("rmat10")
    rows, vals, dst, vs, es = _plan_np(tg, 2)
    assert len(vs) - 1 == 2
    hub = np.bincount(dst).max()
    assert hub // 4 > 3 * 2  # tiles of 4 against a grid of 3 x 2 warps
    _, og, _ = _pair("odd")
    _, _, _, ovs, oes = _plan_np(og, 1000)
    assert len(ovs) - 1 == og.n_vertices < 1000
    assert any(oes[b + 1] == oes[b] for b in range(len(ovs) - 1))
    t_of, _, _ = _tiles(es[0], es[1], 4)
    d = dst[es[0]:es[1]]
    assert np.any((d[1:] == d[:-1]) & (t_of[1:] != t_of[:-1]))


def _small_async_cases(monkeypatch):
    """``probes/async_cases``' seven cases on an R-MAT 8 graph and a
    512-point mesh (the module's constants cut down)."""
    from gunrock_tpu_torch.probes import async_cases as ac

    monkeypatch.setattr(ac, "MESH_POINTS", 512)
    graph = tgen.rmat_graph(8, 16, seed=1, device="cpu")
    mesh, rcm = ac.mesh_graphs("cpu")
    return ac, graph, mesh, ac.kernel_cases(graph, mesh, rcm)


def test_async_cases_build_the_entry_points_inputs(monkeypatch):
    """The probe's and chip_smoke.py's kernel calls are the async entry
    points' own: the same distances (bit for bit, RCM mapped back), sweeps
    and passes, the same ranks; and the bound counts 12 B an edge and 8 B
    a vertex of each block pass."""
    ac, graph, mesh, cases = _small_async_cases(monkeypatch)
    assert list(cases) == ["rmat18_sssp", "rmat18_bfs", "rmat18_pr_1e-7",
                           "rmat18_pr_1e-9", "mesh18_sssp_natural",
                           "mesh18_sssp_rcm", "mesh18_bfs_rcm"]
    top, mtop = ac.top_vertex(graph), ac.top_vertex(mesh)
    want = {
        "rmat18_sssp": tasync.sssp_async(graph, top),
        "rmat18_bfs": tasync._run(graph, top, 32, None, True, "natural"),
        "rmat18_pr_1e-7": tasync.pr_async(graph, tol=1e-7),
        "rmat18_pr_1e-9": tasync.pr_async(graph, tol=1e-9),
        "mesh18_sssp_natural": tasync.sssp_async(mesh, mtop),
        "mesh18_sssp_rcm": tasync.sssp_async(mesh, mtop, ordering="rcm"),
        "mesh18_bfs_rcm": tasync._run(mesh, mtop, 32, None, True, "rcm"),
    }
    rank = torch.from_numpy(tasync._rcm(mesh)[2].rank).long()
    for name, (g, kernel, args) in cases.items():
        got = getattr(kernels, kernel)(*args)
        if name.endswith("rcm"):
            got = (got[0][rank],) + tuple(got[1:])
        assert torch.equal(got[0], want[name][0]), name
        assert tuple(got[1:]) == tuple(want[name][1:]), name
    n_bytes, n_ops = ac.bound_work(graph, 10, 2)
    assert n_bytes == 10 * (graph.n_edges / 32 * 12 + graph.n_vertices / 32 * 8)
    assert n_ops == 10 * graph.n_edges / 32 * 2


def test_pull_probe_async_lines(monkeypatch, capsys):
    """``probes/pull.py --async`` on the CPU: one line per case, sweeps and
    passes as the plain loops count them (PageRank: sweeps x blocks), a
    time a pass, no device time off the card."""
    import json

    from gunrock_tpu_torch.probes import pull

    ac, _, _, _ = _small_async_cases(monkeypatch)
    assert pull.main(["--scale", "8", "--device", "cpu", "--num_runs", "1",
                      "--async"]) == 0
    rows = {r["case"]: r for r in map(json.loads,
                                      capsys.readouterr().out.splitlines())}
    assert len(rows) == 7
    pr = rows["async_rmat18_pr_1e-9"]
    assert pr["block_passes"] == pr["sweeps"] * ac.ASYNC_BLOCKS
    for row in rows.values():
        assert row["block_passes"] >= row["sweeps"] > 0
        assert row["us_per_pass"] == row["ms"] * 1e3 / row["block_passes"]
        assert row["device_ms"] == "not measured"
        assert "grid_barriers" not in row  # counted on the card only
