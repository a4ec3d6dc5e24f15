"""The edge-balanced SSSP push step (``csrc/sssp_push.cu``) and the span
kernels of the Boruvka min-cut pass (B7, ``csrc/mst_min.cu``), modelled
in numpy on the CPU, where no CUDA kernel runs.

- The push step: one cooperative launch. Phase 1 counts each block's
  queued vertices (frontier, out-degree above 0) and their out-edges over
  its vertex range; phase 2 writes the queue and the exclusive scan of
  the out-degrees (``first``) at the blocks' bases, a tile of 256 at a
  time; phase 3 gives thread t of the grid the edge ids t, t + T, ...
  and finds each one's queue entry by a binary search in ``first`` that
  starts from the thread's last entry. The model holds the partition
  (every out-edge of the frontier exactly once, none else) for an empty
  queue, a single hub, vertices of degree 0, totals below, equal to and
  far above the grid's thread count, and several grids; its relaxation
  (candidates from the old distances, a candidate below old[u] marking u
  improved) against the plain version and the JAX ``sssp_push_step``
  over every frontier of a search, a single hub and the full frontier.
- B7: one block per span reduces its cut edges' ranks into a window
  filled with NO_CUT (the row block's roots in shared memory, one root
  gathered a slot, padding skipped first), writes the window only where
  it sent a rank, and a combine pass takes each row block's touched
  windows' min into y, written whole. The model against the plain
  version and the JAX ``bucketed_min_rank_cut`` in interpret mode on
  small R-MAT graphs, with V, V/8 and 1 roots, an empty row window and
  an edgeless layout, at P = 1 and P = 32.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrock_tpu.algorithms import mst as jmst
from gunrock_tpu.algorithms import sssp as jsssp
from gunrock_tpu.graph.reorder import degree_sort as j_degree_sort
from gunrock_tpu.io.generators import rmat_graph as j_rmat_graph
from gunrock_tpu.ops.pallas.layout import build_bucketed_layout as j_build_layout
from gunrock_tpu.ops.pallas.mst_min import bucketed_min_rank_cut as j_min_rank_cut
from gunrock_tpu.ops.pallas.semiring import _BIG

from gunrock_tpu_torch.algorithms import mst, sssp
from gunrock_tpu_torch.graph import Graph, GraphProperties
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.ops.kernels.layout import DATA_FIELDS, META_FIELDS, BucketedEdges
from gunrock_tpu_torch.ops.kernels.mst_min import (
    NO_CUT,
    bucketed_min_rank_cut,
    bucketed_min_rank_cut_plain,
)
from gunrock_tpu_torch.probes.pull import record_calls

THREADS = 256  # gr::kThreads
LANE_VECS = 4  # gr::kLaneVecs


def port_graph(jg) -> Graph:
    return Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")


# -- the push step's edge-balanced expansion ---------------------------------

def model_expand(front, offsets, grid):
    """(queue, first, edge_q) as push_step makes them with ``grid`` blocks
    of 256 threads: edge_q[i] is the queue entry thread i % T's binary
    search gives edge id i (T = grid * 256)."""
    V = front.size
    deg = np.where(front, np.diff(offsets), 0).astype(np.int64)
    per = -(-V // grid)
    ranges = [(min(V, b * per), min(V, b * per + per)) for b in range(grid)]
    # phase 1: each block's queued vertices and out-edges
    counts = [((deg[lo:hi] > 0).sum(), deg[lo:hi].sum()) for lo, hi in ranges]
    n_q = int(sum(c[0] for c in counts))
    n_e = int(sum(c[1] for c in counts))
    # phase 2: the queue and the scan at the blocks' bases, tile by tile
    queue = np.full(V, -1, np.int64)
    first = np.full(V, -1, np.int64)
    for b, (lo, hi) in enumerate(ranges):
        bq = sum(c[0] for c in counts[:b])
        be = sum(c[1] for c in counts[:b])
        for t0 in range(lo, hi, THREADS):
            d = deg[t0:min(hi, t0 + THREADS)]
            keep = d > 0
            at_q = np.cumsum(keep) - keep
            at_e = np.cumsum(d) - d
            idx = np.flatnonzero(keep)
            queue[bq + at_q[idx]] = t0 + idx
            first[bq + at_q[idx]] = be + at_e[idx]
            bq += keep.sum()
            be += d.sum()
    # phase 3: each thread's edge ids, its search starting from its last q
    T = grid * THREADS
    edge_q = np.full(n_e, -1, np.int64)
    q = np.zeros(T, np.int64)
    for k in range(-(-n_e // T)):
        i = np.arange(T) + k * T
        live = i < n_e
        top = np.where(live, n_q, q)
        while True:
            go = top - q > 1
            if not go.any():
                break
            mid = (q + top) // 2
            below = first[np.where(go, mid, 0)] <= i
            q = np.where(go & below, mid, q)
            top = np.where(go & ~below, mid, top)
        edge_q[i[live]] = q[live]
    return queue[:n_q], first[:n_q], edge_q


def expansion(front, offsets, grid):
    """(v, e) of every edge id the model's grid relaxes, checking the
    queue, the scan and the search's invariant on the way."""
    queue, first, edge_q = model_expand(front, offsets, grid)
    deg = np.diff(offsets)
    assert (np.diff(queue) > 0).all() and (deg[queue] > 0).all()
    np.testing.assert_array_equal(first, np.cumsum(deg[queue]) - deg[queue])
    i = np.arange(edge_q.size)
    ends = np.append(first, edge_q.size)
    assert ((first[edge_q] <= i) & (i < ends[edge_q + 1])).all()
    v = queue[edge_q]
    return v, offsets[v] + i - first[edge_q]


def frontier_graph(total, seed=0, hub=False):
    """(front, offsets): random out-degrees with many zeros and a frontier
    with ``total`` out-edges: random vertices, some of degree 0, those of
    nonzero degree dropped past ``total`` and one more vertex taking up the
    rest (``hub``: one vertex holds them all)."""
    rng = np.random.default_rng(seed)
    V = max(700, total // 2)
    deg = np.where(rng.random(V) < 0.3, 0, rng.integers(1, 12, V))
    front = np.zeros(V, bool)
    if hub:
        front[V // 2], deg[V // 2] = True, total
    else:
        front[rng.random(V) < 0.4] = True
        on = rng.permutation(np.flatnonzero(front & (deg > 0)))
        front[on[np.cumsum(deg[on]) > total]] = False
        rest = total - deg[front].sum()
        if rest:
            j = np.flatnonzero(~front)[0]
            front[j], deg[j] = True, rest
    assert (front & (deg == 0)).any() or hub
    offsets = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    assert np.where(front, deg, 0).sum() == total
    return front, offsets


@pytest.mark.parametrize("grid", [1, 3, 7, 132])
@pytest.mark.parametrize("kind", ["empty", "hub", "below", "equal", "above"])
def test_expansion_relaxes_every_out_edge_once(grid, kind):
    T = grid * THREADS
    total = {"empty": 0, "hub": 3 * T + 5, "below": T // 3, "equal": T,
             "above": 9 * T + 17}[kind]
    front, offsets = frontier_graph(total, seed=grid, hub=kind == "hub")
    v, e = expansion(front, offsets, grid)
    src = np.repeat(np.arange(front.size), np.diff(offsets))  # each edge's
    want_e = np.flatnonzero(front[src])  # the frontier's out-edges, sorted
    order = np.argsort(e)
    np.testing.assert_array_equal(e[order], want_e)  # each exactly once
    np.testing.assert_array_equal(v[order], src[want_e])
    assert e.size == total


@pytest.mark.parametrize("grid", [1, 5])
def test_expansion_with_more_blocks_than_vertices(grid):
    """Blocks past the last vertex own empty ranges and count nothing."""
    front = np.array([True, False, True])
    offsets = np.array([0, 4, 4, 9])
    v, e = expansion(front, offsets, grid)
    np.testing.assert_array_equal(np.sort(e), [0, 1, 2, 3, 4, 5, 6, 7, 8])
    assert (v[e < 4] == 0).all() and (v[e >= 4] == 2).all()


def model_push_step(graph, front, dist, grid):
    """(improved, new_dist) as the kernel makes them: candidates from the
    old distances reduced by min into a copy (a float min in any order),
    improved marked where a candidate is below the old distance."""
    offsets = graph.row_offsets.numpy().astype(np.int64)
    old = dist.numpy()
    v, e = expansion(front.numpy(), offsets, grid)
    u = graph.col_indices.numpy()[e]
    cand = old[v] + graph.values.numpy()[e]
    new = old.copy()
    np.minimum.at(new, u, cand)
    improved = np.zeros(old.size, bool)
    improved[u[cand < old[u]]] = True
    np.testing.assert_array_equal(improved, new < old)  # the same contract
    return improved, new


@pytest.fixture(scope="module")
def sssp_graphs():
    """(JAX graph, port graph): R-MAT scale 9, degree-sorted, weights in
    [0.1, 1.1]."""
    jg, _ = j_degree_sort(j_rmat_graph(scale=9, seed=1))
    return jg, port_graph(jg)


def push_cases(tg, src):
    """(what, frontier, distances): every frontier of a search from
    ``src``, the top-degree vertex alone and every vertex at once."""
    dist, front = sssp._start(tg, src)
    cases = []
    while bool(front.any()):
        cases.append((f"step {len(cases)}", front, dist))
        front, dist = sssp.sssp_step(tg, front, dist)
    # a middle state's distances stretched (2d + 1, weights are below 1.1)
    # so that the hub's edges improve its neighbours
    hub = int(torch.argmax(tg.out_degrees()))
    mid = cases[len(cases) // 2][2] * 2.0 + 1.0
    mid[hub] = 0.0
    alone = torch.zeros(tg.n_vertices, dtype=torch.bool)
    alone[hub] = True
    return cases + [("single hub", alone, mid),
                    ("full frontier", torch.ones_like(alone), mid)]


@pytest.mark.parametrize("grid", [1, 4, 132])
def test_push_step_model_matches_plain_and_jax(sssp_graphs, grid):
    jg, tg = sssp_graphs
    cases = push_cases(tg, 0)
    assert len(cases) >= 5
    for what, front, dist in cases:
        imp_m, new_m = model_push_step(tg, front, dist, grid)
        imp_p, new_p = sssp.sssp_push_step_plain(tg, front, dist)
        imp_j, new_j = jsssp.sssp_push_step(
            jg, jnp.asarray(front.numpy()), jnp.asarray(dist.numpy()),
            tg.n_edges)
        for got in ((imp_m, new_m), (imp_p.numpy(), new_p.numpy())):
            np.testing.assert_array_equal(got[0], np.asarray(imp_j), err_msg=what)
            np.testing.assert_array_equal(got[1], np.asarray(new_j), err_msg=what)


@pytest.mark.parametrize("what", ["single hub", "full frontier"])
def test_push_step_matches_jax_on_hub_and_full_frontier(sssp_graphs, what):
    """The port's entry point (the plain version on the CPU) on the two
    frontiers the search does not give."""
    jg, tg = sssp_graphs
    _, front, dist = {c[0]: c for c in push_cases(tg, 0)}[what]
    imp_t, new_t = sssp.sssp_push_step(tg, front, dist, tg.n_edges)
    imp_j, new_j = jsssp.sssp_push_step(
        jg, jnp.asarray(front.numpy()), jnp.asarray(dist.numpy()), tg.n_edges)
    np.testing.assert_array_equal(imp_t.numpy(), np.asarray(imp_j))
    np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))
    assert bool(imp_t.any())


# -- B7: span kernels --------------------------------------------------------

def model_min_cut(tl, ranks, roots):
    """y[:V] as cut_spans and cut_combine make it over ``tl``'s span table:
    a window per span (the shared int atomicMin as np.minimum.at), written
    only when touched, and each row block's touched windows combined by
    min, NO_CUT where none."""
    W, C, V = tl.window, tl.chunk, tl.n_vertices
    sfc, rfs = tl.span_first_chunk.numpy(), tl.rb_first_span.numpy()
    row = tl.row_local.numpy().reshape(-1, C)
    col = tl.col_local.numpy().reshape(-1, C)
    rank = ranks.numpy().reshape(-1, C)
    crb, ccb = tl.chunk_rb.numpy(), tl.chunk_cb.numpy()
    roots = roots.numpy()
    n_spans = sfc.size - 1
    partial = np.full((n_spans, W), -7, np.int64)  # unwritten: never read
    touched = np.zeros(n_spans, bool)
    for s in range(n_spans):
        lo, hi = sfc[s], sfc[s + 1]
        rb = crb[lo]
        assert (crb[lo:hi] == rb).all()  # a span lies in one row block
        g = rb * W + np.arange(W)
        row_roots = np.where(g < V, roots[np.minimum(g, V - 1)], -1)
        r, c, k = row[lo:hi].ravel(), col[lo:hi].ravel(), rank[lo:hi].ravel()
        real = r != W  # padding: no other load
        cb = np.repeat(ccb[lo:hi], C)[real]
        r, c, k = r[real], c[real], k[real]
        cut = roots[cb * W + c] != row_roots[r]
        win = np.full(W, NO_CUT, np.int64)
        np.minimum.at(win, r[cut], k[cut])
        touched[s] = cut.any()
        if touched[s]:
            partial[s] = win
    y = np.full(tl.n_row_blocks * W, NO_CUT, np.int64)
    for rb in range(tl.n_row_blocks):
        for s in range(rfs[rb], rfs[rb + 1]):
            if touched[s]:
                y[rb * W:(rb + 1) * W] = np.minimum(y[rb * W:(rb + 1) * W],
                                                    partial[s])
    return y[:V]


@pytest.mark.parametrize("W", [128, 2048, 4096])
def test_combine_strips_write_every_entry_once(W):
    """cut_combine's blocks (strip, lane, vector k) write entries
    strip*512 + 4*lane + 128*k .. +3 of each row block: each of the W
    entries once."""
    hits = np.zeros(W, np.int64)
    for strip in range(-(-W // (128 * LANE_VECS))):
        for lane in range(32):
            for k in range(LANE_VECS):
                r = strip * 128 * LANE_VECS + 4 * lane + 128 * k
                if r < W:
                    hits[r:r + 4] += 1
    assert (hits == 1).all()


def carry(jl) -> BucketedEdges:
    """The JAX layout as the port's, array for array."""
    return BucketedEdges.from_arrays(
        {k: np.asarray(getattr(jl, k)) for k in DATA_FIELDS},
        **{k: getattr(jl, k) for k in META_FIELDS}, device="cpu")


@functools.lru_cache(maxsize=None)
def cut_layout(kind: str):
    """(JAX layout with f32 ranks, port layout, int32 slot ranks):
    ``rmat`` is the MST layout of the doubled canonical edges of an R-MAT
    scale 8 graph, as both packages build it (W=128); ``empty_row`` R-MAT
    scale 9 edges with random ranks whose row window 1 holds no edge; ``edgeless``
    no edge at all."""
    if kind == "rmat":
        jg = j_rmat_graph(scale=8, edge_factor=8, seed=3, undirected=True)
        jl = jmst._mst_rank_layout(jg, True)
        tl, ranks = mst._mst_rank_layout(port_graph(jg), window=jl.window,
                                         chunk=jl.chunk)
        return jl, tl, ranks
    jg = j_rmat_graph(scale=9, edge_factor=8, seed=5)
    rows = np.asarray(jg.edge_src).astype(np.int32)
    cols = np.asarray(jg.col_indices).astype(np.int32)
    keep = rows // 128 != 1 if kind == "empty_row" else np.zeros(rows.size, bool)
    rows, cols = rows[keep], cols[keep]
    r = np.random.default_rng(6).permutation(rows.size).astype(np.float32)
    jl = j_build_layout(rows, cols, r, jg.n_vertices, window=128, chunk=256,
                        pad_value=_BIG)
    tl = carry(jl)
    ranks = torch.where(tl.row_local == tl.window, NO_CUT,
                        tl.values.to(torch.int64)).to(torch.int32)
    return jl, tl, ranks


def cut_roots(V, kind: str):
    n = {"V": V, "V/8": max(2, V // 8), "1": 1}[kind]
    return np.random.default_rng(V + n).integers(0, n, V).astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_cut(layout: str, roots: str):
    jl = cut_layout(layout)[0]
    got = np.asarray(j_min_rank_cut(
        jl, jnp.asarray(cut_roots(jl.n_vertices, roots), jnp.float32),
        interpret=True))
    return np.where(got >= np.float32(_BIG), NO_CUT, got).astype(np.int64)


@pytest.mark.parametrize("P", [1, 32])
@pytest.mark.parametrize("roots", ["V", "V/8", "1"])
@pytest.mark.parametrize("layout", ["rmat", "empty_row", "edgeless"])
def test_min_cut_span_model_matches_plain_and_jax(layout, roots, P):
    _, tl, ranks = cut_layout(layout)
    V = tl.n_vertices
    r = torch.from_numpy(cut_roots(V, roots))
    if layout == "empty_row":
        assert not (tl.chunk_rb == 1).any() and tl.n_row_blocks > 2
    if layout == "edgeless":
        assert tl.n_chunks == 0 and tl.n_row_blocks > 1
    cut = tl.with_span_chunks(P)
    if P == 1:
        assert cut.n_spans == tl.n_chunks
    got = model_min_cut(cut, ranks, r)
    want = jax_cut(layout, roots)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        bucketed_min_rank_cut_plain(cut, ranks, r).numpy(), want)
    if roots == "1" or layout == "edgeless":
        assert (got == NO_CUT).all()
    else:
        assert (got < NO_CUT).any()


def test_min_cut_span_model_on_real_rounds():
    """The model on the roots the pass gets in each round of one
    ``mst.run`` (the port's, on the CPU), against the plain version."""
    jg = j_rmat_graph(scale=8, edge_factor=8, seed=3, undirected=True)
    tg = port_graph(jg)
    _, seen = record_calls(mst, "bucketed_min_rank_cut", lambda: mst.run(
        tg, warmup=False, device="cpu"))
    assert len(seen) >= 3
    for layout, ranks, roots in seen:
        np.testing.assert_array_equal(
            model_min_cut(layout, ranks, roots),
            bucketed_min_rank_cut_plain(layout, ranks, roots).numpy())


def test_min_cut_edgeless():
    _, tl, ranks = cut_layout("edgeless")
    assert tl.n_chunks == 0 and tl.n_spans == 0
    roots = torch.arange(tl.n_vertices, dtype=torch.int32)
    got = bucketed_min_rank_cut(tl, ranks, roots)
    assert got.shape == (tl.n_vertices,) and (got == NO_CUT).all()


def test_pull_probe_sssp_push_and_mst_lines(capsys):
    """The pull probe on the CPU: the --sssp_push line with one entry per
    push step of the eight searches and the largest step's case, the --mst
    line with one entry per min-cut pass, and no device time off the
    card."""
    import json

    from gunrock_tpu_torch.probes import pull

    assert pull.main(["--scale", "8", "--device", "cpu", "--num_runs", "1",
                      "--sssp_push", "--mst"]) == 0
    rows = {r["case"]: r for r in map(json.loads,
                                      capsys.readouterr().out.splitlines())}
    line = rows["sssp_push_passes"]
    assert line["searches"] == 8 and line["steps"] == len(line["out_edges"]) > 0
    assert line["device_ms_total"] == "not measured"
    assert rows["sssp_push_largest"]["out_edges"] == max(line["out_edges"])
    line = rows["mst_passes"]
    assert line["passes"] == line["rounds"] == len(line["cut_slots"]) >= 2
    assert line["cut_slots"][0] == line["real_slots"]  # round 1: all cut
    assert rows["b7_round1"]["cut_slots"] == line["real_slots"]
    assert rows["b7_round2"]["cut_slots"] == line["cut_slots"][1]
