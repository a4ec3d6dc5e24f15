"""The one-launch chunk plan (B2, ``csrc/chunkplan.cu``), the span kernels
of the Weiszfeld step (B9, ``csrc/geo_step.cu``) and geolocation's fixed
summation order, modelled in numpy on the CPU, where no CUDA kernel runs.

- B2: the words packed per window without atomics (each thread ORs the
  sub-block bits of the vertices it reads, a warp ORs its lanes', the
  block its warps'), the chunk test, and the queue written in ascending
  order from per-block counts and block scans; ``active=None`` (every
  source active). Held exactly against ``chunk_activity_plain`` and the
  JAX chunk plan in interpret mode.
- B9: the run pass sums each tile's runs of one row by the kernel's
  segmented warp scan (a fixed tree), runs crossing warps completed from
  the warp tails, and leaves the sums at each run's last slot; the row
  pass adds each row's runs in chunk order (``run_table``) with 1, 4 or 32
  lanes and a fixed shuffle tree. Held against the plain versions and the
  JAX kernels in interpret mode at the tolerance of
  ``test_torch_kernels.py``'s Weiszfeld tests, and bit for bit against
  itself with the chunks taken in a shuffled order, on push layouts and
  on edges out of CSR order; and the run table itself.
- The run property of push layouts (both packages): each row's slots form
  one contiguous run within a chunk, so a run is a (row, chunk) pair.
- geo's per-vertex sums (``torch.segment_reduce`` over the CSR ranges)
  against JAX's ``segment_sum``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrock_tpu.algorithms import geo as jgeo
from gunrock_tpu.io.generators import rmat_graph as j_rmat_graph
from gunrock_tpu.ops.pallas.geo_step import (
    weiszfeld_step_sums as j_wstep,
)
from gunrock_tpu.ops.pallas.geo_step import (
    weiszfeld_step_sums_sparse as j_wstep_sparse,
)
from gunrock_tpu.ops.pallas.layout import build_bucketed_layout as j_build_layout
from gunrock_tpu.ops.pallas.semiring import _sparse_chunk_select
from gunrock_tpu.ops.pallas.semiring import push_layout as j_push_layout

from gunrock_tpu_torch.algorithms import geo
from gunrock_tpu_torch.graph import Graph, GraphProperties
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.ops.kernels import geo_step
from gunrock_tpu_torch.ops.kernels.chunkplan import (
    chunk_activity,
    chunk_activity_plain,
)
from gunrock_tpu_torch.ops.kernels.layout import (
    DATA_FIELDS,
    META_FIELDS,
    BucketedEdges,
    push_layout,
)

W = 128
THREADS = 256  # gr::kThreads
REDUCE_WARPS = 16  # gr::kReduceWarps


def carry(jl) -> BucketedEdges:
    """The JAX layout as the port's, array for array."""
    return BucketedEdges.from_arrays(
        {k: np.asarray(getattr(jl, k)) for k in DATA_FIELDS},
        **{k: getattr(jl, k) for k in META_FIELDS}, device="cpu")


def skewed_edges(seed, V, n_edges, csr=True):
    """Edges whose low ids are hubs, as a degree-sorted graph's are; in CSR
    order (sorted by source, then destination) unless ``csr`` is False."""
    rng = np.random.default_rng(seed)
    rows = (V * rng.random(n_edges) ** 3).astype(np.int32)
    cols = rng.integers(0, V, n_edges).astype(np.int32)
    if csr:
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
    return rows, cols


def layouts(V, C, seed=2, n_edges=12_000, csr=True):
    """(JAX layout, port layout) of one skewed edge set at W=128."""
    rows, cols = skewed_edges(seed, V, n_edges, csr)
    jl = j_build_layout(rows, cols, np.ones(rows.size, np.float32), V,
                        window=W, chunk=C)
    return jl, carry(jl)


# -- B2: the one-launch chunk plan ------------------------------------------

def model_words(mask, V, n_blocks):
    """The kernel's packed words: a block per window, thread t reading the
    window's vertices t, t + 256, ...; a warp ORs its 32 threads' bits and
    thread 0 the 8 warps'. No word is accumulated across blocks."""
    sub = W // 32
    words = np.zeros(n_blocks, np.uint32)
    for w in range(n_blocks):
        lanes = np.zeros(THREADS, np.uint32)
        for i in range(W):
            v = w * W + i
            if v < V and mask[v]:
                lanes[i % THREADS] |= np.uint32(1 << (i // sub))
        warps = np.bitwise_or.reduce(lanes.reshape(-1, 32), axis=1)
        words[w] = np.bitwise_or.reduce(warps)
    return words


def model_plan(tl, active, out_mask, grid):
    """(ch_act, queue[:count]) as the cooperative kernel makes them with
    ``grid`` blocks: each block tests its contiguous range of chunks and
    writes its active ids at the sum of the counts of the blocks before
    it, a tile of 256 at a time in ascending order."""
    n, V = tl.n_chunks, tl.n_vertices
    sb = tl.src_bits.numpy().view(np.uint32)
    db = tl.dst_bits.numpy().view(np.uint32)
    cb, rb = tl.chunk_cb.numpy(), tl.chunk_rb.numpy()
    if active is None:
        act = sb != 0
    else:
        act = (model_words(active, V, tl.n_col_blocks)[cb] & sb) != 0
    if out_mask is not None:
        act &= (model_words(out_mask, V, tl.n_row_blocks)[rb] & db) != 0
    per = -(-n // grid)
    counts = [int(act[b * per:min(n, (b + 1) * per)].sum()) for b in range(grid)]
    queue = np.full(n, -1, np.int64)
    for b in range(grid):
        base = sum(counts[:b])
        lo, hi = min(n, b * per), min(n, (b + 1) * per)
        for t0 in range(lo, hi, THREADS):
            tile = np.flatnonzero(act[t0:min(hi, t0 + THREADS)]) + t0
            queue[base:base + tile.size] = tile
            base += tile.size
    return act, queue[:sum(counts)]


FRONTS = ("full", "tenth", "empty", "none")


def front(kind, V, seed):
    rng = np.random.default_rng(seed)
    if kind == "none":
        return None
    return {"full": np.ones(V, bool), "tenth": rng.random(V) < 0.1,
            "empty": np.zeros(V, bool)}[kind]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", FRONTS)
@pytest.mark.parametrize("V,C", [(1000, 125), (2900, 256)])
def test_plan_model_matches_plain_and_jax(V, C, kind, masked):
    """The model of the one-launch plan against the plain version and the
    JAX chunk plan, exactly: the mask, and the queue element for element.
    V is no multiple of W (the last window runs past V)."""
    jl, tl = layouts(V, C)
    active = front(kind, V, 3)
    om = np.random.default_rng(4).random(V) < 0.5 if masked else None
    act, queue = model_plan(tl, active, om, grid=132)
    ch, q, count = chunk_activity_plain(
        tl, None if active is None else torch.from_numpy(active),
        None if om is None else torch.from_numpy(om))
    np.testing.assert_array_equal(act, ch.numpy())
    assert int(count[0]) == queue.size
    np.testing.assert_array_equal(q[:queue.size].numpy(), queue)
    want = _sparse_chunk_select(
        jl, jnp.asarray(np.ones(V, bool) if active is None else active),
        None if om is None else jnp.asarray(om))[0]
    np.testing.assert_array_equal(act, np.asarray(want))
    if kind == "empty":
        assert queue.size == 0
    if kind in ("full", "none") and not masked:
        np.testing.assert_array_equal(queue, np.arange(tl.n_chunks))


@pytest.mark.parametrize("grid", [1, 3, 7, 132])
def test_plan_queue_does_not_depend_on_the_grid(grid):
    """Any grid writes the same ascending queue: a block's ids go after the
    ids of every block before it."""
    _, tl = layouts(2900, 125)
    active = front("tenth", 2900, 5)
    om = np.random.default_rng(6).random(2900) < 0.3
    act, queue = model_plan(tl, active, om, grid)
    np.testing.assert_array_equal(queue, np.flatnonzero(act))


@pytest.mark.parametrize("masked", [False, True])
def test_plan_edgeless(masked):
    e = np.zeros(0, np.int32)
    tl = carry(j_build_layout(e, e, e.astype(np.float32), 50, window=W,
                              chunk=W))
    active = torch.ones(50, dtype=torch.bool)
    ch, q, count = chunk_activity(tl, active, active if masked else None)
    assert ch.numel() == 0 and q.numel() == 0 and int(count[0]) == 0
    act, queue = model_plan(tl, active.numpy(), None, grid=4)
    assert act.size == 0 and queue.size == 0


@pytest.mark.parametrize("kind", FRONTS)
def test_plan_without_queue(kind):
    """What the span passes ask for: the same mask, no queue."""
    _, tl = layouts(1000, 256)
    a = front(kind, 1000, 7)
    active = None if a is None else torch.from_numpy(a)
    om = torch.from_numpy(np.random.default_rng(8).random(1000) < 0.5)
    ch, q, n = chunk_activity(tl, active, om, queue=False)
    assert q is None and n is None
    assert torch.equal(ch, chunk_activity(tl, active, om)[0])


# -- B9: the run pass and the row pass ---------------------------------------

def wstep_case(seed, V, C, share=0.4, csr=True):
    """(JAX layout, port layout, (y_lat, y_lon, mlat3, mlon3, ok3) as numpy)
    over the push layout of skewed edges, slot tables as geo_kernel builds
    them."""
    rng = np.random.default_rng(seed)
    jl, tl = layouts(V, C, seed, csr=csr)
    lat = rng.uniform(-60, 60, V).astype(np.float32)
    lon = rng.uniform(-180, 180, V).astype(np.float32)
    labeled = rng.random(V) < share
    real = np.asarray(jl.row_local) != W
    dst = np.where(real, np.repeat(np.asarray(jl.chunk_cb), C) * W
                   + np.asarray(jl.col_local), 0)
    ok = real & labeled[dst]
    mlat3 = np.where(ok, lat[dst], 0).astype(np.float32)
    mlon3 = np.where(ok, lon[dst], 0).astype(np.float32)
    y_lat = rng.uniform(-60, 60, V).astype(np.float32)
    y_lon = rng.uniform(-180, 180, V).astype(np.float32)
    return jl, tl, (y_lat, y_lon, mlat3, mlon3, ok.astype(np.float32))


def slot_terms(tl, arrays):
    """f32[4, n_slots]: each slot's (count, 1/d, lat/d, lon/d), 0 where it
    does not count, by the plain version's haversine; and each slot's key
    (window row, -1 on padding)."""
    y_lat, y_lon, mlat3, mlon3, ok3 = (torch.from_numpy(a) for a in arrays)
    C = tl.chunk
    row_local = tl.row_local.numpy()
    key = np.where(row_local == W, -1, row_local)
    rows = np.minimum(np.repeat(tl.chunk_rb.numpy().astype(np.int64), C) * W
                      + row_local, tl.n_vertices - 1)  # padding: any row
    r = torch.from_numpy(rows)
    d = geo_step.haversine(mlat3, mlon3, y_lat[r], y_lon[r])
    counts = (ok3 > 0) & (d != 0) & torch.from_numpy(key >= 0)
    dinv = torch.where(counts, 1.0 / torch.clamp(d, min=1e-30), 0.0)
    terms = torch.stack([counts.float(), dinv, dinv * mlat3, dinv * mlon3])
    return terms.numpy().astype(np.float32), key


def run_tile(key, v):
    """One tile's runs, as run_tile in csrc/geo_step.cu: per warp a
    segmented Hillis-Steele scan (the value from lane - off is added iff no
    run starts in (lane - off, lane]), then each run's last slot completes
    its sums from the warp tails before it, nearest first. Returns {tile
    position of a run's last slot: its sums}."""
    v = v.copy()  # [4, 256]
    tails = []
    for w in range(THREADS // 32):
        k = key[32 * w:32 * w + 32]
        x = v[:, 32 * w:32 * w + 32]
        heads = np.ones(32, bool)
        heads[1:] = k[1:] != k[:-1]
        if not heads.all():
            for off in (1, 2, 4, 8, 16):
                up = np.zeros_like(x)
                up[:, off:] = x[:, :-off]
                same = np.array([
                    l >= off and not heads[l - off + 1:l + 1].any()
                    for l in range(32)])
                x = np.where(same, x + up, x)
        v[:, 32 * w:32 * w + 32] = x
        tails.append((k[31], x[:, 31].copy(), not heads[1:].any(), heads))
    runs = {}
    for i in range(THREADS):
        w, l = divmod(i, 32)
        k = key[i]
        after = key[i + 1] if i + 1 < THREADS else -1
        if k < 0 or after == k:
            continue
        s = v[:, i].copy()
        if not tails[w][3][1:l + 1].any():  # the run starts at lane 0
            for w2 in range(w - 1, -1, -1):
                if tails[w2][0] != k:
                    break
                s = s + tails[w2][1]
                if not tails[w2][2]:
                    break
        runs[i] = s
    return runs


def model_wstep(tl, arrays, ch_act=None, order=None):
    """out f32[4, n_vertices] as the run pass and the row pass make it; the
    run pass takes the chunks in ``order`` (a permutation), as blocks in
    any order do."""
    terms, key = slot_terms(tl, arrays)
    C, V = tl.chunk, tl.n_vertices
    run_sums = np.full((4, tl.n_chunks * C), np.nan, np.float32)
    for ch in (range(tl.n_chunks) if order is None else order):
        if ch_act is not None and not ch_act[ch]:
            continue
        for t0 in range(0, C, THREADS):
            k = np.full(THREADS, -1)
            v = np.zeros((4, THREADS), np.float32)
            n = min(THREADS, C - t0)
            k[:n] = key[ch * C + t0:ch * C + t0 + n]
            v[:, :n] = terms[:, ch * C + t0:ch * C + t0 + n]
            for i, sums in run_tile(k, v).items():
                run_sums[:, ch * C + t0 + i] = sums
    table = geo_step.run_table(tl)
    tail_slot = table.tail_slot.numpy()
    start = table.run_start.numpy()
    out = np.full((4, V), np.nan, np.float32)
    for p, r in enumerate(table.group_rows.numpy()):
        g = (1 if p < table.rows1 else 4 if p < table.rows1 + table.rows4
             else 32)
        out[:, r] = row_sum(tail_slot[start[p]:start[p + 1]], g, run_sums,
                            ch_act, C)
    assert not np.isnan(out).any()  # every row written
    return out


def row_sum(tails, g, run_sums, ch_act, C):
    """One row of the row pass: lane i % g adds run i, in order, then the
    shuffle tree (lane i takes lane i + off's) leaves the sum in lane 0."""
    lanes = [np.zeros(4, np.float32) for _ in range(g)]
    for i, s in enumerate(tails):
        if ch_act is None or ch_act[s // C]:
            lanes[i % g] = lanes[i % g] + run_sums[:, s]
    off = g // 2
    while off:
        lanes = [lanes[i] + lanes[i + off] if i + off < g else lanes[i]
                 for i in range(g)]
        off //= 2
    return lanes[0]


def assert_wstep_close(got, want):
    """test_torch_kernels.py's Weiszfeld tolerance: counts equal, the sums
    within rtol 1e-4 beside 1e-4 of the row's sum of 1/d times the
    coordinate's magnitude."""
    want = [np.asarray(w) for w in want]
    np.testing.assert_array_equal(got[0], want[0])
    assert (want[0] > 0).any()
    for k, scale in ((1, 1.0), (2, 60.0), (3, 180.0)):
        np.testing.assert_allclose(
            got[k], want[k], rtol=1e-4,
            atol=float(1e-4 * scale * want[1].max()) + 1e-12, err_msg=str(k))


@pytest.mark.parametrize("csr", [True, False])
@pytest.mark.parametrize("V,C", [(1000, 125), (2900, 256), (2900, 512)])
def test_wstep_run_model_matches_plain(V, C, csr):
    """The model of both passes against the plain version, on push layouts
    and on edges out of CSR order (several runs of a row in one chunk);
    C=512 cuts a chunk into two tiles."""
    _, tl, arrays = wstep_case(11, V, C, csr=csr)
    got = model_wstep(tl, arrays)
    want = geo_step.weiszfeld_step_sums_plain(
        tl, *(torch.from_numpy(a) for a in arrays))
    assert_wstep_close(got, [w.numpy() for w in want])


@pytest.mark.parametrize("share", [1.0, 0.1, 0.0])
def test_wstep_sparse_run_model_matches_plain(share):
    _, tl, arrays = wstep_case(12, 2900, 256)
    undone = np.random.default_rng(13).random(2900) < share
    ch_act = chunk_activity_plain(tl, None, torch.from_numpy(undone),
                                  queue=False)[0].numpy()
    got = model_wstep(tl, arrays, ch_act)
    want = geo_step.weiszfeld_step_sums_sparse_plain(
        tl, *(torch.from_numpy(a) for a in arrays), torch.from_numpy(undone))
    if share == 0.0:
        assert not got.any() and all(not w.any() for w in want)
        return
    assert_wstep_close(got, [w.numpy() for w in want])


@pytest.mark.parametrize("sparse", [False, True])
def test_wstep_run_model_matches_jax(sparse):
    """The model against the JAX kernels in interpret mode (their arcsin a
    polynomial, their sums rebuilt from a bf16 hi+lo split)."""
    jl, tl, arrays = wstep_case(14, 1000, 128)
    shape = (jl.n_chunks, 1, 128)
    jargs = [jnp.asarray(a if a.size == 1000 else a.reshape(shape))
             for a in arrays]
    if sparse:
        undone = np.random.default_rng(15).random(1000) < 0.3
        want = j_wstep_sparse(jl, *jargs, jnp.asarray(undone), interpret=True)
        ch_act = chunk_activity_plain(tl, None, torch.from_numpy(undone),
                                      queue=False)[0].numpy()
        got = model_wstep(tl, arrays, ch_act)
        # the JAX pass leaves the rows of inactive chunks undefined; the
        # port's are 0
        rows = np.zeros(1000, bool)
        for ch in np.flatnonzero(ch_act):
            rl = tl.row_local.numpy()[ch * 128:(ch + 1) * 128]
            rows[tl.chunk_rb.numpy()[ch] * W + rl[rl != W]] = True
        got, want = got[:, rows], [np.asarray(w)[rows] for w in want]
    else:
        want = j_wstep(jl, *jargs, interpret=True)
        got = model_wstep(tl, arrays)
    assert_wstep_close(got, want)


@pytest.mark.parametrize("csr", [True, False])
@pytest.mark.parametrize("sparse", [False, True])
def test_wstep_run_model_is_bit_equal_in_any_chunk_order(sparse, csr):
    """The run pass's blocks take the chunks in any order; the sums do not
    depend on it, with or without the run property."""
    _, tl, arrays = wstep_case(21, 2900, 256, share=0.6, csr=csr)
    ch_act = None
    if sparse:
        undone = np.random.default_rng(22).random(2900) < 0.2
        ch_act = chunk_activity_plain(tl, None, torch.from_numpy(undone),
                                      queue=False)[0].numpy()
    first = model_wstep(tl, arrays, ch_act)
    order = np.random.default_rng(23).permutation(tl.n_chunks)
    np.testing.assert_array_equal(first, model_wstep(tl, arrays, ch_act,
                                                     order))


@pytest.mark.parametrize("C", [125, 256, 512])
def test_run_table(C):
    """The run table: every real slot in exactly one run, each run's last
    slot listed once under its row in slot order, the row groups a
    partition of the rows by their number of runs."""
    _, tl = layouts(2900, C, csr=False)
    table = geo_step.run_table(tl)
    assert geo_step.run_table(tl) is table  # cached
    rl = tl.row_local.numpy()
    real = rl != W
    tails = table.tail_slot.numpy()
    start = table.run_start.numpy()
    group = table.group_rows.numpy()
    rows = np.repeat(tl.chunk_rb.numpy(), C) * W + rl
    assert (np.diff(start) >= 0).all() and start[-1] == tails.size
    for p, r in enumerate(group):
        mine = tails[start[p]:start[p + 1]]
        assert (np.diff(mine) > 0).all() and (rows[mine] == r).all()
    # a run is cut by a change of row, padding, a tile's or a chunk's end
    pos = np.arange(rl.size) % C
    nxt = np.append(rl[1:], W)
    cut = real & ((nxt != rl) | (pos % THREADS == THREADS - 1) | (pos == C - 1))
    np.testing.assert_array_equal(np.sort(tails), np.flatnonzero(cut))
    # the groups: every row once, by its number of runs
    counts = np.diff(start)  # in group order
    n1, n4 = table.rows1, table.rows4
    assert np.array_equal(np.sort(group), np.arange(2900))
    assert (counts[:n1] <= 4).all()
    assert ((counts[n1:n1 + n4] > 4) & (counts[n1:n1 + n4] <= 32)).all()
    assert (counts[n1 + n4:] > 32).all() and n1 + n4 < 2900


# -- the run property of push layouts ------------------------------------------

def one_run_per_row(layout):
    """True iff within every chunk each row's real slots are one contiguous
    run, ascending (what B9's fixed order needs)."""
    rl = np.asarray(layout.row_local).reshape(-1, layout.chunk)
    for chunk in rl:
        real = chunk[chunk != layout.window]
        if real.size and (np.diff(real) < 0).any():
            return False
        if (chunk[:real.size] != real).any():  # padding only at the tail
            return False
    return True


@pytest.fixture(scope="module")
def rmat():
    jg = j_rmat_graph(scale=9, edge_factor=12, seed=3, undirected=False)
    tg = Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")
    return jg, tg


@pytest.mark.parametrize("window,chunk", [(128, 128), (128, 125), (2048, 256)])
def test_push_layouts_keep_one_run_per_row(rmat, window, chunk):
    jg, tg = rmat
    jl = j_push_layout(jg, window=window, chunk=chunk, unit=True,
                       interpret=True)
    tl = push_layout(tg, window=window, chunk=chunk, unit=True)
    assert one_run_per_row(jl) and one_run_per_row(tl)
    np.testing.assert_array_equal(np.asarray(jl.row_local),
                                  tl.row_local.numpy())


def test_unsorted_edges_break_the_run_property():
    _, tl = layouts(1000, 256, csr=False)
    assert not one_run_per_row(tl)


# -- geo's per-vertex sums ---------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_seg_sum_matches_jax_segment_sum(rmat, seed):
    """Per-vertex sums over the CSR ranges, against JAX's segment_sum by
    source (what the JAX geo_kernel takes), on coordinates and on 1/d-like
    terms; vertices without out-edges get 0."""
    jg, tg = rmat
    E, V = tg.n_edges, tg.n_vertices
    rng = np.random.default_rng(seed)
    vals = [rng.uniform(-180, 180, E).astype(np.float32),
            (1.0 / rng.uniform(1e-3, 2e4, E)).astype(np.float32),
            (rng.random(E) < 0.5).astype(np.float32)]
    got = geo._seg_sum(tg.row_offsets.long(), *(torch.from_numpy(v)
                                                for v in vals))
    src = jnp.asarray(np.asarray(jg.edge_src))
    assert (np.diff(np.asarray(jg.row_offsets)) == 0).any()
    for g, v in zip(got, vals):
        want = np.asarray(jgeo._seg_sum(jnp.asarray(v), src, V))
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-3)
        exact = np.zeros(V)
        np.add.at(exact, np.asarray(jg.edge_src), v.astype(np.float64))
        np.testing.assert_allclose(g.numpy(), exact, rtol=1e-5, atol=1e-3)


def test_seg_sum_is_bit_equal_across_calls():
    _, tg = rmat_graph_small()
    v = torch.from_numpy(np.random.default_rng(3).uniform(
        -180, 180, tg.n_edges).astype(np.float32))
    a = geo._seg_sum(tg.row_offsets.long(), v)[0]
    b = geo._seg_sum(tg.row_offsets.long(), v.clone())[0]
    assert torch.equal(a, b)


def rmat_graph_small():
    jg = j_rmat_graph(scale=7, edge_factor=8, seed=4, undirected=True)
    return jg, Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")



def test_pull_probe_b2_b9_and_geo_lines(capsys):
    """The pull probe on the CPU: B2's and B9's cases, and the --geo line
    with one entry per chunk-skipping step of the recorded run, no device
    time off the card."""
    import json

    from gunrock_tpu_torch.probes import pull

    assert pull.main(["--scale", "8", "--device", "cpu", "--num_runs", "1",
                      "--b2_b9", "--geo"]) == 0
    rows = {r["case"]: r for r in map(json.loads,
                                      capsys.readouterr().out.splitlines())}
    for layout in ("unit", "luby"):
        for kind in ("full", "tenth", "hundredth", "empty"):
            for tag in ("", "_nomask"):
                assert f"b2_{layout}_{kind}{tag}" in rows
    assert rows["b2_unit_empty"]["active_chunks"] == 0
    assert rows["b2_luby_full_nomask"]["active_chunks"] == \
        rows["b2_luby_full_nomask"]["n_chunks"]
    for case in ("b9_dense", "b9_sparse_full", "b9_sparse_tenth",
                 "b9_sparse_none"):
        assert rows[case]["device_ms"] == "not measured"
    assert rows["b9_sparse_none"]["active_chunks"] == 0
    line = rows["geo_passes"]
    assert len(line["active_chunks"]) == sum(line["steps"]) > 0
    assert 0 < max(line["active_chunks"]) <= line["n_chunks"]
    assert line["device_ms_total"] == "not measured"
