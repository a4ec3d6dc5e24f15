"""The span kernels of the dense SpMM (B4, ``csrc/spmm.cu``) and the fused
max/min pass (B6, ``csrc/semiring.cu``), modelled in numpy on the CPU,
where no CUDA kernel runs.

- B4's passes: every chunk active; per (span, K tile) a W x Kt window over
  the span's slots that can send other than +-0 (the X-row flags drop
  X's all-zero rows), then the window's nonzero entries added into Y.
- B6's passes: per span two windows, max (identity 0) and min of the
  positive messages (identity _BIG), over the active chunks; then every
  row block's touched windows combined, ymax and ymin written whole.
- The warp fold of B6's span pass (``max_min_runs``): a segmented
  max/min by shuffle over runs of one row on consecutive lanes, which
  coloring's push layout has (``row_runs`` counts them).

Each model is held against the plain version and against the JAX Pallas
function in interpret mode: B6 bit for bit, B4 exactly for small-integer
sums, within rtol 1e-5 of the plain f32 sum (the model sums in float64)
and rtol 1e-4 of the JAX kernel (its bf16 hi+lo split, ROADMAP C).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrock_tpu.ops.pallas.layout import build_bucketed_layout as j_build_layout
from gunrock_tpu.ops.pallas.semiring import (
    bucketed_semiring_spmv_sparse_minmax as j_minmax,
)
from gunrock_tpu.ops.pallas.spmm import bucketed_spmm as j_spmm

from gunrock_tpu_torch.algorithms import color
from gunrock_tpu_torch.formats import Coo
from gunrock_tpu_torch.graph import build_graph
from gunrock_tpu_torch.ops.kernels.chunkplan import chunk_activity_plain
from gunrock_tpu_torch.ops.kernels.layout import (
    DATA_FIELDS,
    META_FIELDS,
    BucketedEdges,
    build_bucketed_layout,
    pull_layout,
)
from gunrock_tpu_torch.ops.kernels.semiring import (
    _BIG,
    bucketed_semiring_spmv_sparse_minmax,
    bucketed_semiring_spmv_sparse_minmax_plain,
)
from gunrock_tpu_torch.ops.kernels.spmm import (
    K_TILE_BYTES,
    bucketed_spmm,
    bucketed_spmm_plain,
    k_tile,
    tile_shape,
    walks,
)
from gunrock_tpu_torch.probes import pull

W = 128
BIG = np.float32(_BIG)


def skewed_graph(seed, V=1000, n_edges=12_000, values="float"):
    """A graph whose low ids are hubs, as a degree-sorted graph's are:
    rows and columns crowd the first windows."""
    rng = np.random.default_rng(seed)
    rows = (V * rng.random(n_edges) ** 3).astype(np.int32)
    cols = rng.integers(0, V, n_edges).astype(np.int32)
    vals = (rng.random(n_edges) + 0.1).astype(np.float32)
    if values == "01":
        vals = (rng.random(n_edges) < 0.5).astype(np.float32)
    elif values == "signed":
        vals *= rng.choice(np.float32([-1, 1]), n_edges)
    return rows, cols, vals


def carry(jl) -> BucketedEdges:
    """The JAX layout as the port's, array for array."""
    return BucketedEdges.from_arrays(
        {k: np.asarray(getattr(jl, k)) for k in DATA_FIELDS},
        **{k: getattr(jl, k) for k in META_FIELDS}, device="cpu")


def b4_layout(case) -> BucketedEdges:
    """Layouts of the dense SpMM's cases: 0/1 values (spans of 3 chunks),
    signed values at C=125 (scalar loads), a row window no chunk reaches,
    padding slots in every chunk's tail (V=1000 past the last window), and
    none."""
    if case == "unit_p3":
        rows, cols, vals = skewed_graph(1, values="01")
        return build_bucketed_layout(rows, cols, vals, 1000, window=W,
                                     chunk=W, device="cpu").with_span_chunks(3)
    if case == "odd_chunk":
        return build_bucketed_layout(*skewed_graph(2, values="signed"), 1000,
                                     window=W, chunk=125, device="cpu")
    if case == "empty_row":
        rows, cols, vals = skewed_graph(3)
        keep = rows // W != 3  # row window 3 gets no chunk
        return build_bucketed_layout(rows[keep], cols[keep], vals[keep], 1000,
                                     window=W, chunk=64, device="cpu")
    if case == "edgeless":
        e = np.zeros(0, np.int32)
        return build_bucketed_layout(e, e, e.astype(np.float32), 50,
                                     window=W, chunk=W, device="cpu")
    raise ValueError(case)


def b6_layout(case) -> BucketedEdges:
    """Luby's layout (symmetrized, loop-free, unit push) of a skewed graph,
    at P = 3 and at C = 125; a valued layout with a row window no chunk
    reaches; none."""
    if case in ("color", "color_p3", "color_odd"):
        rows, cols, vals = skewed_graph(4)
        graph = build_graph(Coo(1000, 1000, rows, cols, vals), device="cpu")
        if case == "color_odd":
            src, dst = color._sym_loopfree_edges(graph)
            return build_bucketed_layout(src, dst,
                                         np.ones(src.size, np.float32), 1000,
                                         window=W, chunk=125, device="cpu")
        layout = color._color_layout(graph, window=W, chunk=W)
        return layout.with_span_chunks(3) if case == "color_p3" else layout
    return b4_layout(case)


# -- B4: the dense pass on the span table -----------------------------------

def can_send(v, nonzero_row, nonfinite_row):
    """The kernel's skip test: a slot sends only if its messages can be
    other than +-0."""
    return ((nonzero_row | ~np.isfinite(v))
            & ((v != 0) | nonfinite_row))


def spmm_dense_model(layout: BucketedEdges, x, kt):
    """Y in float64 by B4's passes: per (span, K tile) a W x kt window over
    every chunk of the span, the slots can_send keeps, then the window's
    nonzero entries added into Y."""
    Wl, C = layout.window, layout.chunk
    V, K = x.shape
    nonzero_row = (x != 0).any(axis=1)
    nonfinite_row = ~np.isfinite(x).all(axis=1)
    row = layout.row_local.numpy()
    col = layout.col_local.numpy()
    val = layout.values.numpy()
    rb = layout.chunk_rb.numpy()
    cb = layout.chunk_cb.numpy()
    first = layout.span_first_chunk.numpy()
    y = np.zeros((layout.n_row_blocks * Wl, K))
    for s in range(layout.n_spans):
        sl = slice(first[s] * C, first[s + 1] * C)
        ch = np.repeat(np.arange(first[s], first[s + 1]), C)
        r, c, v = row[sl], col[sl], val[sl]
        real = r != Wl
        xi = cb[ch[real]] * Wl + c[real]
        keep = can_send(v[real], nonzero_row[xi], nonfinite_row[xi])
        for k0 in range(0, K, kt):
            ks = slice(k0, min(k0 + kt, K))
            win = np.zeros((Wl, ks.stop - k0))
            m = (v[real][keep].astype(np.float64)[:, None]
                 * x[xi[keep], ks].astype(np.float64))
            m[m == 0] = 0.0  # zero messages are not added
            np.add.at(win, r[real][keep], m)
            base = rb[first[s]] * Wl
            y[base:base + Wl, ks] += np.where(win != 0, win, 0.0)
    return y[:V]


def spmm_x(V, K, kind, rows, seed):
    """X of one kind: one-hot, signed one-hot or float, nonzero only on the
    rows ``rows`` selects (all, 10% or none)."""
    rng = np.random.default_rng(seed)
    if kind == "float":
        x = rng.standard_normal((V, K)).astype(np.float32)
    else:
        x = np.eye(K, dtype=np.float32)[rng.integers(0, K, V)]
        if kind == "signed":
            x *= rng.integers(-1, 2, (V, 1)).astype(np.float32)
    on = {"all": np.ones(V, bool), "10%": rng.random(V) < 0.1,
          "none": np.zeros(V, bool)}[rows]
    return np.where(on[:, None], x, 0.0).astype(np.float32)


@pytest.mark.parametrize("rows", ["all", "10%", "none"])
@pytest.mark.parametrize("kind", ["one-hot", "signed", "float"])
@pytest.mark.parametrize("K", [1, 4, 8, 32, 33])
def test_spmm_dense_model_matches_plain(K, kind, rows):
    """0/1 values with one-hot or signed X: exact; float X over signed
    values: rtol 1e-5 of the f32 plain sum. Spans of 3 chunks; K = 33 is
    no multiple of the K tile (32 at W=128, and 4 below)."""
    layout = b4_layout("unit_p3" if kind != "float" else "odd_chunk")
    x = spmm_x(layout.n_vertices, K, kind, rows, 60 + K)
    want = bucketed_spmm_plain(layout, torch.from_numpy(x)).numpy()
    for kt in sorted({tile_shape(K, layout.window, True)[0], 4}):
        got = spmm_dense_model(layout, x, kt)
        if kind == "float":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)
    if rows == "none":
        assert (want == 0).all()
    # the wrapper on the CPU is the plain version
    assert torch.equal(bucketed_spmm(layout, torch.from_numpy(x)),
                       torch.from_numpy(want))


@pytest.mark.parametrize("case", ["empty_row", "edgeless"])
def test_spmm_dense_model_other_layouts(case):
    """A row window no chunk reaches stays 0; an edgeless layout gives 0."""
    layout = b4_layout(case)
    x = spmm_x(layout.n_vertices, 12, "float", "all", 70)
    want = bucketed_spmm_plain(layout, torch.from_numpy(x)).numpy()
    got = spmm_dense_model(layout, x, tile_shape(12, layout.window, True)[0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if case == "empty_row":
        assert (got[3 * W:4 * W] == 0).all() and got[:W].any()
    else:
        assert not got.any()


@pytest.mark.parametrize("exact", [True, False])
def test_spmm_dense_model_matches_jax(exact):
    """Against the JAX kernel in interpret mode: exact for 0/1 X over 0/1
    values with 90% of X's rows zero (a BFS frontier); rtol 1e-4 for
    positive floats (the JAX kernel's bf16 hi+lo split)."""
    rows, cols, vals = skewed_graph(5, 300, 2500,
                                    values="01" if exact else "float")
    jl = j_build_layout(rows, cols, vals, 300, window=W, chunk=W)
    layout = carry(jl).with_span_chunks(2)
    if exact:
        x = spmm_x(300, 8, "one-hot", "10%", 71)
    else:
        x = np.random.default_rng(72).random((300, 8)).astype(np.float32)
    want = np.asarray(j_spmm(jl, jnp.asarray(x), interpret=True, exact=exact))
    got = spmm_dense_model(layout, x, 4)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_spmm_dense_keeps_nonfinite_messages():
    """A value of 0 over an X row holding inf still sends NaN, as the plain
    version computes it: the row flags drop only all-zero, finite rows."""
    layout = b4_layout("unit_p3")
    V = layout.n_vertices
    x = np.zeros((V, 4), np.float32)
    zero_val = layout.row_local != layout.window
    zero_val &= layout.values == 0
    slot = int(torch.nonzero(zero_val)[0])
    ch = slot // layout.chunk
    x[int(layout.chunk_cb[ch]) * layout.window + int(layout.col_local[slot])] = np.inf
    want = bucketed_spmm_plain(layout, torch.from_numpy(x)).numpy()
    got = spmm_dense_model(layout, x, 4)
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_dense_pass_tiles_and_walk():
    """The tiles the path meets at W=2048: over the dense pass's sorted
    list, batch PageRank's K=4 and batch PPR's and BC's K=8 in one tile of
    the whole window, K=32 in four row tiles of 512 rows x 32 columns; over
    the frontier-sparse pass's unsorted list, the whole window in K tiles
    of 8. The dense pass walks the metadata only where one tile holds the
    whole window."""
    assert [tile_shape(k, 2048, True) for k in (4, 8, 32, 33)] == [
        (4, 2048), (8, 2048), (32, 512), (32, 512)]
    assert [tile_shape(k, 2048, False) for k in (4, 8, 32)] == [
        (4, 2048), (8, 2048), (8, 2048)]
    assert tile_shape(32, 128, True) == (32, 128)
    assert k_tile(32, 2048) == 8
    for w in (128, 2048, 4096):
        for k in (1, 7, 64, 512):
            for sort in (True, False):
                kt, rows = tile_shape(k, w, sort)
                assert rows <= w and rows % 4 == 0
                assert 4 * rows * kt <= K_TILE_BYTES or kt == 1
    assert walks(1, 1)
    assert not walks(1, 4) and not walks(2, 1)


def test_sorted_keep_and_row_tiles_model():
    """The keep pass's counting sort and the row tiles' offsets, modelled:
    each row tile's part of a span's sorted list holds exactly the kept
    slots of its rows, so that summing the tiles is summing the span."""
    layout = b4_layout("unit_p3")
    x = spmm_x(layout.n_vertices, 6, "signed", "10%", 73)
    nonzero_row = (x != 0).any(axis=1)
    finite_row = np.isfinite(x).all(axis=1)
    Wl, C = layout.window, layout.chunk
    row, col = layout.row_local.numpy(), layout.col_local.numpy()
    val, cb = layout.values.numpy(), layout.chunk_cb.numpy()
    first = layout.span_first_chunk.numpy()
    rows_per_tile = 32
    for s in range(layout.n_spans):
        sl = slice(first[s] * C, first[s + 1] * C)
        ch = np.repeat(np.arange(first[s], first[s + 1]), C)
        real = row[sl] != Wl
        xi = cb[ch[real]] * Wl + col[sl][real]
        keep = can_send(val[sl][real], nonzero_row[xi], ~finite_row[xi])
        kept_rows = row[sl][real][keep]
        counts = np.bincount(kept_rows, minlength=Wl)
        places = np.concatenate([[0], np.cumsum(counts)])
        order = np.sort(kept_rows, kind="stable")  # the sorted list's rows
        offs = places[np.arange(0, Wl + 1, rows_per_tile).clip(max=Wl)]
        assert offs[-1] == keep.sum()
        for t in range(len(offs) - 1):
            part = order[offs[t]:offs[t + 1]]
            assert ((part >= t * rows_per_tile)
                    & (part < (t + 1) * rows_per_tile)).all()


# -- B6: the two-window span pass and its combine -----------------------------

def minmax_span_model(layout: BucketedEdges, x, active, out_mask):
    """(ymax, ymin) f32 by B6's passes: per span with an active chunk a max
    window (identity 0) and a min window (identity _BIG) over the positive
    messages val * x (f32) of its active chunks, touched if any; then
    each row block's touched windows combined, the identities where none."""
    Wl, C = layout.window, layout.chunk
    ch_act = chunk_activity_plain(
        layout, torch.from_numpy(active),
        None if out_mask is None else torch.from_numpy(out_mask))[0].numpy()
    row = layout.row_local.numpy()
    col = layout.col_local.numpy()
    val = layout.values.numpy()
    cb = layout.chunk_cb.numpy()
    first = layout.span_first_chunk.numpy()
    n_spans = layout.n_spans
    part_max = np.zeros((n_spans, Wl), np.float32)
    part_min = np.full((n_spans, Wl), BIG, np.float32)
    touched = np.zeros(n_spans, bool)
    for s in range(n_spans):
        for ch in range(first[s], first[s + 1]):
            if not ch_act[ch]:
                continue
            sl = slice(ch * C, (ch + 1) * C)
            real = row[sl] != Wl
            r = row[sl][real]
            m = val[sl][real] * x[cb[ch] * Wl + col[sl][real]]  # f32
            pos = m > 0
            np.maximum.at(part_max[s], r[pos], m[pos])
            np.minimum.at(part_min[s], r[pos], m[pos])
            touched[s] |= bool(pos.any())
    n_pad = layout.n_row_blocks * Wl
    ymax = np.zeros(n_pad, np.float32)
    ymin = np.full(n_pad, BIG, np.float32)
    rb_first = layout.rb_first_span.numpy()
    for b in range(layout.n_row_blocks):
        for s in range(rb_first[b], rb_first[b + 1]):
            if touched[s]:
                blk = slice(b * Wl, (b + 1) * Wl)
                ymax[blk] = np.maximum(ymax[blk], part_max[s])
                ymin[blk] = np.minimum(ymin[blk], part_min[s])
    return ymax[:layout.n_vertices], ymin[:layout.n_vertices]


def minmax_inputs(V, front, seed, x_zero=False):
    rng = np.random.default_rng(seed)
    active = {"full": np.ones(V, bool), "10%": rng.random(V) < 0.1,
              "empty": np.zeros(V, bool)}[front]
    prio = (rng.permutation(V) + 1).astype(np.float32)
    x = np.zeros(V, np.float32) if x_zero else np.where(active, prio, 0.0)
    return x.astype(np.float32), active


def assert_bits_equal(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("x_zero", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("front", ["full", "10%", "empty"])
@pytest.mark.parametrize("case", ["color", "color_p3", "color_odd",
                                  "empty_row", "edgeless"])
def test_minmax_span_model_matches_plain(case, front, masked, x_zero):
    """Bit for bit on every row, with out_mask the frontier itself (as
    Luby's rounds call it: the plain version runs the same chunks); an
    all-zero x leaves (0, _BIG) everywhere."""
    layout = b6_layout(case)
    V = layout.n_vertices
    x, active = minmax_inputs(V, front, 80, x_zero)
    om = active if masked else None
    want = bucketed_semiring_spmv_sparse_minmax_plain(
        layout, torch.from_numpy(x), torch.from_numpy(active),
        None if om is None else torch.from_numpy(om))
    got = minmax_span_model(layout, x, active, om)
    for g, w in zip(got, want):
        assert_bits_equal(g, w.numpy())
    if x_zero or front == "empty" or layout.n_chunks == 0:
        assert (got[0] == 0).all() and (got[1] == BIG).all()
    elif front == "full":
        assert (got[0] > 0).any() and (got[1] < BIG).any()
    # the wrapper on the CPU is the plain version
    wrapped = bucketed_semiring_spmv_sparse_minmax(
        layout, torch.from_numpy(x), torch.from_numpy(active),
        None if om is None else torch.from_numpy(om))
    for g, w in zip(wrapped, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("masked", [False, True])
def test_minmax_span_model_matches_jax(masked):
    """Bit for bit against the JAX kernel in interpret mode on the rows it
    defines (all, or those inside out_mask), spans of 2 chunks, values of
    0 in 30% of the slots."""
    rows, cols, vals = skewed_graph(6, 300, 2500)
    rng = np.random.default_rng(81)
    vals = np.where(rng.random(vals.size) < 0.3, 0.0, vals).astype(np.float32)
    jl = j_build_layout(rows, cols, vals, 300, window=W, chunk=W)
    layout = carry(jl).with_span_chunks(2)
    x, active = minmax_inputs(300, "10%", 82)
    active |= rng.random(300) < 0.3
    x = np.where(active, rng.random(300) + 0.1, 0.0).astype(np.float32)
    om = rng.random(300) < 0.5 if masked else None
    want = j_minmax(jl, jnp.asarray(x), jnp.asarray(active), interpret=True,
                    out_mask=None if om is None else jnp.asarray(om))
    got = minmax_span_model(layout, x, active, om)
    sel = om if masked else np.ones(300, bool)
    for g, w in zip(got, want):
        assert_bits_equal(g[sel], np.asarray(w)[sel])
    assert (got[0][sel] > 0).any() and (got[1][sel] == BIG).any()


# -- the warp fold of B6's span pass --------------------------------------------

def fold_runs(key, m):
    """max_min_runs step by step as the warp runs it: none if no lane has a
    message; else a shuffle up by one names each run's head lanes (a lane
    without a message heads a run of its own), five shuffle steps fold
    each run's max and min into its last lane, which sends them. Returns
    [(key, max, min)] in lane order."""
    key = np.asarray(key)
    if (key < 0).all():
        return []
    lanes = np.arange(32)
    prev = np.where(lanes == 0, key, np.roll(key, 1))  # shfl_up keeps lane 0
    heads = 0
    for lane in lanes:
        if lane == 0 or prev[lane] != key[lane] or key[lane] < 0:
            heads |= 1 << int(lane)
    hi, lo = m.astype(np.float32), m.astype(np.float32)
    if heads != 0xFFFFFFFF:
        off = 1
        while off < 32:
            up_hi = np.where(lanes >= off, np.roll(hi, off), hi)
            up_lo = np.where(lanes >= off, np.roll(lo, off), lo)
            for lane in range(off, 32):
                if (heads >> (lane - off + 1)) & ((1 << off) - 1) == 0:
                    hi[lane] = max(hi[lane], up_hi[lane])
                    lo[lane] = min(lo[lane], up_lo[lane])
            off <<= 1
    sent = []
    for lane in range(32):
        tail = lane == 31 or (heads >> (lane + 1)) & 1
        if tail and key[lane] >= 0:
            sent.append((int(key[lane]), float(hi[lane]), float(lo[lane])))
    return sent


def runs_of(key, m):
    """The same by grouping: one (key, max, min) per maximal run of equal
    keys on consecutive lanes, keys < 0 (no message) sending nothing."""
    out, start = [], 0
    for lane in range(1, 33):
        if lane == 32 or key[lane] != key[start]:
            if key[start] >= 0:
                seg = m[start:lane]
                out.append((int(key[start]), float(seg.max()), float(seg.min())))
            start = lane
    return out


@pytest.mark.parametrize("pattern", ["distinct", "one_run", "hub_runs",
                                     "gaps", "random", "none", "sparse"])
def test_fold_runs_sends_one_pair_per_run(pattern):
    rng = np.random.default_rng(90)
    m = (rng.random(32) + 0.01).astype(np.float32)
    key = {"distinct": np.arange(32),
           "one_run": np.full(32, 7),
           "hub_runs": np.repeat([3, 9, 3, 4], [13, 1, 17, 1]),
           "gaps": np.where(np.arange(32) % 5 == 0, -1, np.arange(32) // 6),
           "random": rng.integers(-1, 3, 32),
           "none": np.full(32, -1),
           "sparse": np.where(np.arange(32) % 7 == 3, 5, -1)}[pattern]
    got = fold_runs(key, m)
    assert got == runs_of(key, m)
    # max and min over each key's messages, whatever the runs
    for k in set(key[key >= 0].tolist()):
        assert max(h for kk, h, _ in got if kk == k) == m[key == k].max()
        assert min(lo for kk, _, lo in got if kk == k) == m[key == k].min()


# -- the row runs that decided B6's fold ----------------------------------------

def test_row_runs_of_luby_layout():
    """``row_runs`` against a slot-by-slot count: Luby's push layout keeps
    a hub's row in runs within a warp's 32 slots (the fold pays), a pull
    layout of the same graph hardly (mean run near 1)."""
    rows, cols, vals = skewed_graph(7)
    graph = build_graph(Coo(1000, 1000, rows, cols, vals), device="cpu")
    layout = color._color_layout(graph, window=W, chunk=W)
    got = pull.row_runs(layout)
    row = layout.row_local.numpy()
    lengths, n_runs = [], 0
    for g in range(0, row.size, 32):
        seg = row[g:g + 32]
        start = 0
        for i in range(1, 33):
            if i == 32 or seg[i] != seg[start]:
                if seg[start] != W:
                    n_runs += 1
                    lengths += [i - start] * (i - start)
                start = i
    lengths = np.array(lengths)
    assert got["real_slots"] == lengths.size
    assert got["mean_run"] == pytest.approx(lengths.size / n_runs)
    for n in (2, 8, 32):
        assert got[f"share_ge_{n}"] == pytest.approx((lengths >= n).mean())
    assert got["mean_run"] > 1.2 and got["share_ge_8"] > 0.1
    pulled = pull.row_runs(pull_layout(graph, window=W, chunk=W, unit=True))
    assert pulled["mean_run"] < got["mean_run"]


def test_pull_probe_b4_b6_and_luby_lines(capsys):
    """The pull probe on the CPU: the B4 and B6 cases, and the --luby line
    with one entry per B6 pass of the timed coloring, the first over every
    chunk (every vertex uncolored), no device time off the card."""
    assert pull.main(["--scale", "8", "--device", "cpu", "--num_runs", "1",
                      "--b4_b6", "--luby"]) == 0
    rows = {r["case"]: r for r in map(json.loads,
                                      capsys.readouterr().out.splitlines())}
    for case in ("b4_k4", "b4_k8", "b4_k32", "b4_msbfs", "b4_k4_keep",
                 "b4_k8_keep", "b4_k32_walk", "b4_msbfs_walk", "b6_full", "b6_tenth", "b6_hundredth",
                 "b6_empty", "b6_full_nomask", "b6_empty_nomask"):
        assert case in rows, case
    assert rows["b4_k32"]["k"] == 32 and rows["b4_k4"]["k"] == 4
    assert 0 < rows["b4_msbfs"]["nonzero_x_rows"] <= 256
    assert rows["b6_empty"]["active_chunks"] == 0
    assert rows["b4_k8"]["sparse_mm_device_ms"] == "not measured"
    line = rows["luby_passes"]
    n = line["iterations"]
    assert n >= 1 and len(line["active_chunks"]) == n
    assert line["active_chunks"][0] == line["n_chunks"]
    assert line["active_chunks_sum"] == sum(line["active_chunks"])
    assert line["device_ms_total"] == "not measured"
    assert line["row_runs"]["mean_run"] >= 1.0
