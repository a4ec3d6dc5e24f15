"""The port's kernels (their plain versions, which the CPU runs) against
the JAX package's Pallas kernels in interpret mode, on one layout built by
the JAX package and carried across with ``BucketedEdges.from_arrays``:
the chunk plan, the sparse and dense semiring passes, the fused max/min
pass, the dense and frontier-sparse SpMM, the fused HITS pass and the
Boruvka min-cut pass.

Tolerances: the layout, the chunk plan and the max/min semirings are
compared exactly (same chunks, order-free reductions, identical f32
message arithmetic). The max/min pass and the min-cut pass are exact too (max/min of products
of the same f32 factors; a min of integer ranks, the port's in int32 and
the JAX kernel's in f32, exact below 2^24). plus_times uses rtol 1e-4: the JAX kernel rebuilds
f32 from a bf16 hi+lo split (semiring.py:321-324, spmm.py:27-30) and the
port sums in another order. 0/1 inputs give exact integer counts in both.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrock_tpu.io.generators import rmat_graph as j_rmat_graph
from gunrock_tpu.ops.pallas import semiring as jsemiring
from gunrock_tpu.ops.pallas.hits_fused import hits_fused_pass as j_hits_fused_pass
from gunrock_tpu.ops.pallas.layout import dense_window_chunk as j_dense_window_chunk
from gunrock_tpu.ops.pallas.layout import build_bucketed_layout as j_build_layout
from gunrock_tpu.ops.pallas.semiring import _BIG, _sparse_chunk_select
from gunrock_tpu.ops.pallas.semiring import (
    bucketed_semiring_spmv as j_spmv,
)
from gunrock_tpu.ops.pallas.semiring import (
    bucketed_semiring_spmv_sparse as j_spmv_sparse,
)
from gunrock_tpu.ops.pallas.mst_min import bucketed_min_rank_cut as j_min_rank_cut
from gunrock_tpu.ops.pallas.semiring import (
    bucketed_semiring_spmv_sparse_minmax as j_minmax,
)
from gunrock_tpu.ops.pallas.spmm import bucketed_spmm as j_spmm
from gunrock_tpu.ops.pallas.spmm import bucketed_spmm_sparse as j_spmm_sparse

from gunrock_tpu_torch.graph import Graph, GraphProperties
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.ops.kernels import layout as tlayout
from gunrock_tpu_torch.ops.kernels.chunkplan import chunk_activity
from gunrock_tpu_torch.ops.kernels.hits_fused import hits_fused_pass
from gunrock_tpu_torch.ops.kernels.layout import (
    DATA_FIELDS,
    META_FIELDS,
    BucketedEdges,
    build_bucketed_layout,
    dense_window_chunk,
)
from gunrock_tpu_torch.ops.kernels.mst_min import NO_CUT, bucketed_min_rank_cut
from gunrock_tpu_torch.ops.kernels.semiring import (
    bucketed_semiring_spmv,
    bucketed_semiring_spmv_sparse,
    bucketed_semiring_spmv_sparse_minmax,
)
from gunrock_tpu_torch.ops.kernels.spmm import bucketed_spmm, bucketed_spmm_sparse

# W=128 (the JAX interpret-mode window), C=128 (v5 needs C % 128 == 0);
# V=300 is not a multiple of W, so the last window runs past V
V, W, C = 300, 128, 128


def random_edges(seed, n_vertices=V, n_edges=2500, negative=False):
    rng = np.random.default_rng(seed)
    # skewed sources and destinations: some buckets fill several chunks,
    # most end in a partly padded chunk
    rows = (n_vertices * rng.random(n_edges) ** 2).astype(np.int32)
    cols = (n_vertices * rng.random(n_edges) ** 2).astype(np.int32)
    vals = (rng.random(n_edges) + 0.1).astype(np.float32)
    if negative:
        vals *= rng.choice(np.float32([-1, 1]), n_edges)
    return rows, cols, vals


def carry(jl) -> BucketedEdges:
    """The JAX layout as the port's, array for array."""
    return BucketedEdges.from_arrays(
        {k: np.asarray(getattr(jl, k)) for k in DATA_FIELDS},
        **{k: getattr(jl, k) for k in META_FIELDS}, device="cpu",
    )


@pytest.mark.parametrize("n_vertices", [300, 256])
def test_build_bucketed_layout_matches_jax(n_vertices):
    rows, cols, vals = random_edges(1, n_vertices)
    jl = j_build_layout(rows, cols, vals, n_vertices, window=W, chunk=C,
                        pad_value=_BIG)
    tl = build_bucketed_layout(rows, cols, vals, n_vertices, window=W,
                               chunk=C, pad_value=_BIG, device="cpu")
    for k in META_FIELDS:
        assert getattr(tl, k) == getattr(jl, k), k
    for k in DATA_FIELDS:
        want = np.asarray(getattr(jl, k))
        if k in ("src_bits", "dst_bits"):
            want = want.astype(np.uint32).view(np.int32)  # bit 31 survives
        np.testing.assert_array_equal(getattr(tl, k).numpy(), want, err_msg=k)
    assert (tl.src_bits < 0).any(), "no word uses bit 31: weak test"
    # padding slots: row sentinel W, col 0, pad_value
    pad = tl.row_local == W
    assert pad.any() and (tl.col_local[pad] == 0).all()
    assert (tl.values[pad] == np.float32(_BIG)).all()


@pytest.mark.parametrize("kind", ["pull", "push"])
def test_graph_layouts_match_jax(kind):
    """pull_layout / push_layout of a graph equal the JAX package's."""
    jg = j_rmat_graph(scale=8, seed=3)
    tg = Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")
    jl = getattr(jsemiring, f"{kind}_layout")(jg, window=W, chunk=C)
    tl = getattr(tlayout, f"{kind}_layout")(tg, window=W, chunk=C)
    assert getattr(tlayout, f"{kind}_layout")(tg, window=W, chunk=C) is tl
    for k in META_FIELDS:
        assert getattr(tl, k) == getattr(jl, k), k
    for k in DATA_FIELDS:
        want = np.asarray(getattr(jl, k))
        if k in ("src_bits", "dst_bits"):
            want = want.astype(np.uint32).view(np.int32)
        np.testing.assert_array_equal(getattr(tl, k).numpy(), want, err_msg=k)


def frontier(seed, p=0.3):
    rng = np.random.default_rng(seed)
    return rng.random(V) < p


@pytest.mark.parametrize("masked", [False, True])
def test_chunk_activity_matches_jax(masked):
    rows, cols, vals = random_edges(2)
    jl = j_build_layout(rows, cols, vals, V, window=W, chunk=C)
    tl = carry(jl)
    active = frontier(3, 0.05)
    out_mask = frontier(4, 0.5) if masked else None
    want, _, _, count = _sparse_chunk_select(
        jl, jnp.asarray(active), None if out_mask is None else jnp.asarray(out_mask))
    ch_act, queue, n = chunk_activity(
        tl, torch.from_numpy(active),
        None if out_mask is None else torch.from_numpy(out_mask))
    np.testing.assert_array_equal(ch_act.numpy(), np.asarray(want))
    assert 0 < int(n[0]) == int(count) < tl.n_chunks
    np.testing.assert_array_equal(queue[: int(n[0])].numpy(),
                                  np.flatnonzero(np.asarray(want)))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("semiring", ["plus_times", "max_times", "min_plus"])
def test_spmv_sparse_matches_jax(semiring, unit, masked):
    rng = np.random.default_rng(5)
    rows, cols, vals = random_edges(6, negative=semiring != "plus_times")
    pad = _BIG if semiring == "min_plus" else 0.0
    jl = j_build_layout(rows, cols, vals, V, window=W, chunk=C, pad_value=pad)
    tl = carry(jl)
    active = frontier(7)
    out_mask = frontier(8, 0.5) if masked else None
    # inactive sources carry the gather identity (the kernel's contract)
    if semiring == "min_plus":
        x = np.where(active, rng.standard_normal(V), np.inf)
    elif semiring == "max_times":
        x = np.where(active, rng.standard_normal(V), 0.0)
    else:
        x = np.where(active, rng.random(V), 0.0)
    x = x.astype(np.float32)
    want = np.asarray(j_spmv_sparse(
        jl, jnp.asarray(x), jnp.asarray(active), semiring, interpret=True,
        out_mask=None if out_mask is None else jnp.asarray(out_mask),
        unit=unit))
    got = bucketed_semiring_spmv_sparse(
        tl, torch.from_numpy(x), torch.from_numpy(active), semiring,
        out_mask=None if out_mask is None else torch.from_numpy(out_mask),
        unit=unit).numpy()
    # every row, not only the out_mask rows: both run the same chunks
    if semiring == "plus_times":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    if semiring == "min_plus":
        assert np.isinf(got).any() and np.isfinite(got).any()


def test_spmv_sparse_bfs_pull_counts_exact():
    """The BFS pull: unit plus_times on a 0/1 frontier gives exact counts."""
    rows, cols, vals = random_edges(9)
    jl = j_build_layout(rows, cols, np.ones_like(vals), V, window=W, chunk=C)
    active = frontier(10, 0.1)
    unreached = ~frontier(11, 0.4)
    want = np.asarray(j_spmv_sparse(
        jl, jnp.asarray(active, jnp.float32), jnp.asarray(active),
        "plus_times", interpret=True, out_mask=jnp.asarray(unreached),
        exact=True, unit=True))
    got = bucketed_semiring_spmv_sparse(
        carry(jl), torch.from_numpy(active).float(), torch.from_numpy(active),
        "plus_times", out_mask=torch.from_numpy(unreached), exact=True,
        unit=True).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("semiring", ["plus_times", "max_times", "min_plus"])
def test_spmv_sparse_edgeless_layout(semiring):
    e = np.zeros(0, np.int32)
    jl = j_build_layout(e, e, e.astype(np.float32), 50, window=W, chunk=C)
    x = np.ones(50, np.float32)
    act = np.ones(50, bool)
    want = np.asarray(j_spmv_sparse(jl, jnp.asarray(x), jnp.asarray(act),
                                    semiring, interpret=True))
    got = bucketed_semiring_spmv_sparse(carry(jl), torch.from_numpy(x),
                                        torch.from_numpy(act), semiring).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == (np.inf if semiring == "min_plus" else 0.0)


@pytest.mark.parametrize("exact", [True, False])
def test_spmm_matches_jax(exact):
    rng = np.random.default_rng(12)
    rows, cols, vals = random_edges(13)
    if exact:
        vals = np.ones_like(vals)
        x = (rng.random((V, 8)) < 0.2).astype(np.float32)
    else:  # positive: no cancellation, so rtol bounds the hi+lo error
        x = rng.random((V, 8)).astype(np.float32)
    jl = j_build_layout(rows, cols, vals, V, window=W, chunk=C)
    want = np.asarray(j_spmm(jl, jnp.asarray(x), interpret=True, exact=exact))
    got = bucketed_spmm(carry(jl), torch.from_numpy(x), exact=exact).numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _dense_x(rng, semiring, n=V):
    """x for the dense pass: any sign for max/min (negative messages reach
    the signed atomics), positive for plus_times (no cancellation, so
    rtol bounds the JAX kernel's hi+lo error)."""
    if semiring == "plus_times":
        return rng.random(n).astype(np.float32)
    return rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("case", ["edges", "empty_row_window", "edgeless"])
@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("semiring", ["plus_times", "max_times", "min_plus"])
def test_spmv_dense_matches_jax(semiring, unit, case):
    """B3, the dense pass. min/max exact (the same f32 messages, an
    order-free reduction); plus_times within rtol 1e-4 (the JAX kernel's
    bf16 hi+lo split). Values carry both signs for max/min."""
    rng = np.random.default_rng(14)
    rows, cols, vals = random_edges(15, negative=semiring != "plus_times")
    if case == "empty_row_window":
        keep = rows // W != 1  # rows 128..255: a window no chunk reaches
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    elif case == "edgeless":
        rows, cols, vals = rows[:0], cols[:0], vals[:0]
    pad = _BIG if semiring == "min_plus" else 0.0
    jl = j_build_layout(rows, cols, vals, V, window=W, chunk=C, pad_value=pad)
    x = _dense_x(rng, semiring)
    if semiring == "min_plus":  # the SSSP input: _BIG off the frontier
        x = np.where(rng.random(V) < 0.5, x, np.float32(_BIG))
    got = bucketed_semiring_spmv(carry(jl), torch.from_numpy(x), semiring,
                                 unit=unit).numpy()
    if case == "edgeless":
        # the JAX kernel cannot run a grid of 0 chunks in interpret mode
        # (its scalar-prefetch slice of pk fails); its callers return the
        # identity instead (ops/pallas/spmv.py:34-35), as the port does
        assert (got == (np.inf if semiring == "min_plus" else 0.0)).all()
        return
    want = np.asarray(j_spmv(jl, jnp.asarray(x), semiring, interpret=True,
                             unit=unit))
    if semiring == "plus_times":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    if case == "empty_row_window":
        ident = np.inf if semiring == "min_plus" else 0.0
        assert (got[W:2 * W] == ident).all()
        assert (got != ident).any()


def _hits_dense(rows, cols, auth, hub):
    """(hub_raw, auth_raw) in float64 from the edge list itself."""
    hub_raw = np.zeros(V)
    auth_raw = np.zeros(V)
    np.add.at(hub_raw, rows, auth[cols])
    np.add.at(auth_raw, cols, hub[rows])
    return hub_raw, auth_raw


def test_hits_fused_pass_matches_jax():
    """B8 on a unit push layout whose chunks end in padding (row sentinel
    W, col 0): the padding must add nothing to vertex cb*W. rtol 1e-4
    against the JAX kernel (bf16 hi+lo), 1e-5 against the float64 sum."""
    rng = np.random.default_rng(16)
    rows, cols, _ = random_edges(17)
    ones = np.ones(rows.size, np.float32)
    jl = j_build_layout(rows, cols, ones, V, window=W, chunk=C)
    tl = carry(jl)
    pad = tl.row_local == W
    assert pad.any() and (tl.col_local[pad] == 0).all()
    auth = rng.random(V).astype(np.float32)
    hub = rng.random(V).astype(np.float32)
    want_h, want_a = j_hits_fused_pass(jl, jnp.asarray(auth), jnp.asarray(hub),
                                       interpret=True)
    got_h, got_a = hits_fused_pass(tl, torch.from_numpy(auth),
                                   torch.from_numpy(hub))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-4,
                               atol=1e-6)
    ref_h, ref_a = _hits_dense(rows, cols, auth, hub)
    np.testing.assert_allclose(got_h.numpy(), ref_h, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_a.numpy(), ref_a, rtol=1e-5, atol=1e-6)
    # vertices cb*W with no in-edge would show phantom mass as nonzero
    no_in = np.setdiff1d(np.arange(0, V, W), cols)
    assert (got_a.numpy()[no_in] == 0).all()


def test_hits_fused_pass_edgeless():
    e = np.zeros(0, np.int32)
    tl = carry(j_build_layout(e, e, e.astype(np.float32), 50, window=W,
                              chunk=C))
    ones = torch.ones(50)
    for y in hits_fused_pass(tl, ones, ones):
        assert (y == 0).all()


@pytest.mark.parametrize("n_vertices", [1000, 1 << 16, 300_000, 1 << 20,
                                        (1 << 20) + 1])
def test_dense_window_chunk_matches_jax(n_vertices):
    assert dense_window_chunk(n_vertices) == j_dense_window_chunk(n_vertices)


# -- the fused max/min pass, the frontier-sparse SpMM, the min-cut pass ----

def _opt(mask):
    """(jax, torch) forms of an optional bool mask."""
    if mask is None:
        return None, None
    return jnp.asarray(mask), torch.from_numpy(mask)


@pytest.mark.parametrize("masked", [False, True])
def test_minmax_matches_jax(masked):
    """B6: exact on the rows that are defined (all rows, or those inside
    out_mask); a row with no positive message holds _BIG itself."""
    rng = np.random.default_rng(18)
    rows, cols, vals = random_edges(19)
    vals = np.where(rng.random(vals.size) < 0.3, 0.0, vals).astype(np.float32)
    jl = j_build_layout(rows, cols, vals, V, window=W, chunk=C)
    active = frontier(20, 0.35)
    x = np.where(active, rng.random(V) + 0.1, 0.0).astype(np.float32)
    om = frontier(21, 0.5) if masked else None
    jom, tom = _opt(om)
    want = j_minmax(jl, jnp.asarray(x), jnp.asarray(active), interpret=True,
                    out_mask=jom)
    got = bucketed_semiring_spmv_sparse_minmax(
        carry(jl), torch.from_numpy(x), torch.from_numpy(active), out_mask=tom)
    sel = om if masked else np.ones(V, bool)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[sel], np.asarray(w)[sel])
    ymax, ymin = (g.numpy()[sel] for g in got)
    none = ymax == 0.0
    assert none.any() and (~none).any()
    assert (ymin[none] == np.float32(_BIG)).all()
    assert (ymin[~none] <= ymax[~none]).all() and (ymin[~none] > 0).all()


def test_minmax_edgeless_layout():
    e = np.zeros(0, np.int32)
    jl = j_build_layout(e, e, e.astype(np.float32), 50, window=W, chunk=C)
    x, act = np.ones(50, np.float32), np.ones(50, bool)
    want = j_minmax(jl, jnp.asarray(x), jnp.asarray(act), interpret=True)
    got = bucketed_semiring_spmv_sparse_minmax(
        carry(jl), torch.from_numpy(x), torch.from_numpy(act))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] == 0).all() and (got[1] == np.float32(_BIG)).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("exact", [True, False])
def test_spmm_sparse_matches_jax(exact, masked):
    """B5: signed one-hot deltas over 0/1 values are exact; positive floats
    within rtol 1e-4 (the JAX kernel's bf16 hi+lo split). Rows no active
    chunk reaches are 0."""
    rng = np.random.default_rng(22)
    rows, cols, vals = random_edges(23)
    active = frontier(24, 0.1)
    # every active source sits in the first window: chunks of the other
    # col windows are skipped, and some rows are reached by none
    active[W:] = False
    if exact:
        vals = (rng.random(vals.size) < 0.5).astype(np.float32)
        x = rng.integers(-1, 2, (V, 8)).astype(np.float32)
    else:
        x = rng.random((V, 8)).astype(np.float32)
    x = np.where(active[:, None], x, 0.0).astype(np.float32)
    jl = j_build_layout(rows, cols, vals, V, window=W, chunk=C)
    om = frontier(25, 0.5) if masked else None
    jom, tom = _opt(om)
    want = np.asarray(j_spmm_sparse(
        jl, jnp.asarray(x), jnp.asarray(active), interpret=True, out_mask=jom,
        exact=exact))
    got = bucketed_spmm_sparse(carry(jl), torch.from_numpy(x),
                               torch.from_numpy(active), out_mask=tom,
                               exact=exact).numpy()
    sel = om if masked else np.ones(V, bool)
    if exact:
        np.testing.assert_array_equal(got[sel], want[sel])
        assert (got < 0).any() and (got > 0).any()
    else:
        np.testing.assert_allclose(got[sel], want[sel], rtol=1e-4, atol=1e-5)
    # rows with no edge from an active source: exactly 0, in and out of the
    # mask (the result is safe to accumulate)
    reached = np.zeros(V, bool)
    reached[rows[active[cols]]] = True
    assert (~reached).any() and (got[~reached] == 0).all()


def _rank_layout(seed):
    """A layout whose values are distinct integer ranks (f32, _BIG padding)
    and the same ranks as int32 per slot."""
    rows, cols, _ = random_edges(seed)
    ranks = np.random.default_rng(seed).permutation(rows.size)
    jl = j_build_layout(rows, cols, ranks.astype(np.float32), V, window=W,
                        chunk=C, pad_value=_BIG)
    tl = carry(jl)
    pad = tl.row_local == W
    slot_ranks = torch.where(pad, NO_CUT, tl.values.to(torch.int64)).to(
        torch.int32)
    return jl, tl, slot_ranks


def test_min_rank_cut_matches_jax():
    """B7 with random roots: the least rank over each row's cut edges,
    exact; rows without one hold the sentinel (the JAX kernel's _BIG)."""
    jl, tl, slot_ranks = _rank_layout(26)
    roots = np.random.default_rng(27).integers(0, 4, V).astype(np.int32)
    want = np.asarray(j_min_rank_cut(jl, jnp.asarray(roots, jnp.float32),
                                     interpret=True))
    got = bucketed_min_rank_cut(tl, slot_ranks, torch.from_numpy(roots)).numpy()
    none = want >= np.float32(_BIG)
    assert none.any() and (~none).any()
    assert (got[none] == NO_CUT).all()
    np.testing.assert_array_equal(got[~none], want[~none].astype(np.int32))


def test_min_rank_cut_one_component_and_edgeless():
    _, tl, slot_ranks = _rank_layout(28)
    one = torch.zeros(V, dtype=torch.int32)
    assert (bucketed_min_rank_cut(tl, slot_ranks, one) == NO_CUT).all()
    e = np.zeros(0, np.int32)
    tl = carry(j_build_layout(e, e, e.astype(np.float32), 50, window=W,
                              chunk=C, pad_value=_BIG))
    got = bucketed_min_rank_cut(tl, torch.zeros(0, dtype=torch.int32),
                                torch.arange(50, dtype=torch.int32))
    assert got.shape == (50,) and (got == NO_CUT).all()


# -- the Weiszfeld step (dense and chunk-skipping) ---------------------------
# Counts of nonzero distances are equal. The sums hold rtol 1e-4 beside an
# absolute term of 1e-4 of the row's sum of 1/d times the largest
# coordinate: the JAX kernel's arcsin is a Cephes polynomial within 2e-6 of
# torch.asin, it rebuilds f32 sums from a bf16 hi+lo split, and the two
# coordinate sums have terms of either sign. A row whose iterate lies
# exactly on a neighbour is the one place the two disagree, see
# test_weiszfeld_step_zero_distance.

def _wstep_case(seed, labeled_share=0.4, coincident=False):
    """(JAX layout, port layout, slot arrays and iterate as numpy): the
    push layout of random edges and slot tables as geo_kernel builds them;
    with ``coincident`` every 5th row's iterate lies exactly on one of its
    labeled neighbours (distance 0)."""
    rng = np.random.default_rng(seed)
    rows, cols, _ = random_edges(seed)
    ones = np.ones(rows.size, np.float32)
    jl = j_build_layout(rows, cols, ones, V, window=W, chunk=C)
    tl = carry(jl)
    lat = rng.uniform(-60, 60, V).astype(np.float32)
    lon = rng.uniform(-180, 180, V).astype(np.float32)
    labeled = rng.random(V) < labeled_share
    slot_valid = np.asarray(jl.row_local) != W
    slot_dst = np.where(
        slot_valid, np.repeat(np.asarray(jl.chunk_cb), C) * W
        + np.asarray(jl.col_local), 0)
    ok = slot_valid & labeled[slot_dst]
    shape = (jl.n_chunks, C // 128, 128)
    mlat3 = np.where(ok, lat[slot_dst], 0).astype(np.float32).reshape(shape)
    mlon3 = np.where(ok, lon[slot_dst], 0).astype(np.float32).reshape(shape)
    ok3 = ok.astype(np.float32).reshape(shape)
    y_lat = rng.uniform(-60, 60, V).astype(np.float32)
    y_lon = rng.uniform(-180, 180, V).astype(np.float32)
    slot_row = np.repeat(np.asarray(jl.chunk_rb), C) * W + np.asarray(jl.row_local)
    for s in np.flatnonzero(ok) if coincident else ():
        r = slot_row[s]
        if r % 5 == 0:
            y_lat[r], y_lon[r] = lat[slot_dst[s]], lon[slot_dst[s]]
    return jl, tl, (y_lat, y_lon, mlat3, mlon3, ok3)


def _assert_wstep_close(got, want):
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    np.testing.assert_array_equal(got[0], want[0])
    assert (want[0] > 0).any()
    for k, scale in ((1, 1.0), (2, 60.0), (3, 180.0)):
        np.testing.assert_allclose(
            got[k], want[k], rtol=1e-4,
            atol=float(1e-4 * scale * want[1].max()) + 1e-12, err_msg=str(k))


def test_weiszfeld_step_sums_matches_jax():
    from gunrock_tpu.ops.pallas.geo_step import weiszfeld_step_sums as j_wstep

    from gunrock_tpu_torch.ops.kernels.geo_step import weiszfeld_step_sums

    jl, tl, arrays = _wstep_case(11)
    want = j_wstep(jl, *(jnp.asarray(a) for a in arrays), interpret=True)
    got = weiszfeld_step_sums(tl, *(torch.from_numpy(a) for a in arrays))
    _assert_wstep_close(got, want)


def test_weiszfeld_step_zero_distance():
    """A row whose iterate lies exactly on a labeled neighbour: the port's
    distance is exactly 0 (equal radians subtract to 0) and the slot is
    not counted, as in the JAX package's eager formula. The jitted JAX
    kernel on the CPU contracts ``lat2 * rad - lat1 * rad`` into a fused
    multiply-add, which leaves the product's rounding error: a distance
    of up to ~7.5e-4 km that it counts. Every other row agrees."""
    from gunrock_tpu.ops.pallas.geo_step import weiszfeld_step_sums as j_wstep

    from gunrock_tpu_torch.ops.kernels.geo_step import haversine, weiszfeld_step_sums

    jl, tl, arrays = _wstep_case(11, coincident=True)
    want = j_wstep(jl, *(jnp.asarray(a) for a in arrays), interpret=True)
    got = weiszfeld_step_sums(tl, *(torch.from_numpy(a) for a in arrays))
    on = np.arange(V) % 5 == 0
    _assert_wstep_close([g[~on] for g in got],
                        [np.asarray(w)[~on] for w in want])
    labeled_per_row = np.zeros(V)
    ok = arrays[4].reshape(-1) > 0
    rows = (np.repeat(np.asarray(jl.chunk_rb), C) * W
            + np.asarray(jl.row_local))[ok]
    np.add.at(labeled_per_row, rows, 1)
    cnt = got[0].numpy()
    assert (cnt[on] < labeled_per_row[on]).any()
    np.testing.assert_array_equal(cnt[~on], labeled_per_row[~on])
    assert (cnt <= np.asarray(want[0])).all()
    lat = torch.tensor([12.5, -40.25, 59.99])
    lon = torch.tensor([100.1, -179.9, 0.3])
    assert (haversine(lat, lon, lat.clone(), lon.clone()) == 0).all()


@pytest.mark.parametrize("undone_share", [1.0, 0.1, 0.0])
def test_weiszfeld_step_sums_sparse_matches_jax(undone_share):
    from gunrock_tpu.ops.pallas.geo_step import (
        weiszfeld_step_sums_sparse as j_wstep_sparse,
    )

    from gunrock_tpu_torch.ops.kernels.geo_step import (
        weiszfeld_step_sums,
        weiszfeld_step_sums_sparse,
    )

    jl, tl, arrays = _wstep_case(12)
    undone = np.random.default_rng(13).random(V) < undone_share
    want = j_wstep_sparse(jl, *(jnp.asarray(a) for a in arrays),
                          jnp.asarray(undone), interpret=True)
    tensors = [torch.from_numpy(a) for a in arrays]
    got = weiszfeld_step_sums_sparse(tl, *tensors, torch.from_numpy(undone))
    if undone_share == 0.0:
        assert all(not g.any() for g in got)
        assert all(not np.asarray(w).any() for w in want)
        return
    _assert_wstep_close(got, want)
    # rows that still iterate get the dense pass's sums; rows outside every
    # touched window are 0
    dense = weiszfeld_step_sums(tl, *tensors)
    for g, d in zip(got, dense):
        np.testing.assert_allclose(g.numpy()[undone], d.numpy()[undone],
                                   rtol=1e-5)
    if undone_share < 1.0:
        touched = np.zeros(tl.n_row_blocks, bool)
        touched[np.flatnonzero(undone) // W] = True
        outside = ~np.repeat(touched, W)[:V]
        assert all(not g.numpy()[outside].any() for g in got)


def test_weiszfeld_step_edgeless_and_bad_shapes():
    from gunrock_tpu_torch.ops.kernels.geo_step import (
        weiszfeld_step_sums,
        weiszfeld_step_sums_sparse,
    )

    empty = np.zeros(0, np.int32)
    tl = build_bucketed_layout(empty, empty, empty.astype(np.float32), V,
                               window=W, chunk=C, device="cpu")
    y = torch.zeros(V)
    none = torch.zeros(0)
    for sums in (weiszfeld_step_sums(tl, y, y, none, none, none),
                 weiszfeld_step_sums_sparse(tl, y, y, none, none, none,
                                            torch.ones(V, dtype=torch.bool))):
        assert all(s.shape == (V,) and not s.any() for s in sums)
    with pytest.raises(ValueError):
        weiszfeld_step_sums(tl, y, y, torch.zeros(5), none, none)
    with pytest.raises(ValueError):
        weiszfeld_step_sums(tl, y[:-1], y, none, none, none)


# -- the banded gather -------------------------------------------------------

def test_banded_gather_matches_jax_on_every_element():
    """In-window indices give table[idx]; out-of-window ones the clamped
    element, the same one as the JAX kernel: every element is compared."""
    from gunrock_tpu.ops.pallas.banded import banded_gather as j_banded
    from gunrock_tpu.ops.pallas.banded import pad_table as j_pad_table

    from gunrock_tpu_torch.ops.kernels.banded import banded_gather, pad_table

    rng = np.random.default_rng(21)
    span_rows, T, n_blocks = 5, 256, 6
    table = rng.integers(0, 1 << 30, 3000).astype(np.int32)
    table2 = pad_table(table, span_rows)
    np.testing.assert_array_equal(table2, j_pad_table(table, span_rows))
    block_lo = rng.integers(0, 24, n_blocks).astype(np.int32)
    lo = np.repeat(block_lo.astype(np.int64) * 128, T)
    idx = lo + rng.integers(0, span_rows * 128, lo.size)
    out = rng.random(lo.size) < 0.15
    idx[out] = rng.integers(-50, table2.size, int(out.sum()))
    idx = idx.astype(np.int32)
    want = np.asarray(j_banded(jnp.asarray(table2), jnp.asarray(idx),
                               jnp.asarray(block_lo), span_rows=span_rows,
                               block_t=T, interpret=True))
    got = banded_gather(torch.from_numpy(table2), torch.from_numpy(idx),
                        torch.from_numpy(block_lo), span_rows=span_rows,
                        block_t=T).numpy()
    np.testing.assert_array_equal(got, want)
    inside = (idx >= lo) & (idx < lo + span_rows * 128)
    assert (~inside).sum() > 50
    np.testing.assert_array_equal(got[inside], table2.reshape(-1)[idx[inside]])


def test_banded_gather_rejects_bad_shapes():
    from gunrock_tpu_torch.ops.kernels.banded import banded_gather

    table2 = torch.zeros((8, 128), dtype=torch.int32)
    idx = torch.zeros(256, dtype=torch.int32)
    lo = torch.zeros(1, dtype=torch.int32)
    assert banded_gather(table2, idx, lo, span_rows=2, block_t=256).shape == (256,)
    with pytest.raises(ValueError):
        banded_gather(table2, idx[:200], lo, span_rows=2, block_t=256)
    with pytest.raises(ValueError):
        banded_gather(table2, idx, lo, span_rows=9, block_t=256)
    with pytest.raises(ValueError):
        banded_gather(table2.long(), idx, lo, span_rows=2, block_t=256)
    with pytest.raises(ValueError):
        banded_gather(table2.view(-1), idx, lo, span_rows=2, block_t=256)
