"""The span kernels of the fused HITS pass (B8, ``csrc/hits_fused.cu``) and
the frontier-sparse SpMM (B5, ``csrc/spmm.cu``), modelled in numpy on the
CPU, where no CUDA kernel runs.

- The column span table of ``layout.py`` (``chunk_by_cb``,
  ``col_span_first_chunk``, ``cb_first_span``): every chunk in exactly one
  column span, each span inside one column block with at most P chunks,
  empty column blocks own no span; carried by ``from_arrays``,
  ``with_span_chunks`` and a layout built by the JAX package.
- B8's two passes: a window per row span (auth gathered by column, added
  by row) and per column span (hub gathered by row, added by column,
  padding skipped by the ROW sentinel), then each block's spans combined.
- B5's passes: one window of W x Kt per (span, K tile) over the active
  chunks, slots that can send only +-0 skipped by the X-row flags, the
  window's nonzero entries then added into Y.

Each model is held against the plain version (``*_plain``) and against the
JAX Pallas function in interpret mode: exactly for small-integer sums,
within rtol 1e-5 of the plain f32 sum (the model sums in float64) and
rtol 1e-4 of the JAX kernels (their bf16 hi+lo split, ROADMAP C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrock_tpu.ops.pallas.hits_fused import hits_fused_pass as j_hits_fused_pass
from gunrock_tpu.ops.pallas.layout import build_bucketed_layout as j_build_layout
from gunrock_tpu.ops.pallas.spmm import bucketed_spmm_sparse as j_spmm_sparse

from gunrock_tpu_torch.ops.kernels.chunkplan import chunk_activity_plain
from gunrock_tpu_torch.ops.kernels.hits_fused import (
    hits_fused_pass,
    hits_fused_pass_plain,
)
from gunrock_tpu_torch.ops.kernels.layout import (
    DATA_FIELDS,
    META_FIELDS,
    BucketedEdges,
    build_bucketed_layout,
    span_chunks,
)
from gunrock_tpu_torch.ops.kernels.spmm import (
    K_TILE_BYTES,
    K_TILES,
    bucketed_spmm_sparse,
    bucketed_spmm_sparse_plain,
    k_tile,
)


def skewed(seed, n_vertices, n_edges, power=2, values="float"):
    """Edges whose rows and columns crowd the first windows, as a
    degree-sorted graph's do, so the first row and column blocks own many
    chunks; values float in [0.1, 1.1), 0/1, or of mixed sign."""
    rng = np.random.default_rng(seed)
    rows = (n_vertices * rng.random(n_edges) ** power).astype(np.int32)
    cols = (n_vertices * rng.random(n_edges) ** power).astype(np.int32)
    if values == "01":
        vals = (rng.random(n_edges) < 0.5).astype(np.float32)
    else:
        vals = (rng.random(n_edges) + 0.1).astype(np.float32)
        if values == "signed":
            vals *= rng.choice(np.float32([-1, 1]), n_edges)
    return rows, cols, vals


def carry(jl) -> BucketedEdges:
    """The JAX layout as the port's, array for array."""
    return BucketedEdges.from_arrays(
        {k: np.asarray(getattr(jl, k)) for k in DATA_FIELDS},
        **{k: getattr(jl, k) for k in META_FIELDS}, device="cpu")


def layout_of(case, values="float") -> BucketedEdges:
    if case == "small":  # V=300 runs past the last window
        return build_bucketed_layout(*skewed(1, 300, 2500, values=values), 300,
                                     window=128, chunk=128, device="cpu")
    if case == "jax_carried":
        return carry(j_build_layout(*skewed(3, 300, 2500, values=values), 300,
                                    window=128, chunk=128))
    if case == "odd_chunk":  # C = 125: the kernels' scalar loads
        return build_bucketed_layout(*skewed(5, 1000, 20_000, 3, values),
                                     1000, window=128, chunk=125, device="cpu")
    if case == "empty_col_block":  # column block 1 of 4 gets no chunk
        rows, cols, vals = skewed(6, 500, 4000, values=values)
        keep = cols // 128 != 1
        return build_bucketed_layout(rows[keep], cols[keep], vals[keep], 500,
                                     window=128, chunk=64, device="cpu")
    if case == "w4096_c1024":
        V = 2 * 4096 + 5
        return build_bucketed_layout(*skewed(7, V, 30_000, values=values), V,
                                     window=4096, chunk=1024, device="cpu")
    if case == "edgeless":
        e = np.zeros(0, np.int32)
        return build_bucketed_layout(e, e, e.astype(np.float32), 50,
                                     window=128, chunk=128, device="cpu")
    raise ValueError(case)


CASES = ["small", "jax_carried", "odd_chunk", "empty_col_block",
         "w4096_c1024", "edgeless"]


# -- the column span table --------------------------------------------------

def check_col_table(layout: BucketedEdges, p: int) -> None:
    by_cb = layout.chunk_by_cb.numpy().astype(np.int64)
    first = layout.col_span_first_chunk.numpy().astype(np.int64)
    cb_first = layout.cb_first_span.numpy().astype(np.int64)
    cb = layout.chunk_cb.numpy()
    for t in (layout.chunk_by_cb, layout.col_span_first_chunk,
              layout.cb_first_span):
        assert t.dtype == torch.int32
    # chunk_by_cb: the chunk ids, stably sorted by column block
    np.testing.assert_array_equal(by_cb, np.argsort(cb, kind="stable"))
    # every chunk in exactly one span, spans in order, none empty, <= P
    assert first[0] == 0 and first[-1] == layout.n_chunks
    lengths = np.diff(first)
    assert (lengths >= 1).all() and (lengths <= p).all()
    # each span inside one column block
    span_cb = cb[by_cb]
    if layout.n_col_spans:
        assert (span_cb[first[:-1]] == span_cb[first[1:] - 1]).all()
    # cb_first_span names each column block's spans, as few as P allows;
    # a column block no chunk reaches owns none
    assert cb_first.shape == (layout.n_col_blocks + 1,)
    assert cb_first[0] == 0 and cb_first[-1] == layout.n_col_spans
    per_cb = np.bincount(cb, minlength=layout.n_col_blocks)
    np.testing.assert_array_equal(np.diff(cb_first), -(-per_cb // p))
    for b in range(layout.n_col_blocks):
        spans = np.arange(cb_first[b], cb_first[b + 1])
        assert (span_cb[first[spans]] == b).all()
        assert (per_cb[b] == 0) == (spans.size == 0)


@pytest.mark.parametrize("case", CASES)
def test_col_span_table(case):
    layout = layout_of(case)
    check_col_table(layout, span_chunks(layout.chunk))


@pytest.mark.parametrize("p", [1, 3, 64])
def test_col_span_table_at_other_p(p):
    layout = layout_of("odd_chunk").with_span_chunks(p)
    check_col_table(layout, p)
    if p == 1:
        assert layout.n_col_spans == layout.n_chunks


def test_empty_col_block_owns_no_span():
    layout = layout_of("empty_col_block")
    cb_first = layout.cb_first_span.numpy()
    assert cb_first[2] == cb_first[1]  # column block 1
    # the skewed columns give column block 0 several spans at P = 3
    cut = layout.with_span_chunks(3)
    assert int(cut.cb_first_span[1]) > 1


def test_every_way_of_making_a_layout_carries_both_tables():
    """from_arrays (the JAX package's arrays), with_span_chunks and
    build_bucketed_layout all give the same tables for the same chunks."""
    args = skewed(3, 300, 2500)
    built = build_bucketed_layout(*args, 300, window=128, chunk=128,
                                  device="cpu")
    carried = carry(j_build_layout(*args, 300, window=128, chunk=128))
    recut = built.with_span_chunks(3).with_span_chunks(span_chunks(128))
    for other in (carried, recut):
        for name in ("span_first_chunk", "rb_first_span", "chunk_by_cb",
                     "col_span_first_chunk", "cb_first_span"):
            assert torch.equal(getattr(built, name), getattr(other, name)), name
    assert built.with_span_chunks(3).n_col_spans > built.n_col_spans


# -- B8: the numpy model of the two passes -----------------------------------

def hits_span_model(layout: BucketedEdges, auth, hub, pad_skip=True):
    """(hub_raw, auth_raw) in float64 by the kernel's passes: a window per
    row span and per column span, then each block's touched windows
    summed. ``pad_skip=False`` drops the padding test, the trap the auth
    side must avoid (hub must then cover (n_row_blocks + 1) * W)."""
    W, C = layout.window, layout.chunk
    row = layout.row_local.numpy()
    col = layout.col_local.numpy()
    rb = layout.chunk_rb.numpy()
    cb = layout.chunk_cb.numpy()
    n_rs, n_cs = layout.n_spans, layout.n_col_spans
    partial = np.zeros((n_rs + n_cs, W))
    touched = np.zeros(n_rs + n_cs, bool)
    spans = [(s, ch, False) for s in range(n_rs)
             for ch in range(int(layout.span_first_chunk[s]),
                             int(layout.span_first_chunk[s + 1]))]
    by_cb = layout.chunk_by_cb.numpy()
    cfirst = layout.col_span_first_chunk.numpy()
    spans += [(n_rs + s, int(by_cb[i]), True) for s in range(n_cs)
              for i in range(cfirst[s], cfirst[s + 1])]
    for s, ch, by_col in spans:
        sl = slice(ch * C, (ch + 1) * C)
        real = row[sl] != W if pad_skip else np.ones(C, bool)
        r, c = row[sl][real], col[sl][real]
        if by_col:
            m, at = hub[rb[ch] * W + r].astype(np.float64), c
        else:
            m, at = auth[cb[ch] * W + c].astype(np.float64), r
        nz = m != 0  # zero messages are not added
        np.add.at(partial[s], at[nz], m[nz])
        touched[s] |= bool(nz.any())
    out = []
    for first, off, n_blocks in ((layout.rb_first_span.numpy(), 0,
                                  layout.n_row_blocks),
                                 (layout.cb_first_span.numpy(), n_rs,
                                  layout.n_col_blocks)):
        y = np.zeros(n_blocks * W)
        for b in range(n_blocks):
            for s in range(off + first[b], off + first[b + 1]):
                if touched[s]:
                    y[b * W:(b + 1) * W] += partial[s]
        out.append(y[: layout.n_vertices])
    return tuple(out)


def hits_inputs(V, seed):
    rng = np.random.default_rng(seed)
    auth = rng.standard_normal(V).astype(np.float32)  # mixed sign, zeros
    auth[rng.random(V) < 0.2] = 0.0
    hub = rng.random(V).astype(np.float32)
    return auth, hub


@pytest.mark.parametrize("p", [None, 3])
@pytest.mark.parametrize("case", CASES)
def test_hits_span_model_matches_plain(case, p):
    layout = layout_of(case)
    if p is not None:
        layout = layout.with_span_chunks(p)
    auth, hub = hits_inputs(layout.n_vertices, 31)
    want = hits_fused_pass_plain(layout, torch.from_numpy(auth),
                                 torch.from_numpy(hub))
    got = hits_span_model(layout, auth, hub)
    for g, w in zip(got, want):  # float64 model, f32 plain: rtol 1e-5
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=1e-5)
    # the wrapper on the CPU is the plain version; edgeless gives zeros
    for g, w in zip(hits_fused_pass(layout, torch.from_numpy(auth),
                                    torch.from_numpy(hub)), want):
        assert torch.equal(g, w)


def test_hits_span_model_matches_jax():
    """rtol 1e-4 against the JAX kernel in interpret mode (bf16 hi+lo)."""
    rows, cols, _ = skewed(17, 300, 2500)
    ones = np.ones(rows.size, np.float32)
    jl = j_build_layout(rows, cols, ones, 300, window=128, chunk=128)
    layout = carry(jl).with_span_chunks(2)
    rng = np.random.default_rng(16)
    auth = rng.random(300).astype(np.float32)
    hub = rng.random(300).astype(np.float32)
    want = j_hits_fused_pass(jl, jnp.asarray(auth), jnp.asarray(hub),
                             interpret=True)
    for g, w in zip(hits_span_model(layout, auth, hub), want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)


def test_hits_padding_trap():
    """Padding slots carry row_local == W and col_local == 0. A column-span
    pass that does not skip them by the row sentinel adds hub[(rb+1)*W]
    into auth_raw[cb*W]: phantom mass the model with the test has not."""
    layout = layout_of("small")
    W = layout.window
    pad = layout.row_local == W
    assert bool(pad.any()) and bool((layout.col_local[pad] == 0).all())
    V = layout.n_vertices
    auth = np.zeros(V, np.float32)
    hub = np.ones((layout.n_row_blocks + 1) * W, np.float32)
    _, good = hits_span_model(layout, auth, hub[:V])
    _, bad = hits_span_model(layout, auth, hub, pad_skip=False)
    want = hits_fused_pass_plain(layout, torch.from_numpy(auth),
                                 torch.from_numpy(hub[:V]))[1].numpy()
    np.testing.assert_allclose(good, want, rtol=1e-6)
    heads = np.arange(0, V, W)
    assert (bad[heads] > want[heads]).any()
    np.testing.assert_array_equal(bad[np.setdiff1d(np.arange(V), heads)],
                                  good[np.setdiff1d(np.arange(V), heads)])


# -- B5: the numpy model of the (span, K tile) passes ------------------------

def can_send(v, nonzero_row, nonfinite_row):
    """The kernel's skip test: a slot sends only if its messages can be
    other than +-0."""
    return ((nonzero_row | ~np.isfinite(v))
            & ((v != 0) | nonfinite_row))


def spmm_span_model(layout: BucketedEdges, x, active, out_mask, kt):
    """Y in float64 by the kernel's passes: per (span, K tile) a W x kt
    window over the span's active chunks, the slots can_send keeps, then
    the window's nonzero entries added into Y."""
    W, C = layout.window, layout.chunk
    V, K = x.shape
    ch_act = chunk_activity_plain(
        layout, torch.from_numpy(active),
        None if out_mask is None else torch.from_numpy(out_mask))[0].numpy()
    nonzero_row = (x != 0).any(axis=1)
    nonfinite_row = ~np.isfinite(x).all(axis=1)
    row = layout.row_local.numpy()
    col = layout.col_local.numpy()
    val = layout.values.numpy()
    rb = layout.chunk_rb.numpy()
    cb = layout.chunk_cb.numpy()
    first = layout.span_first_chunk.numpy()
    y = np.zeros((layout.n_row_blocks * W, K))
    for s in range(layout.n_spans):
        chunks = [ch for ch in range(first[s], first[s + 1]) if ch_act[ch]]
        if not chunks:
            continue
        for k0 in range(0, K, kt):
            ks = slice(k0, min(k0 + kt, K))
            win = np.zeros((W, ks.stop - k0))
            for ch in chunks:
                sl = slice(ch * C, (ch + 1) * C)
                r, c, v = row[sl], col[sl], val[sl]
                real = r != W
                xi = cb[ch] * W + c[real]
                keep = can_send(v[real], nonzero_row[xi], nonfinite_row[xi])
                m = (v[real][keep].astype(np.float64)[:, None]
                     * x[xi[keep], ks].astype(np.float64))
                m[m == 0] = 0.0  # zero messages are not added
                np.add.at(win, r[real][keep], m)
            base = rb[first[s]] * W
            y[base:base + W, ks] += np.where(win != 0, win, 0.0)
    return y[:V]


def spmm_inputs(V, K, kind, seed, p_active):
    rng = np.random.default_rng(seed)
    active = rng.random(V) < p_active
    out_mask = rng.random(V) < 0.5
    if kind == "float":  # nonzero off the frontier too: active chunks'
        x = rng.standard_normal((V, K)).astype(np.float32)  # inactive rows count
    else:
        x = np.eye(K, dtype=np.float32)[rng.integers(0, K, V)]
        if kind == "signed":
            x *= rng.integers(-1, 2, (V, 1)).astype(np.float32)
        x = np.where(active[:, None], x, 0.0).astype(np.float32)
    return x, active, out_mask


@pytest.mark.parametrize("front", [1.0, 0.1, 0.0])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["one-hot", "signed", "float"])
@pytest.mark.parametrize("K", [1, 8, 33])
def test_spmm_span_model_matches_plain(K, kind, masked, front):
    """0/1 values with one-hot or signed one-hot X: exact; float X: rtol
    1e-5 of the f32 plain sum. K = 33 is no multiple of the K tile (8 at
    W=2048; 32 here at W=128, and 4 below)."""
    layout = layout_of("small", "01" if kind != "float" else "signed")
    V = layout.n_vertices
    x, active, out_mask = spmm_inputs(V, K, kind, 40 + K, front)
    om = out_mask if masked else None
    want = bucketed_spmm_sparse_plain(
        layout, torch.from_numpy(x), torch.from_numpy(active),
        None if om is None else torch.from_numpy(om)).numpy()
    for kt in sorted({k_tile(K, layout.window), 4}):
        got = spmm_span_model(layout.with_span_chunks(3), x, active, om, kt)
        if kind == "float":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)
    if front == 0.0:
        assert (want == 0).all()
    if kind == "signed" and front == 1.0:
        assert (want < 0).any() and (want > 0).any()


@pytest.mark.parametrize("case", ["odd_chunk", "w4096_c1024",
                                  "empty_col_block", "edgeless"])
def test_spmm_span_model_other_layouts(case):
    layout = layout_of(case, "signed")
    V = layout.n_vertices
    x, active, om = spmm_inputs(V, 12, "float", 50, 0.3)
    want = bucketed_spmm_sparse_plain(
        layout, torch.from_numpy(x), torch.from_numpy(active),
        torch.from_numpy(om)).numpy()
    got = spmm_span_model(layout, x, active, om, k_tile(12, layout.window))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the wrapper on the CPU is the plain version
    assert np.array_equal(bucketed_spmm_sparse(
        layout, torch.from_numpy(x), torch.from_numpy(active),
        torch.from_numpy(om)).numpy(), want)


@pytest.mark.parametrize("exact", [True, False])
def test_spmm_span_model_matches_jax(exact):
    """Against the JAX kernel in interpret mode: exact for signed one-hot
    deltas over 0/1 values; rtol 1e-4 for positive floats (the JAX
    kernel's bf16 hi+lo split keeps ~16 bits of each term, so its sums are
    held relative to their size only where terms do not cancel, as in
    test_torch_kernels.py)."""
    rows, cols, vals = skewed(23, 300, 2500, values="01" if exact else "float")
    jl = j_build_layout(rows, cols, vals, 300, window=128, chunk=128)
    layout = carry(jl).with_span_chunks(2)
    x, active, om = spmm_inputs(300, 8, "signed", 24, 0.3)
    if not exact:
        x = np.random.default_rng(25).random((300, 8)).astype(np.float32)
    x = np.where(active[:, None], x, 0.0).astype(np.float32)
    want = np.asarray(j_spmm_sparse(jl, jnp.asarray(x), jnp.asarray(active),
                                    interpret=True, out_mask=jnp.asarray(om),
                                    exact=exact))
    got = spmm_span_model(layout, x, active, om, 4)
    if exact:
        np.testing.assert_array_equal(got[om], want[om])
    else:
        np.testing.assert_allclose(got[om], want[om], rtol=1e-4, atol=1e-5)


def test_spmm_skip_keeps_nonfinite_messages():
    """The skip test drops only slots whose messages are all +-0: a value
    of 0 over a row holding inf, or an inf value over a zero row, still
    sends NaN, as the plain version computes it."""
    layout = layout_of("small", "01")
    V = layout.n_vertices
    vals = layout.values.clone()
    vals[layout.row_local != layout.window] = 0.0
    zero_vals = BucketedEdges(**{**layout.__dict__, "values": vals})
    x = np.zeros((V, 4), np.float32)
    x[layout.chunk_cb[0] * layout.window + layout.col_local[0]] = np.inf
    active = np.ones(V, bool)
    want = bucketed_spmm_sparse_plain(zero_vals, torch.from_numpy(x),
                                      torch.from_numpy(active)).numpy()
    got = spmm_span_model(zero_vals, x, active, None, 4)
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    assert not can_send(np.float32([0.0]), np.array([True]),
                        np.array([False]))[0]
    assert can_send(np.float32([np.inf]), np.array([False]),
                    np.array([False]))[0]


def test_k_tile():
    """Kt holds all K columns where the W x Kt window fits K_TILE_BYTES,
    else the largest that fits: 8 at W=2048, 4 at W=4096."""
    assert [k_tile(k, 2048) for k in (1, 2, 3, 8, 32, 33, 512)] == [
        1, 2, 4, 8, 8, 8, 8]
    assert [k_tile(k, 128) for k in (1, 5, 32, 33, 512)] == [1, 8, 32, 32, 32]
    assert k_tile(32, 4096) == 4 and k_tile(32, 65536) == 1
    for w in (128, 2048, 4096):
        for k in (1, 7, 64, 512):
            kt = k_tile(k, w)
            assert kt in K_TILES and 4 * w * kt <= K_TILE_BYTES


def test_pull_probe_counts_greedy_passes(capsys):
    """The pull probe's --greedy line on the CPU: one entry per B5 pass of
    the timed greedy coloring, the first pass over every chunk of the
    layout (every row changed), no pass over more."""
    import json

    from gunrock_tpu_torch.probes import pull

    assert pull.main(["--scale", "8", "--device", "cpu", "--num_runs", "1",
                      "--greedy"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    line = rows[-1]
    assert line["case"] == "greedy_passes"
    n = line["iterations"]
    assert n >= 2 and len(line["active_chunks"]) == n
    assert line["active_chunks"][0] == line["n_chunks"]
    assert max(line["active_chunks"]) <= line["n_chunks"]
    assert line["changed_rows"][0] == 256
    assert all(z <= c for z, c in zip(line["nonzero_x_rows"],
                                      line["changed_rows"]))
    assert line["active_chunks_sum"] == sum(line["active_chunks"])
