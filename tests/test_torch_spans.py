"""The span table of the semiring pull (``layout.span_table``): every
chunk in exactly one span, spans in order, each inside one row block with
at most P chunks, and ``rb_first_span`` naming each row block's spans; over
the port's layouts, a layout carried over from the JAX package's arrays,
the edgeless layout, a layout of one row block, the W=128 edge shapes and
W=4096/C=1024. The span kernels themselves run only on the card
(``chip_smoke.py``); here a numpy model of their two passes (each span
reduced into its own window, the windows of a row block combined) must
give the plain version's result, exactly for max/min and within float64
rounding of the f32 plain sum for plus_times.
"""

import numpy as np
import pytest
import torch

from gunrock_tpu.ops.pallas.layout import build_bucketed_layout as j_build_layout

from gunrock_tpu_torch.graph import build_graph
from gunrock_tpu_torch.formats import Coo
from gunrock_tpu_torch.ops.kernels.layout import (
    DATA_FIELDS,
    META_FIELDS,
    SPAN_SLOTS,
    BucketedEdges,
    build_bucketed_layout,
    pull_layout,
    span_chunks,
    span_table,
)
from gunrock_tpu_torch.ops.kernels.semiring import (
    MAX_WINDOW,
    bucketed_semiring_spmv_plain,
    check_window,
)


def skewed(seed, n_vertices, n_edges, power=2):
    """Edges whose rows crowd the first windows, as a degree-sorted graph's
    do, so the first row blocks own many chunks."""
    rng = np.random.default_rng(seed)
    rows = (n_vertices * rng.random(n_edges) ** power).astype(np.int32)
    cols = rng.integers(0, n_vertices, n_edges).astype(np.int32)
    vals = (rng.random(n_edges) + 0.1).astype(np.float32)
    return rows, cols, vals


def layout_of(case) -> BucketedEdges:
    if case == "port_small":  # V=300 runs past the last window
        return build_bucketed_layout(*skewed(1, 300, 2500), 300, window=128,
                                     chunk=128, device="cpu")
    if case == "port_pull":
        rows, cols, vals = skewed(2, 700, 9000)
        g = build_graph(Coo(700, 700, rows, cols, vals), device="cpu")
        return pull_layout(g, window=128, chunk=128)
    if case == "jax_carried":
        jl = j_build_layout(*skewed(3, 300, 2500), 300, window=128, chunk=128)
        return BucketedEdges.from_arrays(
            {k: np.asarray(getattr(jl, k)) for k in DATA_FIELDS},
            **{k: getattr(jl, k) for k in META_FIELDS}, device="cpu")
    if case == "edgeless":
        e = np.zeros(0, np.int32)
        return build_bucketed_layout(e, e, e.astype(np.float32), 50,
                                     window=128, chunk=128, device="cpu")
    if case == "one_row_block":
        return build_bucketed_layout(*skewed(4, 100, 3000), 100, window=128,
                                     chunk=128, device="cpu")
    if case == "edge_shapes_w128":  # chip_smoke.py's edge shapes
        return build_bucketed_layout(*skewed(5, 1000, 20_000, 3), 1000,
                                     window=128, chunk=128, device="cpu")
    if case == "w4096_c1024":
        V = 3 * 4096 + 5
        return build_bucketed_layout(*skewed(6, V, 60_000), V, window=4096,
                                     chunk=1024, device="cpu")
    raise ValueError(case)


CASES = ["port_small", "port_pull", "jax_carried", "edgeless", "one_row_block",
         "edge_shapes_w128", "w4096_c1024"]


def check_table(layout: BucketedEdges, p: int) -> None:
    first = layout.span_first_chunk.numpy().astype(np.int64)
    rb_first = layout.rb_first_span.numpy().astype(np.int64)
    rb = layout.chunk_rb.numpy()
    n_spans = layout.n_spans
    assert layout.span_first_chunk.dtype == torch.int32
    assert layout.rb_first_span.dtype == torch.int32
    # every chunk in exactly one span, spans in order and not empty
    assert first[0] == 0 and first[-1] == layout.n_chunks
    lengths = np.diff(first)
    assert (lengths >= 1).all() and (lengths <= p).all()
    # each span in one row block
    if n_spans:
        assert (rb[first[:-1]] == rb[first[1:] - 1]).all()
    # rb_first_span names each row block's spans, as few as P allows
    assert rb_first.shape == (layout.n_row_blocks + 1,)
    assert rb_first[0] == 0 and rb_first[-1] == n_spans
    assert (np.diff(rb_first) >= 0).all()
    chunks_per_rb = np.bincount(rb, minlength=layout.n_row_blocks)
    np.testing.assert_array_equal(np.diff(rb_first), -(-chunks_per_rb // p))
    for b in range(layout.n_row_blocks):
        spans = np.arange(rb_first[b], rb_first[b + 1])
        assert (rb[first[spans]] == b).all()


@pytest.mark.parametrize("case", CASES)
def test_span_table(case):
    layout = layout_of(case)
    check_table(layout, span_chunks(layout.chunk))


@pytest.mark.parametrize("p", [1, 3, 64])
def test_span_table_at_other_p(p):
    layout = layout_of("edge_shapes_w128").with_span_chunks(p)
    check_table(layout, p)
    if p == 1:
        assert layout.n_spans == layout.n_chunks


def test_span_chunks_at_the_port_shapes():
    """P = 32 at C = 256 and 8 at C = 1024: about SPAN_SLOTS slots each."""
    assert span_chunks(256) == 32 and span_chunks(1024) == 8
    assert span_chunks(128) == 64 and span_chunks(SPAN_SLOTS * 2) == 1
    layout = layout_of("edge_shapes_w128")
    # the skewed rows give the first row block several spans
    assert int(layout.rb_first_span[1]) > 1 or layout.n_chunks <= 64


def test_span_table_refuses_unsorted_chunks():
    with pytest.raises(ValueError, match="sorted"):
        span_table(np.array([0, 1, 0], np.int32), 2, 4)
    with pytest.raises(ValueError, match="max_chunks"):
        span_table(np.array([0, 1], np.int32), 2, 0)


def test_check_window():
    for w in (128, 2048, 4096, MAX_WINDOW - MAX_WINDOW % 4):
        check_window(w)
    for w in (0, 130, MAX_WINDOW + 4, 1 << 16):
        with pytest.raises(ValueError, match="227 KB"):
            check_window(w)


def span_model(layout: BucketedEdges, x: np.ndarray, semiring: str):
    """The two passes in numpy: each span's messages reduced into a window
    of its own, then each row block's windows combined; the identity where
    no span reaches. float64 for plus_times."""
    W, C = layout.window, layout.chunk
    ident = {"plus_times": 0.0, "max_times": 0.0, "min_plus": np.inf}[semiring]
    red = {"plus_times": np.add, "max_times": np.maximum,
           "min_plus": np.minimum}[semiring]
    first = layout.span_first_chunk.numpy()
    rb_first = layout.rb_first_span.numpy()
    row = layout.row_local.numpy()
    col = layout.col_local.numpy()
    dtype = np.float64 if semiring == "plus_times" else np.float32
    val = layout.values.numpy().astype(dtype)
    y = np.full(layout.n_row_blocks * W, ident, dtype)
    partial = np.full((layout.n_spans, W), ident, dtype)
    for s in range(layout.n_spans):
        for ch in range(first[s], first[s + 1]):
            sl = slice(ch * C, (ch + 1) * C)
            real = row[sl] != W
            xs = x[int(layout.chunk_cb[ch]) * W + col[sl][real]].astype(dtype)
            m = val[sl][real] + xs if semiring == "min_plus" else val[sl][real] * xs
            if semiring == "max_times":
                m = np.where(m > 0, m, dtype(0))
            red.at(partial[s], row[sl][real], m)
    for b in range(layout.n_row_blocks):
        for s in range(rb_first[b], rb_first[b + 1]):
            y[b * W:(b + 1) * W] = red(y[b * W:(b + 1) * W], partial[s])
    return y[: layout.n_vertices]


@pytest.mark.parametrize("p", [None, 3])
@pytest.mark.parametrize("semiring", ["plus_times", "max_times", "min_plus"])
@pytest.mark.parametrize("case", ["port_small", "jax_carried", "edgeless"])
def test_span_model_matches_plain(case, semiring, p):
    layout = layout_of(case)
    if p is not None:
        layout = layout.with_span_chunks(p)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(layout.n_vertices).astype(np.float32)
    if semiring == "plus_times":
        x = np.abs(x)
    want = bucketed_semiring_spmv_plain(layout, torch.from_numpy(x),
                                        semiring).numpy()
    got = span_model(layout, x, semiring)
    if semiring == "plus_times":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:  # the same f32 messages, an order-free reduction
        np.testing.assert_array_equal(got, want)


def test_pull_probe_runs_on_cpu(capsys):
    """The pull probe's command end to end on the CPU (plain versions): one
    line per case, then the sweep's lines at each P and each K tile; no
    device time is claimed."""
    import json

    from gunrock_tpu_torch.probes import pull
    from gunrock_tpu_torch.probes.v5_floor import probe_graph

    assert pull.main(["--scale", "8", "--device", "cpu", "--num_runs", "1",
                      "--sweep", "2,64", "--k_tiles", "4"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    cases = ["b1_full", "b1_tenth", "b1_empty", "b3_pr", "b3_valued", "b3_min",
             "b8_hits", "b5_color", "b5_color_tenth", "b5_float", "b5_spgemm",
             "b5_spgemm_hub"]
    assert [r["case"] for r in rows[:12]] == cases
    swept = ["b3_valued", "b3_pr", "b1_full", "b8_hits", "b5_color"]
    assert [r["case"] for r in rows[12:22]] == swept * 2
    assert [r.get("span_chunks") for r in rows[12:22]] == [2] * 5 + [64] * 5
    layouts = pull.build_layouts(probe_graph(8, "cpu"))
    assert [r["n_spans"] for r in rows[12:17]] == [
        layouts[k].with_span_chunks(2).n_spans
        for k in ("valued", "pr", "unit", "hits")] + [
        layouts["color"][0].with_span_chunks(2).n_spans]
    assert [(r["case"], r["k_tile"]) for r in rows[22:]] == [
        ("b5_color", 4), ("b5_float", 4), ("b5_spgemm", 4)]
    assert all(r["device_ms"] == "not measured" for r in rows)
    assert all("sparse_mm_ms" in r and "sparse_mm_two_calls_ms" in r
               for r in rows if r["case"] == "b8_hits")
    assert all("plain_ms" in r and "sparse_mm_ms" in r
               for r in rows if r["case"].startswith("b5_spgemm"))
