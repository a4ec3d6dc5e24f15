"""The rest of the PyTorch port's data layer against the JAX package's, on
the CPU: the generators (the same COO arrays, bit for bit, and the
vendored family files rebuilt), ``rcm_sort``, the .smtx loader and
``load_graph_file``'s .smtx branch, ``extract_dataset``, the format
helpers, ``build_graph_from_arrays``, ``View``, the error and print
helpers, ``interop.as_device_array`` and the ``csr_binary`` tool.

Tolerances: everything is exact except the vendored files' values, which
the files hold to six decimals (5e-7, and float32 rounding on reading)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import gunrock_tpu.formats as jformats
import gunrock_tpu.io.generators as jgen
from gunrock_tpu.graph import build_graph_from_arrays as j_build_from_arrays
from gunrock_tpu.graph.reorder import rcm_sort as j_rcm_sort
from gunrock_tpu.io.loader import extract_dataset as j_extract_dataset
from gunrock_tpu.io.smtx import load_smtx as j_load_smtx

import gunrock_tpu_torch.formats as tformats
import gunrock_tpu_torch.io.generators as tgen
from gunrock_tpu_torch.graph import (
    View,
    build_graph,
    build_graph_from_arrays,
)
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.graph.reorder import rcm_sort
from gunrock_tpu_torch.io import load_graph_file, load_matrix_market, load_smtx
from gunrock_tpu_torch.io.loader import extract_dataset, is_smtx

ROOT = Path(__file__).resolve().parent.parent
DATASETS = ROOT / "datasets"
COO_FIELDS = ("row_indices", "col_indices", "values")

# (generator, positional args, keyword args): small sizes, and sbm_coo
# with more blocks than vertices hold, so that some are empty (block 0
# among them for seeds 3 and 11)
GENERATORS = [
    ("uniform_random_coo", (300,), {}),
    ("uniform_random_coo", (200, 4), {"weighted": False}),
    ("delaunay_coo", (512,), {}),
    ("delaunay_coo", (97,), {"weighted": False}),
    ("sbm_coo", (600, 8, 16, 0.1), {}),
    ("sbm_coo", (40, 64), {}),
    ("sbm_coo", (300, 4, 8, 0.5), {"weighted": False}),
    ("bipartite_coo", (50, 70), {}),
    ("bipartite_coo", (64, 16, 3), {"weighted": False}),
]


def _same_coo(j, t):
    assert (j.n_rows, j.n_cols) == (t.n_rows, t.n_cols)
    for k in COO_FIELDS:
        a, b = getattr(j, k), getattr(t, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("name,args,kw", GENERATORS)
def test_generator_coo_bit_equal(name, args, kw, seed):
    _same_coo(getattr(jgen, name)(*args, seed=seed, **kw),
              getattr(tgen, name)(*args, seed=seed, **kw))


def test_sbm_with_an_empty_block_and_delaunay_512():
    """The two cases the JAX tests lean on: an SBM whose first community
    is empty (its draws go to block 0) and the 512-point mesh."""
    block = np.random.default_rng(1).integers(0, 64, 40)
    assert 0 not in block  # community 0 is empty at this seed
    _same_coo(jgen.sbm_coo(40, 64, seed=1), tgen.sbm_coo(40, 64, seed=1))
    _same_coo(jgen.delaunay_coo(512, seed=3), tgen.delaunay_coo(512, seed=3))


@pytest.mark.parametrize("seed", [0, 5])
def test_generate_points_bit_equal(seed):
    j = jgen.generate_points(257, seed=seed, box=3.5)
    t = tgen.generate_points(257, seed=seed, box=3.5)
    assert j.dtype == t.dtype == np.float32
    np.testing.assert_array_equal(j, t)


GRAPHS = [
    ("uniform_graph", (300,), {"seed": 2}),
    ("delaunay_graph", (512,), {"seed": 3}),
    ("sbm_graph", (400, 8), {"seed": 1}),
    ("bipartite_graph", (60, 40), {"seed": 4}),
]


def _same_graph(jg, tg):
    assert (jg.n_vertices, jg.n_edges) == (tg.n_vertices, tg.n_edges)
    assert jg.properties.directed == tg.properties.directed
    assert jg.properties.symmetric == tg.properties.symmetric
    assert jg.properties.weighted == tg.properties.weighted
    for k in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(jg, k)),
                                      getattr(tg, k).numpy(), err_msg=k)


@pytest.mark.parametrize("name,args,kw", GRAPHS)
def test_generator_graphs_equal(name, args, kw):
    _same_graph(getattr(jgen, name)(*args, **kw),
                getattr(tgen, name)(*args, device="cpu", **kw))


@pytest.mark.parametrize("name", ["uniform_graph", "delaunay_graph",
                                  "sbm_graph", "bipartite_graph"])
def test_generator_graphs_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    args = (40, 40) if name == "bipartite_graph" else (64,)
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(tgen, name)(*args)


# the vendored files and the generate.py arguments that built them
# (datasets/regression.py FAMILIES; generate.py's defaults otherwise)
VENDORED = [
    ("delaunay2k.mtx", lambda: tgen.delaunay_coo(2048, seed=0)),
    ("sbm2k.mtx", lambda: tgen.sbm_coo(2048, 16, 16, 0.05, seed=0)),
    ("bipartite2k.mtx", lambda: tgen.bipartite_coo(1024, 1024, 8, seed=0)),
]


@pytest.mark.parametrize("fname,make", VENDORED)
def test_generators_rebuild_the_vendored_files(fname, make):
    props, coo = load_matrix_market(DATASETS / fname)
    from_file = build_graph(tformats.coo_to_csr(coo), props, device="cpu")
    built = build_graph(tformats.coo_to_csr(make()), props, device="cpu")
    assert (from_file.n_vertices, from_file.n_edges) == \
        (built.n_vertices, built.n_edges)
    for k in ("row_offsets", "col_indices", "csc_offsets", "csc_rows"):
        torch.testing.assert_close(from_file.host[k], built.host[k],
                                   rtol=0, atol=0, check_dtype=True)
    # the file holds six decimals (half a unit: 5e-7), read back into
    # float32 (half an ulp: 2^-24 relative, allowed as 2^-23)
    np.testing.assert_allclose(from_file.host["values"], built.host["values"],
                               rtol=2.0**-23, atol=5e-7)


@pytest.mark.parametrize("kind", ["delaunay", "rmat", "bipartite"])
def test_rcm_sort_matches_jax(kind):
    """The same order and rank as the JAX relabeling, on a symmetric mesh
    and on two directed graphs, and the same relabeled graph."""
    if kind == "delaunay":
        jg, tg = jgen.delaunay_graph(512, seed=3), tgen.delaunay_graph(
            512, seed=3, device="cpu")
    elif kind == "rmat":
        jg, tg = jgen.rmat_graph(8, seed=2), tgen.rmat_graph(8, seed=2,
                                                             device="cpu")
    else:
        jg, tg = jgen.bipartite_graph(60, 40, seed=4), tgen.bipartite_graph(
            60, 40, seed=4, device="cpu")
    jg2, jro = j_rcm_sort(jg)
    tg2, tro = rcm_sort(tg)
    np.testing.assert_array_equal(jro.order, tro.order)
    np.testing.assert_array_equal(jro.rank, tro.rank)
    assert tro.order.dtype == tro.rank.dtype == np.int32
    np.testing.assert_array_equal(tro.rank[tro.order], np.arange(tg.n_vertices))
    _same_graph(jg2, tg2)
    assert tg2.properties == tg.properties and tg2.device == tg.device


SMTX = "% a comment\n\n{header}\n0 2 3 3 5\n1 2 0 0 3\n"


@pytest.mark.parametrize("header", ["4 4 5", "4, 4, 5", "4,4,5"])
def test_load_smtx_matches_jax(tmp_path, header):
    path = tmp_path / "g.smtx"
    path.write_text(SMTX.format(header=header))
    j, t = j_load_smtx(path, seed=7), load_smtx(path, seed=7)
    assert (j.n_rows, j.n_cols, j.nnz) == (t.n_rows, t.n_cols, t.nnz) == (4, 4, 5)
    for k in ("row_offsets", "col_indices", "values"):
        a, b = getattr(j, k), getattr(t, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_load_smtx_first_line_csv_flag(tmp_path):
    path = tmp_path / "g.smtx"
    path.write_text(SMTX.format(header="4 4 5"))
    t = load_smtx(path, first_line_csv=True)
    np.testing.assert_array_equal(t.row_offsets, [0, 2, 3, 3, 5])


@pytest.mark.parametrize("text", ["4 4 5\n0 2 3 3 5\n",
                                  "4 4 5\n0 2 3 5\n1 2 0 0 3\n",
                                  "4 4 5\n0 2 3 3 5\n1 2 0\n"])
def test_load_smtx_rejects_bad_files(tmp_path, text):
    """A truncated file and inconsistent dimensions raise ValueError, in
    both packages."""
    path = tmp_path / "bad.smtx"
    path.write_text(text)
    with pytest.raises(ValueError):
        j_load_smtx(path)
    with pytest.raises(ValueError):
        load_smtx(path)


def test_load_graph_file_smtx(tmp_path):
    path = tmp_path / "g.smtx"
    path.write_text(SMTX.format(header="4, 4, 5"))
    g, props = load_graph_file(path, device="cpu")
    assert props.directed and props.weighted
    assert (g.n_vertices, g.n_edges) == (4, 5)
    np.testing.assert_array_equal(g.host["row_offsets"], [0, 2, 3, 3, 5])
    np.testing.assert_array_equal(g.host["values"], load_smtx(path).values)
    assert is_smtx(path) and not is_smtx(DATASETS / "chesapeake.mtx")


@pytest.mark.parametrize("name", ["chesapeake.mtx", "web.mtx.gz", "g.smtx",
                                  "cache.csr", "m.mm", "plain", "a.mtx.csr"])
def test_extract_dataset_matches_jax(name):
    assert extract_dataset(name) == j_extract_dataset(name)


def test_format_helpers_match_jax():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 9, 40).astype(np.int32)
    cols = rng.integers(0, 7, 40).astype(np.int32)
    vals = rng.random(40).astype(np.float32)
    j = jformats.coo_to_csc(jformats.Coo(9, 7, rows, cols, vals))
    t = tformats.coo_to_csc(tformats.Coo(9, 7, rows, cols, vals))
    for k in ("col_offsets", "row_indices", "values"):
        np.testing.assert_array_equal(getattr(j, k), getattr(t, k), err_msg=k)
    seg = np.sort(rng.integers(0, 6, 30))
    jo = jformats.formats.indices_to_offsets(seg, 8)
    to = tformats.indices_to_offsets(seg, 8)
    assert jo.dtype == to.dtype == np.int32
    np.testing.assert_array_equal(jo, to)
    np.testing.assert_array_equal(tformats.offsets_to_indices(to), seg)
    csr = tformats.coo_to_csr(tformats.Coo(9, 7, rows, cols, vals))
    jc = jformats.csr_to_coo(jformats.coo_to_csr(jformats.Coo(9, 7, rows,
                                                              cols, vals)))
    tc = tformats.csr_to_coo(csr)
    assert (jc.n_rows, jc.n_cols) == (tc.n_rows, tc.n_cols)
    for k in COO_FIELDS:
        np.testing.assert_array_equal(getattr(jc, k), getattr(tc, k),
                                      err_msg=k)


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_build_graph_from_arrays_matches_jax(order):
    rng = np.random.default_rng(9)
    V = 20
    deg = rng.integers(0, 5, V)
    offsets = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    cols = np.concatenate([np.sort(rng.choice(V, d, replace=False))
                           for d in deg]).astype(np.int32)
    vals = rng.random(cols.size).astype(np.float32)
    if order == "unsorted":  # each row's columns reversed
        for v in range(V):
            a, b = offsets[v], offsets[v + 1]
            cols[a:b], vals[a:b] = cols[a:b][::-1].copy(), vals[a:b][::-1].copy()
    jg = j_build_from_arrays(V, offsets, cols, vals)
    tg = build_graph_from_arrays(V, offsets, cols, vals, device="cpu")
    _same_graph(jg, tg)
    jg1 = j_build_from_arrays(V, offsets, cols)
    tg1 = build_graph_from_arrays(V, offsets, cols, device="cpu")
    _same_graph(jg1, tg1)
    assert bool((tg1.values == 1.0).all())


def test_view_flags_match_jax():
    from gunrock_tpu.graph import View as JView

    assert [m.name for m in View] == [m.name for m in JView]
    both = View.CSR | View.CSC
    assert View.CSR in both and View.COO not in both


def test_throw_if_exception():
    from gunrock_tpu_torch.utils.error import GunrockError, throw_if_exception

    throw_if_exception(False, "never")
    with pytest.raises(GunrockError, match="no progress"):
        throw_if_exception(True, "no progress")
    with pytest.raises(RuntimeError, match="runtime error"):
        throw_if_exception(True)


@pytest.mark.parametrize("k,name", [(10, ""), (3, "distances")])
def test_head_prints_the_jax_line(capsys, k, name):
    from gunrock_tpu.utils.print_utils import head as j_head
    from gunrock_tpu_torch.utils.print_utils import head

    vec = np.arange(12, dtype=np.int32) * 3
    j_head(vec, k, name)
    want = capsys.readouterr().out
    head(torch.from_numpy(vec), k, name)
    assert capsys.readouterr().out == want
    head(vec, k, name)
    assert capsys.readouterr().out == want


def test_as_device_array():
    """No copy for a contiguous tensor already on the device (the same
    data_ptr), nor for a contiguous writable array on the CPU; one packed
    copy otherwise; read-only arrays copied; other types refused."""
    from gunrock_tpu_torch.interop import as_device_array

    t = torch.arange(10, dtype=torch.float32)
    assert as_device_array(t, device="cpu").data_ptr() == t.data_ptr()
    a = np.arange(6, dtype=np.int32)
    got = as_device_array(a, device="cpu")
    assert got.data_ptr() == a.ctypes.data and got.dtype == torch.int32
    strided = as_device_array(t[::3], device="cpu")
    assert strided.is_contiguous() and strided.tolist() == [0.0, 3.0, 6.0, 9.0]
    ro = np.arange(4.0)
    ro.setflags(write=False)
    got = as_device_array(ro, device="cpu")
    assert got.tolist() == [0.0, 1.0, 2.0, 3.0] and got.data_ptr() != ro.ctypes.data
    packed = as_device_array(np.arange(12).reshape(3, 4)[:, 1::2], device="cpu")
    assert packed.is_contiguous() and packed.tolist() == [[1, 3], [5, 7], [9, 11]]
    with pytest.raises(TypeError):
        as_device_array([1, 2, 3], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            as_device_array(t)


def test_csr_binary_round_trip(tmp_path, capsys):
    from gunrock_tpu_torch.examples import csr_binary

    out = tmp_path / "chesapeake.csr"
    csr_binary.main([str(DATASETS / "chesapeake.mtx"), str(out)])
    assert capsys.readouterr().out.strip() == \
        f"wrote {out}: 39 vertices, 340 edges"
    g, props = load_graph_file(out, device="cpu")
    ref, _ = load_graph_file(DATASETS / "chesapeake.mtx", device="cpu")
    for k in ("row_offsets", "col_indices", "values"):
        np.testing.assert_array_equal(g.host[k], ref.host[k], err_msg=k)
    # the cache the JAX package reads too
    from gunrock_tpu.formats import Csr as JCsr

    j = JCsr.read_binary(out)
    np.testing.assert_array_equal(j.col_indices, ref.host["col_indices"])
