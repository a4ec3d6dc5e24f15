"""The port's native host IO (``gunrock_tpu_torch/_native``: the mmap
Matrix Market parser and the counting sort) on the CPU.

The port's two parse paths (native, and numpy with ``_load_native``
switched off) return the same properties and COO arrays bit for bit on
every file either accepts, and both raise ``MatrixMarketError`` on a
malformed one. Against the JAX package's Python path the COO arrays are
equal too; against the JAX native parser the edge sets are (it puts each
mirror next to its entry). The counting sort equals ``np.lexsort`` and the
JAX native sort, and graphs built with the native code on and off are
bit-equal. Everything here is exact."""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import gunrock_tpu._native as jnative
import gunrock_tpu.io.matrix_market as jmm

import gunrock_tpu_torch._native as tnative
import gunrock_tpu_torch.formats.formats as tformats
import gunrock_tpu_torch.io.matrix_market as tmm
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.io.generators import rmat_graph
from gunrock_tpu_torch.io.loader import load_graph_file

ROOT = Path(__file__).resolve().parent.parent
DATASETS = sorted((ROOT / "datasets").glob("*.mtx"))
COO_FIELDS = ("row_indices", "col_indices", "values")


@pytest.fixture(autouse=True)
def native_library():
    """Skip where there is no C++ compiler: the numpy paths alone run."""
    if not tnative.available():
        pytest.skip("no C++ compiler to build the native library")


@pytest.fixture
def jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's native library is unavailable")


H = "%%MatrixMarket matrix coordinate"

# files both paths read; (name, bytes)
VALID = {
    "general": f"{H} real general\n% a comment\n4 4 5\n1 2 1.5\n2 3 -2.25\n"
               "3 1 0.5\n4 4 3\n1 4 7\n",
    "symmetric": f"{H} real symmetric\n4 4 4\n2 1 1.5\n3 1 2\n3 3 4\n4 2 0.25\n",
    "hermitian": f"{H} real hermitian\n3 3 3\n2 1 1\n3 2 2\n1 1 9\n",
    "skew": f"{H} real skew-symmetric\n3 3 2\n2 1 1.5\n3 1 -2\n",
    "pattern": f"{H} pattern general\n3 3 3\n1 2\n2 3\n3 1\n",
    "pattern_symmetric": f"{H} pattern symmetric\n4 4 3\n2 1\n3 2\n4 4\n",
    "integer": f"{H} integer general\n3 3 3\n1 2 5\n2 3 -7\n3 3 0\n",
    "integer_symmetric": f"{H} integer symmetric\n3 3 2\n2 1 3\n3 1 4\n",
    "upper_case_banner": "%%MatrixMarket MATRIX Coordinate REAL General\n2 2 1\n1 2 3\n",
    "crlf": f"{H} real general\r\n% c\r\n3 3 2\r\n1 2 1.5\r\n3 1 2.5\r\n",
    "cr_only": f"{H} real general\r3 3 2\r1 2 1.5\r3 1 2.5\r",
    "tabs": f"{H} real general\n3\t3 2 \n\t1\t2\t1.5  \n 3 1  2.5\t\n",
    "no_final_newline": f"{H} real general\n3 3 2\n1 2 1.5\n3 1 2.5",
    "exponents": f"{H} real general\n3 3 6\n1 2 1e3\n1 3 -1.5E-3\n2 1 +2.5e+2\n"
                 "2 3 .5\n3 1 5.\n3 2 -0\n",
    "float_ties": f"{H} real general\n4 4 8\n1 1 1.00000005960464477539062\n"
                  "1 2 1.0000001788139343\n1 3 16777217\n1 4 0.1\n"
                  "2 1 3.4028235e38\n2 2 3.5e38\n2 3 1e-45\n2 4 7e-46\n",
    "specials": f"{H} real general\n3 3 6\n1 1 inf\n1 2 -Infinity\n1 3 nan\n"
                "2 1 -NaN\n2 2 1e400\n2 3 1e-400\n",
    "long_tokens": f"{H} real general\n2 2 3\n1 1 0.1000000000000000000000000001\n"
                   f"1 2 {'1' * 40}e-39\n2 2 0.{'0' * 150}1e150\n",
    "float_indices": f"{H} real general\n3 3 3\n1.0 2e0 1\n2.9 1 2\n3 +1.5 3\n",
    "duplicate_symmetric": f"{H} real symmetric\n3 3 4\n2 1 1\n2 1 2\n3 3 5\n"
                           "3 2 7\n",
    "two_column_real": f"{H} real general\n3 3 2\n1 2\n3 1\n",
    "four_columns": f"{H} real general\n3 3 2\n1 2 1.5 9\n3 1 2.5 9\n",
    "pattern_with_values": f"{H} pattern general\n3 3 2\n1 2 1.5\n3 1 2.5\n",
    "empty": f"{H} real general\n5 5 0\n",
    "empty_symmetric": f"{H} pattern symmetric\n4 4 0\n",
    "hash_comments": f"{H} real general\n3 3 2\n1 2 1.5 # one\n# alone\n3 1 2.5#\n",
    "blank_entry_lines": f"{H} real general\n3 3 2\n\n1 2 1.5\n  \n\n3 1 2.5\n",
    "blank_before_size": f"{H} real general\n% c\n\n \t\n% d\n3 3 1\n1 2 1.5\n",
    "more_entries_than_nnz": f"{H} real general\n3 3 1\n1 2 1.5\n3 1 2.5\n",
    "big_sizes": f"{H} real general\n3000000000 7 1\n1 2 1.5\n",
    "index_wrap": f"{H} real general\n3 3 2\n4294967297 1 1\n0 -2 2\n",
    "banner_extra_words": f"{H} real general extra words\n2 2 1\n1 2 1\n",
}
VALID_BYTES = {
    "latin1_comment": (H + " real general\n% caf\xe9 \xff\n2 2 1\n1 2 1.5\n")
    .encode("latin-1"),
    "unicode_spaces": (H + " real general\n2\x0b2\xa01\n1\x0c2\x1c1.5\x85\n")
    .encode("latin-1"),
}

# (name, content, what both paths do): "scipy" = read as scipy.io.mmread
# reads it, "raise" = MatrixMarketError. The first four are ROADMAP C's
# corpus.
MALFORMED = [
    ("blank_before_size", f"{H} real general\n\n2 2 1\n1 2 1.0\n", "scipy"),
    ("percent_among_entries", f"{H} real general\n3 3 2\n1 2 1.0\n% c\n3 1 2.0\n",
     "raise"),
    ("bad_size_line", f"{H} real general\n3 x 3\n1 2 1.0\n", "raise"),
    ("too_few_entries", f"{H} real general\n3 3 3\n1 2 1.0\n3 1 2.0\n", "raise"),
    ("no_entries", f"{H} real general\n3 3 3\n", "raise"),
    ("size_line_two_numbers", f"{H} real general\n3 3\n1 2 1.0\n", "raise"),
    ("size_line_four_numbers", f"{H} real general\n3 3 1 7\n1 2 1.0\n", "raise"),
    ("negative_size", f"{H} real general\n-3 3 1\n1 2 1.0\n", "raise"),
    ("float_size", f"{H} real general\n3.0 3 1\n1 2 1.0\n", "raise"),
    ("size_too_large", f"{H} real general\n3 3 99999999999999999999\n", "raise"),
    ("missing_size_line", f"{H} real general\n% c\n\n", "raise"),
    ("missing_banner", "3 3 1\n1 2 1.0\n", "raise"),
    ("empty_file", "", "raise"),
    ("array_storage", "%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
     "raise"),
    ("complex_field", f"{H} complex general\n2 2 1\n1 2 1.0 0.0\n", "raise"),
    ("unknown_field", f"{H} double general\n2 2 1\n1 2 1.0\n", "raise"),
    ("unknown_symmetry", f"{H} real diagonal\n2 2 1\n1 2 1.0\n", "raise"),
    ("short_banner", f"{H} real\n2 2 1\n1 2 1.0\n", "raise"),
    ("columns_change", f"{H} real general\n3 3 2\n1 2 1.0\n3 1\n", "raise"),
    ("one_column", f"{H} real general\n3 3 2\n1\n3\n", "raise"),
    ("not_a_number", f"{H} real general\n3 3 1\n1 2 abc\n", "raise"),
    ("hex_value", f"{H} real general\n3 3 1\n1 2 0x10\n", "raise"),
    ("underscore_value", f"{H} real general\n3 3 1\n1 2 1_0\n", "raise"),
    ("nan_payload", f"{H} real general\n3 3 1\n1 2 nan(1)\n", "raise"),
    ("exponent_without_digits", f"{H} real general\n3 3 1\n1 2 1e\n", "raise"),
    ("lone_dot", f"{H} real general\n3 3 1\n1 2 .\n", "raise"),
    ("nan_index", f"{H} real general\n3 3 1\nnan 2 1\n", "raise"),
    ("inf_index", f"{H} real general\n3 3 1\n1 inf 1\n", "raise"),
    ("huge_index", f"{H} real general\n3 3 1\n1e30 2 1\n", "raise"),
    ("nul_in_entry", f"{H} real general\n3 3 1\n1 2\x00 1\n", "raise"),
]


def _write(tmp_path, name, content) -> Path:
    path = tmp_path / f"{name}.mtx"
    path.write_bytes(content if isinstance(content, bytes) else content.encode())
    return path


def _python_path(mm, path):
    """``mm.load_matrix_market`` with its native parse switched off."""
    saved = mm._load_native
    mm._load_native = lambda p: None
    try:
        return mm.load_matrix_market(path)
    finally:
        mm._load_native = saved


def assert_same_parse(a, b):
    (pa, ca), (pb, cb) = a, b
    assert dataclasses.asdict(pa) == dataclasses.asdict(pb)
    assert (ca.n_rows, ca.n_cols) == (cb.n_rows, cb.n_cols)
    for k in COO_FIELDS:
        x, y = getattr(ca, k), getattr(cb, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _edge_set(coo):
    order = np.lexsort((coo.values.view(np.int32), coo.col_indices,
                        coo.row_indices))
    return [getattr(coo, k)[order].tobytes() for k in COO_FIELDS]


def _port_both(path):
    before = tnative.CALLS["parse_mtx"]
    native = tmm.load_matrix_market(path)
    assert tnative.CALLS["parse_mtx"] == before + 1
    return native, _python_path(tmm, path)


# -- the port's two paths and the JAX package's Python path -------------------


def _valid_files(tmp_path):
    files = {name: _write(tmp_path, name, c) for name, c in VALID.items()}
    files.update({n: _write(tmp_path, n, c) for n, c in VALID_BYTES.items()})
    return files


@pytest.mark.parametrize("name", [*VALID, *VALID_BYTES])
def test_port_paths_equal_on_valid_files(tmp_path, name):
    path = _valid_files(tmp_path)[name]
    native, python = _port_both(path)
    assert_same_parse(native, python)


@pytest.mark.parametrize("name", ["general", "symmetric", "hermitian", "skew",
                                  "pattern", "pattern_symmetric", "integer",
                                  "crlf", "tabs", "no_final_newline",
                                  "exponents", "float_ties", "specials",
                                  "long_tokens", "float_indices",
                                  "duplicate_symmetric", "two_column_real",
                                  "four_columns", "empty", "hash_comments",
                                  "blank_entry_lines", "more_entries_than_nnz",
                                  "index_wrap"])
def test_port_equals_jax_python_path(tmp_path, name):
    """The JAX Python path reads every file here the same way (the port's
    repairs touch only malformed files)."""
    path = _write(tmp_path, name, VALID[name])
    assert_same_parse(tmm.load_matrix_market(path), _python_path(jmm, path))


@pytest.mark.usefixtures("jax_native")
@pytest.mark.parametrize("name", ["general", "symmetric", "hermitian", "skew",
                                  "pattern", "pattern_symmetric", "integer",
                                  "integer_symmetric", "crlf", "tabs",
                                  "no_final_newline", "exponents", "float_ties",
                                  "duplicate_symmetric", "four_columns",
                                  "empty"])
def test_port_equals_jax_native_as_edge_sets(tmp_path, name):
    path = _write(tmp_path, name, VALID[name])
    (tp, tc), (jp, jc) = tmm.load_matrix_market(path), jmm._load_native(path)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert (tc.n_rows, tc.n_cols) == (jc.n_rows, jc.n_cols)
    assert _edge_set(tc) == _edge_set(jc)


@pytest.mark.usefixtures("jax_native")
@pytest.mark.parametrize("name", ["general", "skew", "pattern", "integer",
                                  "empty"])
def test_parse_mtx_returns_what_jax_parse_mtx_returns(tmp_path, name):
    """Same signature and return values as ``gunrock_tpu._native.parse_mtx``
    on files without mirrors."""
    path = _write(tmp_path, name, VALID[name])
    got, want = tnative.parse_mtx(path), jnative.parse_mtx(path)
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        else:
            assert type(a) is type(b) and a == b


@pytest.mark.parametrize("path", DATASETS, ids=[p.name for p in DATASETS])
def test_datasets_both_paths_and_jax(path):
    native, python = _port_both(path)
    assert_same_parse(native, python)
    assert_same_parse(native, _python_path(jmm, path))
    if jnative.available():
        jp, jc = jmm._load_native(path)
        assert dataclasses.asdict(jp) == dataclasses.asdict(native[0])
        assert _edge_set(jc) == _edge_set(native[1])


def test_fixture_files(small_mtx, symmetric_mtx):
    for path in (small_mtx, symmetric_mtx):
        native, python = _port_both(path)
        assert_same_parse(native, python)
        assert_same_parse(native, _python_path(jmm, path))
        if jnative.available():
            assert _edge_set(jmm._load_native(path)[1]) == _edge_set(native[1])


@pytest.mark.parametrize("final_newline", [True, False])
def test_file_ending_on_a_page_boundary(tmp_path, final_newline):
    """A file of exactly 4,096 bytes, with and without its last line
    break: the parser must not read past the mapping."""
    head = f"{H} real general\n"
    body = "3 3 2\n1 2 1.5\n3 1 2.25" + ("\n" if final_newline else "")
    pad = 4096 - len(head) - len(body) - 2
    content = head + "%" + "x" * pad + "\n" + body
    assert len(content) == 4096
    path = _write(tmp_path, "page", content)
    native, python = _port_both(path)
    assert_same_parse(native, python)
    assert native[1].values.tolist() == [1.5, 2.25]


def test_symmetric_duplicate_gives_the_same_csr(tmp_path):
    """Mirrors appended after the entries, on both paths: the CSR built
    from a symmetric file with a duplicate entry is equal element for
    element (interleaved mirrors would order the duplicates' values
    differently)."""
    path = _write(tmp_path, "dup", VALID["duplicate_symmetric"])
    native, python = _port_both(path)
    assert native[1].row_indices.tolist() == [1, 1, 2, 2, 0, 0, 1]
    assert native[1].values.tolist() == [1, 2, 5, 7, 1, 2, 7]
    a, b = tformats.coo_to_csr(native[1]), tformats.coo_to_csr(python[1])
    for k in ("row_offsets", "col_indices", "values"):
        assert getattr(a, k).tobytes() == getattr(b, k).tobytes(), k


def test_values_and_indices_as_loadtxt_reads_them(tmp_path):
    path = _write(tmp_path, "f", VALID["float_indices"])
    (_, coo), _ = _port_both(path)
    assert coo.row_indices.tolist() == [0, 1, 2]  # 2.9 truncates to 2
    assert coo.col_indices.tolist() == [1, 0, 0]
    path = _write(tmp_path, "t", VALID["two_column_real"])
    (props, coo), _ = _port_both(path)
    assert props.weighted and coo.values.tolist() == [1.0, 1.0]
    path = _write(tmp_path, "s", VALID["specials"])
    (_, coo), _ = _port_both(path)
    bits = coo.values.view(np.uint32).tolist()
    assert bits == [0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
                    0x7F800000, 0]


def _random_file(rng) -> bytes:
    """A small file from a soup of the tokens, separators and line breaks
    the two paths must agree on."""
    sym = rng.choice(["general", "symmetric", "skew-symmetric", "hermitian"])
    field = rng.choice(["real", "integer", "pattern"])
    nl = rng.choice(["\n", "\r\n", "\r"])
    toks = ["1", "2", "3", "0", "-1", "1.0", "2.5", "1e0", "-0", ".5", "5.",
            "1e-3", "3E2", "+2", "inf", "nan", "x", "1e", "0x1", "#", "%",
            "2.9", "7", "4294967297", "1" * 20, "0.1000000000000000001"]
    seps = [" ", "  ", "\t", "\x0b", "\xa0"]
    lines = [f"%%MatrixMarket matrix coordinate {field} {sym}"]
    for _ in range(rng.integers(0, 3)):
        lines.append(rng.choice(["% c", "", " ", "%"]))
    nnz = int(rng.integers(0, 6))
    lines.append(rng.choice([f"4 4 {nnz}", f"4 4 {nnz} ", f"4\t4 {nnz}",
                             "4 4", f"4 x {nnz}"], p=[.6, .1, .1, .1, .1]))
    ncols = int(rng.choice([2, 3, 3, 3, 4]))
    for _ in range(nnz + int(rng.integers(-1, 2))):
        if rng.random() < 0.1:
            lines.append(rng.choice(["", "  ", "# c", "% c"]))
            continue
        n = ncols if rng.random() < 0.9 else int(rng.integers(1, 5))
        if rng.random() < 0.8:
            row = [str(rng.integers(1, 5)) for _ in range(min(n, 2))]
            row += [str(rng.choice(toks[:14])) for _ in range(n - 2)]
        else:
            row = [str(rng.choice(toks)) for _ in range(n)]
        sep = str(rng.choice(seps)) if rng.random() < 0.3 else " "
        lines.append(sep.join(row) + (" # t" if rng.random() < 0.05 else ""))
    text = nl.join(lines) + (nl if rng.random() < 0.8 else "")
    return text.encode("latin-1")


@pytest.mark.parametrize("seed", range(8))
def test_port_paths_agree_on_random_files(tmp_path, seed):
    """Either both paths raise MatrixMarketError or both return the same
    arrays, over 100 random files a seed."""
    rng = np.random.default_rng(seed)
    read = 0
    for i in range(100):
        path = tmp_path / f"r{i}.mtx"
        path.write_bytes(_random_file(rng))
        results = []
        for load in (tmm.load_matrix_market,
                     lambda p: _python_path(tmm, p)):
            try:
                results.append(load(path))
            except tmm.MatrixMarketError:
                results.append(None)
        assert (results[0] is None) == (results[1] is None), path.read_bytes()
        if results[0] is not None:
            assert_same_parse(*results)
            read += 1
    assert 0 < read < 100


# -- malformed files (ROADMAP C) ----------------------------------------------


@pytest.mark.parametrize("name,content,expect", MALFORMED,
                         ids=[m[0] for m in MALFORMED])
def test_malformed_files(tmp_path, name, content, expect):
    path = _write(tmp_path, name, content)
    if expect == "raise":
        with pytest.raises(tmm.MatrixMarketError):
            tmm.load_matrix_market(path)
        with pytest.raises(tmm.MatrixMarketError):
            _python_path(tmm, path)
        return
    import scipy.io

    native, python = _port_both(path)
    assert_same_parse(native, python)
    ref = scipy.io.mmread(path).tocoo()
    _, coo = native
    assert (coo.n_rows, coo.n_cols) == ref.shape
    np.testing.assert_array_equal(coo.row_indices, ref.row)
    np.testing.assert_array_equal(coo.col_indices, ref.col)
    np.testing.assert_array_equal(coo.values, ref.data.astype(np.float32))


def test_missing_file_raises_os_error(tmp_path):
    with pytest.raises(FileNotFoundError):
        tmm.load_matrix_market(tmp_path / "absent.mtx")
    with pytest.raises(FileNotFoundError):
        _python_path(tmm, tmp_path / "absent.mtx")
    with pytest.raises(IsADirectoryError):
        tmm.load_matrix_market(tmp_path)


def test_gz_takes_the_python_path(tmp_path):
    import gzip

    path = tmp_path / "g.mtx.gz"
    with gzip.open(path, "wb") as f:
        f.write(VALID["symmetric"].encode())
    before = tnative.CALLS["parse_mtx"]
    got = tmm.load_matrix_market(path)
    assert tnative.CALLS["parse_mtx"] == before
    assert_same_parse(got, tmm.load_matrix_market(
        _write(tmp_path, "g", VALID["symmetric"])))


@pytest.mark.usefixtures("jax_native")
def test_jax_native_quirks_are_deliberate_differences(tmp_path):
    """What the JAX native parser does and the port does not (ROADMAP C):
    a 0x0 graph after a blank line before the size line, an entry (-1, -1,
    0.0) from a "%" line among the entries, 0.0 for two-column entries of
    a real matrix, and each mirror next to its entry."""
    blank = _write(tmp_path, "blank", MALFORMED[0][1])
    assert jmm._load_native(blank)[1].n_rows == 0
    assert tmm.load_matrix_market(blank)[1].n_rows == 2
    pct = _write(tmp_path, "pct", MALFORMED[1][1])
    _, jc = jmm._load_native(pct)
    assert (jc.row_indices[1], jc.col_indices[1], jc.values[1]) == (-1, -1, 0.0)
    with pytest.raises(tmm.MatrixMarketError):
        tmm.load_matrix_market(pct)
    two = _write(tmp_path, "two", VALID["two_column_real"])
    assert jmm._load_native(two)[1].values.tolist() == [0.0, 0.0]
    assert tmm.load_matrix_market(two)[1].values.tolist() == [1.0, 1.0]
    dup = _write(tmp_path, "dup", VALID["duplicate_symmetric"])
    assert jmm._load_native(dup)[1].row_indices.tolist() == [1, 0, 1, 0, 2, 2, 1]
    assert tmm.load_matrix_market(dup)[1].row_indices.tolist() == [
        1, 1, 2, 2, 0, 0, 1]


# -- the counting sort ----------------------------------------------------------


def _sort_inputs(kind, nnz, n_major, n_minor, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        major = rng.integers(0, n_major, nnz)
        minor = rng.integers(0, n_minor, nnz)
    elif kind == "one_row":
        major = np.full(nnz, n_major - 1)
        minor = rng.integers(0, n_minor, nnz)
    elif kind == "n_minor_edges":  # one edge per minor index, shuffled
        minor = rng.permutation(n_minor)
        major = rng.integers(0, n_major, n_minor)
    else:  # empty
        major = minor = np.zeros(0, dtype=np.int64)
    values = rng.random(major.shape[0]).astype(np.float32)
    return major.astype(np.int32), minor.astype(np.int32), values


SORT_CASES = [("random", 1000, 50, 40), ("random", (1 << 16) + 7, 3000, 2000),
              ("random", 1 << 17, 100, 7), ("one_row", 5000, 9, 300),
              ("one_row", 1 << 16, 1, 1 << 12), ("n_minor_edges", 0, 60, 1000),
              ("n_minor_edges", 0, 500, 1 << 16), ("empty", 0, 5, 1)]


@pytest.mark.parametrize("kind,nnz,n_major,n_minor", SORT_CASES)
def test_counting_sort_equals_lexsort_and_jax(kind, nnz, n_major, n_minor):
    major, minor, values = _sort_inputs(kind, nnz, n_major, n_minor)
    offsets, minor_out, vals_out, perm = tnative.coo_to_compressed(
        major, minor, values, n_major, n_minor)
    ref = np.lexsort((minor, major))
    np.testing.assert_array_equal(perm, ref)
    np.testing.assert_array_equal(minor_out, minor[ref])
    assert vals_out.tobytes() == values[ref].tobytes()
    np.testing.assert_array_equal(
        offsets, np.concatenate([[0], np.cumsum(np.bincount(major, minlength=n_major))]))
    assert (offsets.dtype, minor_out.dtype, vals_out.dtype, perm.dtype) == (
        np.int64, np.int32, np.float32, np.int64)
    if jnative.available() and nnz:
        j = jnative.coo_to_compressed(major, minor, values, n_major, n_minor)
        for a, b in zip((offsets, minor_out, vals_out, perm), j):
            assert a.tobytes() == b.tobytes()


def test_counting_sort_refuses_out_of_range_indices():
    major, minor, values = _sort_inputs("random", 100, 10, 10)
    for bad in ((major, minor, values, 9, 10), (major, minor, values, 10, 9)):
        with pytest.raises(ValueError):
            tnative.coo_to_compressed(*bad)
    with pytest.raises(ValueError):
        tnative.coo_to_compressed(major - 1, minor, values, 10, 10)
    with pytest.raises(ValueError):
        tnative.coo_to_compressed(major, minor[:-1], values, 10, 10)


@pytest.mark.parametrize("kind,nnz,n_major,n_minor", SORT_CASES)
@pytest.mark.parametrize("dtypes", ["int32/float32", "int64/float64"])
def test_compressed_sort_native_on_and_off(monkeypatch, kind, nnz, n_major,
                                           n_minor, dtypes):
    """``_counting_sort_to_compressed`` returns the same arrays, dtypes
    included, through the native sort (from one edge up here) and through
    ``np.lexsort``."""
    major, minor, values = _sort_inputs(kind, nnz, n_major, n_minor)
    if dtypes == "int64/float64":
        major, minor = major.astype(np.int64), minor.astype(np.int64)
        values = values.astype(np.float64) / 3
    before = tnative.CALLS["coo_to_compressed"]
    monkeypatch.setattr(tformats, "NATIVE_SORT_MIN_EDGES", 1)
    on = tformats._counting_sort_to_compressed(major, minor, values, n_major)
    assert tnative.CALLS["coo_to_compressed"] == before + (major.size > 0)
    monkeypatch.setattr(tformats, "NATIVE_SORT_MIN_EDGES", 1 << 62)
    off = tformats._counting_sort_to_compressed(major, minor, values, n_major)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_compressed_sort_default_threshold(monkeypatch):
    major, minor, values = _sort_inputs("random", (1 << 16) - 1, 40, 40)
    before = tnative.CALLS["coo_to_compressed"]
    tformats._counting_sort_to_compressed(major, minor, values, 40)
    assert tnative.CALLS["coo_to_compressed"] == before
    major, minor, values = _sort_inputs("random", 1 << 16, 40, 40)
    tformats._counting_sort_to_compressed(major, minor, values, 40)
    assert tnative.CALLS["coo_to_compressed"] == before + 1


# -- graphs built with the native code on and off -------------------------------


def assert_same_graph(a, b):
    assert (a.n_vertices, a.n_edges) == (b.n_vertices, b.n_edges)
    assert dataclasses.asdict(a.properties) == dataclasses.asdict(b.properties)
    for name in ARRAYS:
        x, y = a.host[name], b.host[name]
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
        assert getattr(a, name).numpy().tobytes() == y.tobytes(), name


def _native_off(monkeypatch):
    monkeypatch.setattr(tmm, "_load_native", lambda p: None)
    monkeypatch.setattr(tformats, "NATIVE_SORT_MIN_EDGES", 1 << 62)


@pytest.mark.parametrize("path", DATASETS, ids=[p.name for p in DATASETS])
def test_load_graph_file_native_on_and_off(monkeypatch, path):
    monkeypatch.setattr(tformats, "NATIVE_SORT_MIN_EDGES", 1)
    calls = dict(tnative.CALLS)
    on, props_on = load_graph_file(path, device="cpu")
    assert tnative.CALLS["parse_mtx"] == calls.get("parse_mtx", 0) + 1
    assert tnative.CALLS["coo_to_compressed"] >= calls.get("coo_to_compressed", 0) + 2
    _native_off(monkeypatch)
    off, props_off = load_graph_file(path, device="cpu")
    assert props_on == props_off
    assert_same_graph(on, off)


@pytest.mark.parametrize("undirected", [False, True])
def test_rmat_graph_native_on_and_off(monkeypatch, undirected):
    monkeypatch.setattr(tformats, "NATIVE_SORT_MIN_EDGES", 1)
    before = tnative.CALLS["coo_to_compressed"]
    on = rmat_graph(10, 16, seed=3, device="cpu", undirected=undirected)
    assert tnative.CALLS["coo_to_compressed"] > before
    _native_off(monkeypatch)
    off = rmat_graph(10, 16, seed=3, device="cpu", undirected=undirected)
    assert_same_graph(on, off)


CLIS = [("bfs", ["--src", "0"]), ("sssp", ["--src", "0"]), ("pr", []),
        ("hits", []), ("spmv", []), ("color", []), ("mst", []), ("kcore", []),
        ("ppr", ["--src", "0"]), ("bc", ["--src", "0"]), ("tc", []),
        ("spgemm", []), ("geo", [])]


@pytest.mark.parametrize("algo,argv", CLIS, ids=[a for a, _ in CLIS])
def test_every_cli_market_takes_the_native_parse(capsys, algo, argv):
    import importlib

    cli = importlib.import_module(f"gunrock_tpu_torch.examples.{algo}")
    before = tnative.CALLS["parse_mtx"]
    path = ROOT / "datasets" / "chesapeake.mtx"
    assert cli.main(["--market", str(path), *argv, "--device", "cpu"]) in (0, None)
    assert tnative.CALLS["parse_mtx"] == before + 1


# -- building the library --------------------------------------------------------


def test_two_processes_build_a_fresh_library_at_once(tmp_path):
    code = textwrap.dedent("""
        import sys
        from pathlib import Path
        import gunrock_tpu_torch._native as n
        n.BUILD_DIR = Path(sys.argv[1])
        lib = n.get_lib()
        print(n.library_path(n.compiler()).name, lib.gr_mtx_parse is not None)
    """)
    build = tmp_path / "_build"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    names = {out.split()[0] for out, _ in outs}
    assert len(names) == 1 and all(out.split()[1] == "True" for out, _ in outs)
    assert [p.name for p in build.iterdir()] == [names.pop()]


def test_failing_compiler_raises_and_no_compiler_falls_back(monkeypatch, tmp_path):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'cxx: deliberately broken' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CXX", str(cxx))
    path = ROOT / "datasets" / "chesapeake.mtx"
    with pytest.raises(RuntimeError, match="deliberately broken"):
        tnative.available()
    with pytest.raises(RuntimeError, match="deliberately broken"):
        tmm.load_matrix_market(path)
    monkeypatch.setenv("CXX", str(tmp_path / "absent-compiler"))
    with pytest.raises(RuntimeError):
        tnative.available()
    monkeypatch.delenv("CXX")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert tnative.compiler() is None and not tnative.available()
    before = tnative.CALLS["parse_mtx"]
    assert_same_parse(tmm.load_matrix_market(path), _python_path(jmm, path))
    assert tnative.CALLS["parse_mtx"] == before


def test_the_library_is_built_from_the_port_source():
    lib = tnative.get_lib()
    path = tnative.library_path(tnative.compiler())
    assert path.parent == ROOT / "gunrock_tpu_torch" / "_build" and path.exists()
    assert lib._name == str(path)
    assert tnative.SOURCE == ROOT / "gunrock_tpu_torch" / "_native" / "fast_io.cpp"
    assert os.path.commonpath([lib._name, str(ROOT / "gunrock_tpu")]) != str(
        ROOT / "gunrock_tpu")


def test_chip_smoke_ingest_phase_on_the_cpu(monkeypatch):
    """Phase 3i of chip_smoke.py rehearsed on the CPU at R-MAT 13 (above
    the native sort's threshold): both files load bit-equal through both
    paths, each path counted, and the three CLIs validate."""
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "SCALE", 13)
    out = smoke.ingest_path(torch, "cpu", device="cpu")
    assert out["clis"] == ["bfs validation: PASSED", "sssp validation: PASSED",
                           "bfs validation: PASSED"]
    for key in ("general", "symmetric"):
        assert out[key]["native"]["native_calls"]["parse_mtx"] == 1
        assert not any(out[key]["python"]["native_calls"].values())
        assert len(out[key]["native"]["h2d_s"]) == 1
    assert out["setup"]["native"]["native_calls"] == 5
    assert out["files"]["general"]["entries"] == out["general"]["n_edges"]
