"""Data layer of the PyTorch port against the JAX package: formats, file
loading, generators, graph build and degree sort give the same arrays.

Everything here is integer or copied float data, so every comparison is
exact."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import gunrock_tpu.formats as jformats
from gunrock_tpu.graph.reorder import degree_sort as j_degree_sort
from gunrock_tpu.io.generators import grid2d_graph as j_grid2d_graph
from gunrock_tpu.io.generators import rmat_graph as j_rmat_graph
from gunrock_tpu.io.loader import load_graph_file as j_load_graph_file

import gunrock_tpu_torch.formats as tformats
from gunrock_tpu_torch.graph import Graph, GraphProperties
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.graph.reorder import degree_sort
from gunrock_tpu_torch.io.generators import grid2d_graph, rmat_graph
from gunrock_tpu_torch.io.loader import load_graph_file

DATASETS = Path(__file__).resolve().parent.parent / "datasets"


def assert_same_graph(jg, tg):
    assert (tg.n_vertices, tg.n_edges) == (jg.n_vertices, jg.n_edges)
    assert dataclasses.asdict(tg.properties) == dataclasses.asdict(jg.properties)
    for name in ARRAYS:
        want = np.asarray(getattr(jg, name))
        np.testing.assert_array_equal(tg.host[name], want, err_msg=name)
        np.testing.assert_array_equal(getattr(tg, name).numpy(), want, err_msg=name)
        assert getattr(tg, name).numpy().dtype == want.dtype, name


@pytest.mark.parametrize("name", ["chesapeake", "rmat10", "grid32"])
def test_load_graph_file_matches_jax(name):
    path = DATASETS / f"{name}.mtx"
    jg, jprops = j_load_graph_file(path)
    tg, tprops = load_graph_file(path, device="cpu")
    assert dataclasses.asdict(tprops) == dataclasses.asdict(jprops)
    assert_same_graph(jg, tg)


@pytest.mark.parametrize("name", ["chesapeake", "rmat10", "grid32"])
def test_degree_sort_matches_jax(name):
    path = DATASETS / f"{name}.mtx"
    jg, jro = j_degree_sort(j_load_graph_file(path)[0])
    tg, tro = degree_sort(load_graph_file(path, device="cpu")[0])
    assert tg.properties.hub_ordered
    np.testing.assert_array_equal(tro.order, jro.order)
    np.testing.assert_array_equal(tro.rank, jro.rank)
    assert_same_graph(jg, tg)


def test_rmat_graph_matches_jax():
    jg = j_rmat_graph(scale=8, seed=1)
    tg = rmat_graph(scale=8, seed=1, device="cpu")
    assert_same_graph(jg, tg)
    assert_same_graph(j_degree_sort(jg)[0], degree_sort(tg)[0])


def test_grid2d_graph_matches_jax_and_aliases_csc():
    jg = j_grid2d_graph(8, weighted=True, seed=3)
    tg = grid2d_graph(8, weighted=True, seed=3, device="cpu")
    assert_same_graph(jg, tg)
    # symmetric: the CSC view is the CSR storage, not a copy
    assert tg.csc_rows is tg.col_indices and tg.csc_offsets is tg.row_offsets


def test_formats_match_jax():
    rng = np.random.default_rng(7)
    n, m = 40, 300
    rows = rng.integers(0, n, m).astype(np.int32)
    cols = rng.integers(0, n, m).astype(np.int32)
    vals = rng.random(m).astype(np.float32)
    jcsr = jformats.coo_to_csr(jformats.Coo(n, n, rows, cols, vals))
    tcsr = tformats.coo_to_csr(tformats.Coo(n, n, rows, cols, vals))
    for f in ("row_offsets", "col_indices", "values"):
        np.testing.assert_array_equal(getattr(tcsr, f), getattr(jcsr, f))
    (jcsc, jperm), (tcsc, tperm) = jformats.csr_to_csc(jcsr), tformats.csr_to_csc(tcsr)
    for f in ("col_offsets", "row_indices", "values"):
        np.testing.assert_array_equal(getattr(tcsc, f), getattr(jcsc, f))
    np.testing.assert_array_equal(tperm, jperm)
    np.testing.assert_array_equal(
        tformats.offsets_to_indices(tcsr.row_offsets),
        jformats.formats.offsets_to_indices(jcsr.row_offsets),
    )


def test_binary_csr_round_trip(tmp_path):
    jg, _ = j_load_graph_file(DATASETS / "chesapeake.mtx")
    tg, _ = load_graph_file(DATASETS / "chesapeake.mtx", device="cpu")
    path = tmp_path / "chesapeake.csr"
    tformats.Csr(tg.n_vertices, tg.n_vertices, tg.host["row_offsets"],
                 tg.host["col_indices"], tg.host["values"]).write_binary(path)
    # the JAX package reads the port's cache and builds the same graph
    assert_same_graph(j_load_graph_file(path)[0], load_graph_file(path, device="cpu")[0])
    assert load_graph_file(path, device="cpu")[0].n_edges == jg.n_edges


def test_symmetric_pattern_mtx_matches_jax(symmetric_mtx):
    jg, _ = j_load_graph_file(symmetric_mtx)
    tg, _ = load_graph_file(symmetric_mtx, device="cpu")
    assert_same_graph(jg, tg)


def test_graph_from_arrays_round_trips():
    jg = j_rmat_graph(scale=7, seed=2)
    arrays = {name: np.asarray(getattr(jg, name)) for name in ARRAYS}
    props = GraphProperties(**dataclasses.asdict(jg.properties))
    tg = Graph.from_arrays(arrays, jg.n_vertices, props, device="cpu")
    assert_same_graph(jg, tg)
    again = Graph.from_arrays(tg.host, tg.n_vertices, tg.properties, device="cpu")
    for name in ARRAYS:
        assert torch.equal(getattr(again, name), getattr(tg, name)), name
    assert tg.to("cpu") is tg
