"""The predecessor pass of BFS and SSSP on the CPU
(``ops/kernels/predecessors.py``, ``csrc/predecessors.cu``).

- The merged plain pass against the JAX package's
  ``_predecessors_from_distances`` and ``recover_predecessors``, bit for
  bit, on ``probes/predecessor_cases.py``'s graphs: a planted hub, a
  directed graph, unreached and isolated vertices, integer weights with
  exact ties, distances at the edge of ``isclose``'s tolerance.
- A numpy model of the kernel's schedule (a lane, a warp or a block a run
  by its length, strides and rounds in ascending slot order, the first
  tight slot or the round's smallest tight source; its constants read
  from the source) against the plain pass on the same cases; and the
  model on runs left unsorted, where it goes wrong: the early exit is
  exact only because every build path sorts each CSC run by source, which
  ``test_csc_runs_ascend`` holds for each of them.
- The kernel's float32 form of the SSSP test against ``torch.isclose``.
- The CPU dispatch: the plain pass, no CUDA library loaded, no launch
  counted, the ``kernel.*`` span inside the pass's span.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrock_tpu.algorithms import bfs as jbfs
from gunrock_tpu.algorithms import sssp as jsssp
from gunrock_tpu.graph import graph as jgraph
from gunrock_tpu.graph import properties as jprops

from gunrock_tpu_torch.algorithms import bfs, sssp
from gunrock_tpu_torch.formats import Coo, formats
from gunrock_tpu_torch.graph import build_graph, build_graph_from_arrays
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.graph.properties import GraphProperties
from gunrock_tpu_torch.graph.reorder import degree_sort, rcm_sort
from gunrock_tpu_torch.io.generators import rmat_coo, rmat_graph
from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels import predecessors as P
from gunrock_tpu_torch.probes import predecessor_cases
from gunrock_tpu_torch.utils import profiler
from gunrock_tpu_torch.utils.limits import UNREACHED

SOURCE = (_build.CSRC / "predecessors.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


K = {k: _const(k) for k in ("kThreads", "kLaneRun", "kBlockRun",
                            "kLaneLoads", "kWarpLoads", "kBlockLoads")}
CASES = ["hub_mid.bfs", "hub_mid.sssp", "directed.bfs", "directed.sssp",
         "unreached.bfs", "unreached.sssp", "ties.sssp", "tolerance.sssp"]


@pytest.fixture(scope="module")
def cases():
    return predecessor_cases.cases("cpu")


def _jax_graph(g):
    return jgraph.Graph(
        **{k: jnp.asarray(g.host[k]) for k in ARRAYS},
        n_vertices=g.n_vertices, n_edges=g.n_edges,
        properties=jprops.GraphProperties(
            **dataclasses.asdict(g.properties)))


def _np_tight(kind, du, w, dv):
    """The kernel's tightness test in numpy (float32 for SSSP, each
    operation rounded once)."""
    if kind == "bfs":
        plus1 = (du.astype(np.int64) + 1).astype(np.uint32).view(np.int32)
        return (du != UNREACHED) & (plus1 == dv)
    with np.errstate(invalid="ignore", over="ignore"):
        a = (du + w).astype(np.float32)
        err = np.abs(a - dv)
        allowed = np.float32(1e-8) + np.abs(np.float32(1e-5) * dv)
        return (((a == dv) | (np.isfinite(err) & (err <= allowed)))
                & (du < np.float32(np.inf)))


def kernel_model(g, d: np.ndarray, kind: str, sms: int = 132):
    """(pred, role) as ``csrc/predecessors.cu`` computes them: a run of up
    to kLaneRun slots scanned by its lane kLaneLoads slots at a time, one
    of up to kBlockRun by its warp in strides of 32 x kWarpLoads (the
    first tight slot of the first stride holding one), a longer one by a
    hub block (vertices b, b + hub_blocks, ... of block b) in rounds of
    kThreads x kBlockLoads (the smallest tight source of the first round
    holding one). role[v] names the path that wrote pred[v]."""
    off, rows, vals = (g.host[k] for k in ("csc_offsets", "csc_rows",
                                           "csc_values"))
    V, E = g.n_vertices, g.n_edges
    pred = np.full(V, -2, np.int64)
    role = np.full(V, "", object)
    unreached = d == UNREACHED if kind == "bfs" else np.isinf(d)

    def scan(v, width, smallest):
        for s0 in range(off[v], off[v + 1], width):
            s = np.arange(s0, min(s0 + width, off[v + 1]))
            ok = _np_tight(kind, d[rows[s]], vals[s], d[v])
            if ok.any():
                return rows[s][ok].min() if smallest else rows[s][ok][0]
        return -1

    def write(v, name, width, smallest):
        assert pred[v] == -2, f"vertex {v} written twice"
        pred[v] = -1 if unreached[v] else scan(v, width, smallest)
        role[v] = name

    hub_blocks = min(sms, V) if E > K["kBlockRun"] else 0
    for b in range(hub_blocks):
        for v in range(b, V, hub_blocks):
            if off[v + 1] - off[v] > K["kBlockRun"]:
                write(v, "block", K["kThreads"] * K["kBlockLoads"], True)
    for v in range(V):
        n = off[v + 1] - off[v]
        if n <= K["kLaneRun"]:
            write(v, "lane", K["kLaneLoads"], False)
        elif n <= K["kBlockRun"]:
            write(v, "warp", 32 * K["kWarpLoads"], False)
    assert (pred != -2).all(), "a vertex no path writes"
    return pred, role


@pytest.mark.parametrize("name", CASES)
def test_plain_pass_matches_jax(cases, name):
    g, kind, d = cases[name]
    jg = _jax_graph(g)
    if kind == "bfs":
        got = bfs._predecessors_from_distances(g, d)
        want = jbfs._predecessors_from_distances(jg, jnp.asarray(d.numpy()))
    else:
        got = sssp.recover_predecessors(g, d)
        want = jsssp.recover_predecessors(jg, jnp.asarray(d.numpy()))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).any() and (got == -1).any()


@pytest.mark.parametrize("name", CASES)
def test_kernel_model_matches_plain(cases, name):
    g, kind, d = cases[name]
    pred, role = kernel_model(g, d.numpy(), kind)
    np.testing.assert_array_equal(
        pred, P.predecessors_plain(g, d, kind).numpy())
    if name.startswith(("hub_mid", "tolerance")):
        assert {"lane", "warp", "block"} <= set(role)


def test_hub_mid_case_puts_the_source_mid_run(cases):
    """The planted hub's run is past the block threshold and its one tight
    BFS in-neighbour, the source, lies in the middle of it, past the
    block's first round."""
    g, _, d = cases["hub_mid.bfs"]
    off, rows = g.host["csc_offsets"], g.host["csc_rows"]
    run = rows[off[0]:off[1]]
    assert run.size > K["kBlockRun"]
    assert d[0] == 1
    (at,) = np.nonzero(d.numpy()[run] == 0)
    assert at.tolist() == [run.size // 2]
    assert run.size // 2 >= K["kThreads"] * K["kBlockLoads"]


def test_kernel_model_needs_ascending_runs(cases):
    """With each run's slots in another order the early exit names a tight
    source that is not the smallest: the sorted runs are what make it
    exact."""
    wrong = 0
    rng = np.random.default_rng(3)
    for name in ("hub_mid.bfs", "ties.sssp"):
        g, kind, d = cases[name]
        h = dict(g.host)
        off = h["csc_offsets"]
        perm = np.arange(g.n_edges)
        for v in range(g.n_vertices):
            rng.shuffle(perm[off[v]:off[v + 1]])
        h["csc_rows"], h["csc_values"] = h["csc_rows"][perm], \
            h["csc_values"][perm]
        shuffled = dataclasses.replace(g, host=h)
        pred, _ = kernel_model(shuffled, d.numpy(), kind)
        wrong += int((pred != P.predecessors_plain(g, d, kind).numpy()).sum())
    assert wrong > 0


def _runs_ascend(g) -> None:
    h = g.host
    off, rows, dst = h["csc_offsets"], h["csc_rows"], h["csc_dst"]
    np.testing.assert_array_equal(np.diff(off), np.bincount(
        dst, minlength=g.n_vertices))
    assert (np.diff(dst) >= 0).all()
    same = dst[1:] == dst[:-1]
    assert (rows[1:][same] > rows[:-1][same]).all()


def _unsorted_csr():
    coo = rmat_coo(9, 8, seed=4)
    order = np.random.default_rng(0).permutation(coo.nnz)
    rows, cols, vals = (coo.row_indices[order], coo.col_indices[order],
                        coo.values[order])
    counts = np.bincount(rows, minlength=coo.n_rows)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    by_row = np.argsort(rows, kind="stable")  # rows grouped, columns not sorted
    return build_graph_from_arrays(coo.n_rows, offsets, cols[by_row],
                                   vals[by_row], device="cpu")


BUILDS = {
    "symmetric": lambda: rmat_graph(10, seed=1, undirected=True, device="cpu"),
    "directed": lambda: rmat_graph(10, seed=1, device="cpu"),
    "degree_sort_symmetric": lambda: degree_sort(
        rmat_graph(10, seed=1, undirected=True, device="cpu"))[0],
    "degree_sort_directed": lambda: degree_sort(
        rmat_graph(10, seed=1, device="cpu"))[0],
    "rcm": lambda: rcm_sort(
        rmat_graph(10, seed=1, undirected=True, device="cpu"))[0],
    "unsorted_csr": _unsorted_csr,
    "coo_unsorted": lambda: _reversed_coo(),
}


def _reversed_coo():
    """A COO edge list in descending (row, col) order, on 600 vertices."""
    coo = rmat_coo(9, 8, seed=9)
    return build_graph(
        Coo(600, 600, coo.row_indices[::-1].copy(),
            coo.col_indices[::-1].copy(), coo.values[::-1].copy()),
        GraphProperties(directed=True, weighted=True), "cpu")


@pytest.mark.parametrize("build", sorted(BUILDS) + ["native_sort"])
def test_csc_runs_ascend(build, monkeypatch):
    """Every build path leaves csc_rows strictly ascending within each CSC
    run: the symmetric shortcut (the CSC aliases the CSR), the directed
    transpose, both relabelings, unsorted CSR and COO input, and the
    native counting sort (used where a compiler builds it)."""
    if build == "native_sort":
        monkeypatch.setattr(formats, "NATIVE_SORT_MIN_EDGES", 0)
        g = rmat_graph(11, seed=2, device="cpu")
    else:
        g = BUILDS[build]()
    if build in ("symmetric", "degree_sort_symmetric", "rcm"):
        assert g.properties.symmetric and g.csc_rows is g.col_indices
    _runs_ascend(g)


@pytest.mark.parametrize("name", CASES)
def test_case_graphs_have_ascending_runs(cases, name):
    _runs_ascend(cases[name][0])


def test_sssp_tightness_is_torch_isclose(cases):
    """The kernel's float32 test gives torch.isclose's answer on every slot
    of the tolerance and ties cases (both sides of the edge present), and
    on random pairs a few float32 steps either side of the edge."""
    for name in ("tolerance.sssp", "ties.sssp", "hub_mid.sssp"):
        g, _, d = cases[name]
        h = g.host
        dn = d.numpy()
        got = _np_tight("sssp", dn[h["csc_rows"]], h["csc_values"],
                        dn[h["csc_dst"]])
        want = P.tight_slots(g, d, "sssp").numpy()
        np.testing.assert_array_equal(got, want)
        assert want.any() and not want.all()
    rng = np.random.default_rng(5)
    du = (rng.random(200_000) * 1e3).astype(np.float32)
    w = (rng.random(200_000) * 10).astype(np.float32)
    a = (du + w).astype(np.float64)
    edge = np.where(rng.random(a.size) < 0.5, (a + 1e-8) / (1 - 1e-5),
                    (a - 1e-8) / (1 + 1e-5)).astype(np.float32)
    dv = edge.view(np.int32) + rng.integers(-3, 4, a.size).astype(np.int32)
    dv = dv.view(np.float32)
    want = (torch.isclose(torch.from_numpy(du) + torch.from_numpy(w),
                          torch.from_numpy(dv), rtol=1e-5, atol=1e-8)
            .numpy())
    np.testing.assert_array_equal(_np_tight("sssp", du, w, dv), want)
    assert 0.2 < want.mean() < 0.8


@pytest.mark.parametrize("name", ["directed.bfs", "unreached.sssp",
                                  "tolerance.sssp"])
def test_bound_bytes_counts_slots_up_to_the_first_tight(cases, name):
    """The byte bound of chip_smoke's and the probe's predecessor rows: a
    reached vertex's slots up to its first tight one, all of them where
    none is tight, none of an unreached vertex's."""
    g, kind, d = cases[name]
    off, rows, vals = (g.host[k] for k in ("csc_offsets", "csc_rows",
                                           "csc_values"))
    dn = d.numpy()
    gone = np.isinf(dn) if kind == "sssp" else dn == UNREACHED
    scanned = 0
    for v in np.flatnonzero(~gone):
        lo, hi = off[v], off[v + 1]
        hits = np.flatnonzero(_np_tight(kind, dn[rows[lo:hi]], vals[lo:hi],
                                        dn[v]))
        scanned += hits[0] + 1 if hits.size else hi - lo
    V, per_slot = g.n_vertices, 8 if kind == "sssp" else 4
    base = 4 * (V + 1) + 8 * V
    assert predecessor_cases.bound_bytes(g, d, kind) == (
        base + per_slot * scanned, base + per_slot * g.n_edges)


def test_sources_and_build_list():
    """The kernel is in the build list, range-checks its indices, holds no
    global atomic (its one atomic is the shared list's counter) and is
    counted by its wrappers."""
    assert "predecessors" in _build.SOURCES
    assert "GR_IN_RANGE" in SOURCE and "gr::finish" in SOURCE
    assert re.findall(r"\batomic\w*\(", SOURCE) == ["atomicAdd("]
    assert "__shared__ int count;" in SOURCE
    assert "atomicAdd(&count, 1)" in SOURCE
    wrapper = Path(P.__file__).read_text()
    assert "_build.LAUNCHES[name] += 1" in wrapper
    assert set(P._SIGNATURES) == {"gr_bfs_predecessors",
                                  "gr_sssp_predecessors"}


@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_cpu_dispatch_never_loads_the_library(cases, monkeypatch, kind):
    def refuse(name, signatures):
        raise AssertionError(f"loaded {name} on the CPU")

    monkeypatch.setattr(_build, "load", refuse)
    g = cases[f"hub_mid.{kind}"][0]
    before = dict(_build.LAUNCHES)
    run = bfs.run if kind == "bfs" else sssp.run
    res = run(g, 3, warmup=False, device="cpu")
    assert res.predecessors.dtype == torch.int32
    assert dict(_build.LAUNCHES) == before
    assert not any(name == "predecessors" for name, _ in _build._libs)


@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_wrapper_checks_distances(cases, kind):
    g, _, d = cases[f"hub_mid.{kind}"]
    fn = P.bfs_predecessors if kind == "bfs" else P.sssp_predecessors
    other = torch.float32 if kind == "bfs" else torch.int32
    with pytest.raises(ValueError, match="distances"):
        fn(g, d.to(other))
    with pytest.raises(ValueError, match="distances"):
        fn(g, d[:-1])
    assert torch.equal(fn(g, d), P.predecessors_plain(g, d, kind))


@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_kernel_span_inside_the_pass_span(cases, kind):
    g = cases[f"directed.{kind}"][0]
    run = bfs.run if kind == "bfs" else sssp.run
    with profiler.recording() as rec:
        run(g, 0, warmup=False, device="cpu")
    spans = rec.spans
    inner = [x for x in spans if x.name == f"kernel.{kind}_predecessors"]
    assert len(inner) == 1
    assert spans[inner[0].parent].name == f"{kind}.predecessors"
