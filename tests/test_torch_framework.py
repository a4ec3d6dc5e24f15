"""The port's framework surface against the JAX package: the BFS
Problem/Enactor and ``bfs.run`` on non-DO options, an Enactor whose state
holds a frontier object (written on the operators), the algorithms'
``Param`` dataclasses, ``geo.haversine``, ``mst.mst_kernel`` and
``sssp.sssp_do_slabbed``.

Graphs: chesapeake, R-MAT scale 10 (seed 2) and a 32x32 grid, carried
across with ``Graph.from_arrays``. BFS distances, predecessors and depths
are exact; SSSP distances rtol 1e-5; the MST weight rtol 1e-5 with the
component count exact; the haversine within 2e-6 km of JAX's away from
coincident points, relative (ROADMAP C: XLA contracts the radians
subtraction there). ``mst_kernel``'s ``max_rounds`` is ignored in both
packages (the loop ends on a round that adds no edge).
The torch side always gets its own copy of a numpy input (``torch.tensor``):
on the CPU, JAX may share the memory of a numpy array handed to it, and a
torch view of the same array then read wrong values in this file's
haversine test, one run in five.
"""

import dataclasses
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrock_tpu.algorithms import bfs as jbfs
from gunrock_tpu.algorithms import geo as jgeo
from gunrock_tpu.algorithms import mst as jmst
from gunrock_tpu.algorithms import sssp as jsssp
from gunrock_tpu.io.generators import grid2d_graph as j_grid2d_graph
from gunrock_tpu.io.generators import rmat_graph as j_rmat_graph
from gunrock_tpu.io.loader import load_graph_file as j_load_graph_file
from gunrock_tpu.ops.configs import Options as JOptions

from gunrock_tpu_torch.algorithms import bfs, geo, mst, sssp
from gunrock_tpu_torch.framework import DenseFrontier, Enactor, Problem, QueueFrontier
from gunrock_tpu_torch.graph import Graph, GraphProperties
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.ops import advance, filter_queue, uniquify
from gunrock_tpu_torch.ops.configs import AdvanceDirection, LoadBalance, Options
from gunrock_tpu_torch.utils.limits import UNREACHED

from tests.conftest import random_graph

ROOT = Path(__file__).resolve().parent.parent
CHESAPEAKE = str(ROOT / "datasets" / "chesapeake.mtx")


def to_port(jg) -> Graph:
    return Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")


def _jax_graph(name):
    if name == "chesapeake":
        return j_load_graph_file(CHESAPEAKE)[0]
    if name == "rmat10":
        return j_rmat_graph(scale=10, seed=2)
    if name == "grid32":
        return j_grid2d_graph(32, weighted=True, seed=1)
    return random_graph(None, n=300, p=0.02, symmetric=True, seed_offset=3)[0]


_CACHE = {}


def pair(name):
    if name not in _CACHE:
        jg = _jax_graph(name)
        _CACHE[name] = (jg, to_port(jg))
    return _CACHE[name]


BFS_CASES = [("chesapeake", 0), ("chesapeake", 17), ("rmat10", 0),
             ("rmat10", 5), ("grid32", 0), ("grid32", 527)]


# -- BFS Problem/Enactor ------------------------------------------------------


@pytest.mark.parametrize("name,src", BFS_CASES)
def test_bfs_run_forward_matches_jax(name, src):
    """``bfs.run`` with ``Options(FORWARD)`` goes through BfsEnactor in
    both packages: distances, predecessors and depth equal."""
    jg, tg = pair(name)
    want = jbfs.run(jg, src, options=JOptions(), warmup=False)
    got = bfs.run(tg, src, options=Options(), warmup=False, device="cpu")
    np.testing.assert_array_equal(got.distances.numpy(),
                                  np.asarray(want.distances))
    np.testing.assert_array_equal(got.predecessors.numpy(),
                                  np.asarray(want.predecessors))
    assert got.search_depth == want.search_depth
    assert got.elapsed_ms >= 0


@pytest.mark.parametrize("name,src", BFS_CASES[::2])
def test_bfs_enactor_matches_jax_enactor(name, src):
    jg, tg = pair(name)
    jstate, _ = jbfs.BfsEnactor(jbfs.BfsProblem(jg, jbfs.Param(src))).enact(
        warmup=False)
    enactor = bfs.BfsEnactor(bfs.BfsProblem(tg, bfs.Param(src)))
    state, ms = enactor.enact(warmup=True)
    for k in ("distances", "predecessors", "frontier"):
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(jstate[k]))
    assert state["iteration"] == int(jstate["iteration"])
    # the bare loop is the same search
    dist, pred, depth = bfs.bfs_kernel(tg, src)
    assert torch.equal(dist, state["distances"])
    assert torch.equal(pred, state["predecessors"])
    assert depth == state["iteration"]


def test_bfs_run_routes_non_do_options_through_the_enactor(monkeypatch):
    _, tg = pair("chesapeake")
    calls = []
    orig = bfs.BfsEnactor.loop

    def counted(self, state):
        calls.append(state["iteration"])
        return orig(self, state)

    monkeypatch.setattr(bfs.BfsEnactor, "loop", counted)
    res = bfs.run(tg, 0, options=Options(load_balance=LoadBalance.PALLAS_MERGE_PATH),
                  warmup=False, device="cpu")
    assert calls == list(range(res.search_depth))
    calls.clear()
    bfs.run(tg, 0, options=Options(advance_direction=AdvanceDirection.OPTIMIZED),
            warmup=False, device="cpu")
    assert calls == []


def test_bfs_problem_reset_is_fresh():
    _, tg = pair("chesapeake")
    prob = bfs.BfsProblem(tg, bfs.Param(3))
    s = prob.reset()
    assert int(s["distances"][3]) == 0 and int(s["frontier"].sum()) == 1
    assert int((s["distances"] == UNREACHED).sum()) == tg.n_vertices - 1
    assert (s["predecessors"] == -1).all()
    assert s["distances"] is not prob.reset()["distances"]


# -- an Enactor over frontier objects ------------------------------------------


class _QueueProblem(Problem):
    def __init__(self, graph, source):
        super().__init__(graph)
        self.source = source

    def reset(self):
        V = self.graph.n_vertices
        dist = torch.full((V,), UNREACHED, dtype=torch.int32)
        dist[self.source] = 0
        return {"frontier": QueueFrontier.from_list([self.source], V,
                                                    device="cpu"),
                "distances": dist}


class QueueBfsEnactor(Enactor):
    """A BFS as a Gunrock user writes it on the operators: the queue's
    out-edges (an edge frontier) compacted into a queue of destinations
    with repeats, filtered to the unvisited, uniquified."""

    def prepare_frontier(self):
        return self.problem.reset()

    def loop(self, state):
        g = self.problem.graph
        q, dist, it = state["frontier"], state["distances"], state["iteration"]
        active = q.to_mask(g.n_vertices)[g.edge_src.long()]
        data, count = filter_queue(g.col_indices, torch.tensor(g.n_edges),
                                   lambda x: active)
        data, count = filter_queue(data, count,
                                   lambda x: dist[x.long()] == UNREACHED)
        data, count = uniquify(data, count, g.n_vertices)
        dst = QueueFrontier(data, count)
        dist = torch.where(dst.to_mask(g.n_vertices), it + 1, dist)
        return {**state, "frontier": dst, "distances": dist}


class DenseBfsEnactor(Enactor):
    """The same search over a DenseFrontier and ``advance``."""

    def prepare_frontier(self):
        V = self.problem.graph.n_vertices
        s = self.problem.reset()
        return {"frontier": DenseFrontier.single(V, self.problem.source,
                                                 device="cpu"),
                "distances": s["distances"]}

    def loop(self, state):
        g = self.problem.graph
        dist, it = state["distances"], state["iteration"]
        _, touched = advance(g, state["frontier"].mask,
                             lambda s, d, e, w: w, "min")
        new = touched & (dist == UNREACHED)
        return {**state, "frontier": DenseFrontier(new),
                "distances": torch.where(new, it + 1, dist)}


@pytest.mark.parametrize("enactor", [QueueBfsEnactor, DenseBfsEnactor])
@pytest.mark.parametrize("name,src", BFS_CASES)
def test_enactor_runs_frontier_objects(enactor, name, src):
    """``Enactor.is_converged`` takes a frontier object through its
    ``is_empty()``: the operator-built searches equal ``bfs.run``."""
    _, tg = pair(name)
    state, _ = enactor(_QueueProblem(tg, src)).enact(warmup=False)
    want = bfs.run(tg, src, warmup=False, device="cpu")
    assert torch.equal(state["distances"], want.distances)
    assert state["iteration"] == want.search_depth
    assert bool(state["frontier"].is_empty())


def test_is_converged_reads_masks_and_frontiers():
    e = Enactor(None)
    assert bool(e.is_converged({"frontier": torch.zeros(4, dtype=torch.bool)}))
    assert not bool(e.is_converged({"frontier": torch.ones(4, dtype=torch.bool)}))
    q = QueueFrontier.with_capacity(4, device="cpu")
    assert bool(e.is_converged({"frontier": q}))
    assert not bool(e.is_converged({"frontier": q.push_back(2)}))
    assert bool(e.is_converged({"frontier": DenseFrontier.empty(3, device="cpu")}))
    out = e.is_converged({"frontier": q.push_back(1)})
    assert isinstance(out, torch.Tensor) and out.dim() == 0


# -- the algorithms' Param dataclasses -----------------------------------------

PARAMS = ("bfs", "bc", "color", "kcore", "mst", "ppr", "spmv", "tc", "geo",
          "pr", "sssp", "hits")


@pytest.mark.parametrize("name", PARAMS)
def test_param_fields_and_defaults_match_jax(name):
    j = importlib.import_module(f"gunrock_tpu.algorithms.{name}").Param
    t = importlib.import_module(f"gunrock_tpu_torch.algorithms.{name}").Param

    def fields(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert fields(t) == fields(j)


# -- geo.haversine -------------------------------------------------------------


def test_haversine_matches_jax():
    rng = np.random.default_rng(21)
    lat1, lat2 = (rng.uniform(-90, 90, 5000).astype(np.float32) for _ in "ab")
    lon1, lon2 = (rng.uniform(-180, 180, 5000).astype(np.float32) for _ in "ab")
    # near points too, but none coincident
    lat2[:500] = lat1[:500] + rng.uniform(0.01, 0.1, 500).astype(np.float32)
    lon2[:500] = lon1[:500]
    want = np.asarray(jgeo.haversine(*(jnp.asarray(a)
                                       for a in (lat1, lon1, lat2, lon2))))
    got = geo.haversine(*(torch.tensor(a)
                          for a in (lat1, lon1, lat2, lon2))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    assert got.dtype == np.float32


# -- mst.mst_kernel ------------------------------------------------------------


@pytest.mark.parametrize("name", ["chesapeake", "grid32", "random300_sym"])
@pytest.mark.parametrize("max_rounds", [None, 1, 2])
def test_mst_kernel_matches_jax(name, max_rounds):
    jg, tg = pair(name)
    jw, jmask, jn = jmst.mst_kernel(jg, max_rounds)
    w, mask, n = mst.mst_kernel(tg, max_rounds)
    np.testing.assert_allclose(float(w), float(jw), rtol=1e-5)
    assert int(n) == int(jn)
    assert mask.dtype == torch.bool and mask.shape == (tg.n_edges,)
    assert int(mask.sum()) == int(np.asarray(jmask).sum())
    np.testing.assert_allclose(float(w), mst.run(tg, device="cpu").mst_weight,
                               rtol=1e-5)


# -- sssp.sssp_do_slabbed ------------------------------------------------------


@pytest.mark.parametrize("name,src", [("chesapeake", 0), ("rmat10", 0),
                                      ("grid32", 0), ("grid32", 700)])
@pytest.mark.parametrize("rounds", [1, 3, 256])
def test_sssp_do_slabbed_matches_run(name, src, rounds):
    jg, tg = pair(name)
    dist, depth = sssp.sssp_do_slabbed(tg, src, rounds_per_dispatch=rounds)
    want = sssp.run(tg, src, options=Options(
        advance_direction=AdvanceDirection.OPTIMIZED), warmup=False,
        device="cpu")
    assert torch.equal(dist, want.distances)
    assert depth == want.search_depth
    jdist, jdepth = jsssp.sssp_do_slabbed(jg, src, rounds_per_dispatch=rounds)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-5)
    assert depth == int(jdepth)


def test_sssp_do_slabbed_with_the_kernel_layout():
    from gunrock_tpu_torch.ops.kernels.layout import pull_layout
    from gunrock_tpu_torch.ops.kernels.semiring import _BIG

    _, tg = pair("rmat10")
    lay = pull_layout(tg, window=128, chunk=128, pad_value=_BIG)
    dist, depth = sssp.sssp_do_slabbed(tg, 0, 2, layout=lay)
    want, wdepth = sssp.sssp_kernel_do(tg, 0, layout=lay)
    assert torch.equal(dist, want) and depth == wdepth
