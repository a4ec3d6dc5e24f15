"""The edge-balanced BFS push step (``csrc/bfs_push.cu``), the probe
gather's split index math (P2, ``csrc/probes.cu``) and the port's
top-level names, on the CPU, where no CUDA kernel runs.

- The push step: one cooperative launch on ``gr::expand_frontier``
  (modelled by ``tests/test_torch_push_mincut.expansion``). Phase 1 clears
  the new mask over each block's vertex range (``own``); phase 3 takes
  each out-edge of the frontier once and claims an unreached neighbour
  with a compare-and-swap (``relax``). The model, in thread order and in
  a random order, against the plain version and the JAX ``bfs_push_step``
  over every frontier of one search on R-MAT 9, the top-degree vertex
  alone and the full frontier, with grids of 1, 4 and 132 blocks.
- The gather: four consecutive outputs a thread, the split of an output
  into (outer, axis, inner) by a multiply-high (``FastDiv``), one split
  a group where the rows hold whole groups of four; against
  ``np.take_along_axis`` at every shape of ``probes/gather.py`` and
  ``probes/gather2.py``, a 3-D tensor on each axis, and flat, with ragged
  tails and an unaligned idx.
- The two packages' top-level names, and the pull probe's ``--bfs_push``
  lines.
"""

import json
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrock_tpu
import gunrock_tpu_torch
from gunrock_tpu.algorithms import bfs as jbfs
from gunrock_tpu.graph.reorder import degree_sort as j_degree_sort
from gunrock_tpu.io.generators import rmat_graph as j_rmat_graph

from gunrock_tpu_torch.algorithms import bfs
from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.probes import _gather_shape, gather
from gunrock_tpu_torch.probes import gather as pgather
from gunrock_tpu_torch.probes import gather2 as pgather2
from gunrock_tpu_torch.utils.limits import UNREACHED
from tests.test_torch_push_mincut import expansion, port_graph

# -- the push step ------------------------------------------------------------


def model_bfs_push(graph, front, dist, level, grid, order_seed=None):
    """(new_mask, distances) as push_step makes them with ``grid`` blocks:
    new_mask filled with garbage, cleared by each block over its range,
    then every out-edge of the frontier relaxed once (in thread order, or
    in a random order from ``order_seed``), a neighbour read as UNREACHED
    claimed by a compare-and-swap that writes ``level``."""
    V = front.size
    offsets = graph.row_offsets.numpy().astype(np.int64)
    new_mask = np.ones(V, bool)  # torch.empty: anything
    per = -(-V // grid)
    for b in range(grid):  # phase 1: own(v) over block b's range
        new_mask[min(V, b * per):min(V, b * per + per)] = False
    dist = dist.copy()
    _, e = expansion(front, offsets, grid)
    u = graph.col_indices.numpy()[e]
    order = np.arange(u.size)
    if order_seed is not None:
        order = np.random.default_rng(order_seed).permutation(u.size)
    for k in order:  # phase 3: relax(v, e), atomicCAS(&dist[u], UNREACHED, level)
        if dist[u[k]] == UNREACHED:
            dist[u[k]] = level
            new_mask[u[k]] = True
    return new_mask, dist


@pytest.fixture(scope="module")
def bfs_graphs():
    """(JAX graph, port graph): R-MAT scale 9, degree-sorted."""
    jg, _ = j_degree_sort(j_rmat_graph(scale=9, seed=1))
    return jg, port_graph(jg)


def bfs_push_cases(tg):
    """(what, frontier, distances, iteration): every frontier of a search
    from the top-degree vertex (the plain level-synchronous step), every
    vertex at once over the search's middle distances, and that vertex
    alone over them with every other of its out-neighbours unreached
    again (so that it claims some and skips the rest)."""
    V = tg.n_vertices
    hub = int(torch.argmax(tg.out_degrees()))
    dist = torch.full((V,), UNREACHED, dtype=torch.int32)
    dist[hub] = 0
    front = torch.zeros(V, dtype=torch.bool)
    front[hub] = True
    cases = []
    while bool(front.any()):
        it = len(cases)
        cases.append((f"level {it}", front, dist, it))
        front, dist, _ = bfs.bfs_step(tg, front, dist, None, it)
    _, _, d_mid, it_mid = cases[len(cases) // 2]
    d_hub = d_mid.clone()
    d_hub[tg.col_indices[tg.row_offsets[hub]:tg.row_offsets[hub + 1]:2].long()] = UNREACHED
    alone = torch.zeros(V, dtype=torch.bool)
    alone[hub] = True
    return cases + [("single hub", alone, d_hub, it_mid),
                    ("full frontier", torch.ones_like(alone), d_mid, it_mid)]


@pytest.mark.parametrize("grid", [1, 4, 132])
def test_push_step_model_matches_plain_and_jax(bfs_graphs, grid):
    jg, tg = bfs_graphs
    cases = bfs_push_cases(tg)
    assert len(cases) >= 5
    budget = tg.n_edges + tg.n_vertices  # JAX's fixed expansion: all of it
    for what, front, dist, it in cases:
        new_j, dist_j = jbfs.bfs_push_step(
            jg, jnp.asarray(front.numpy()), jnp.asarray(dist.numpy()), it,
            budget)
        new_p, dist_p = bfs.bfs_push_step_plain(tg, front, dist.clone(), it)
        got = [model_bfs_push(tg, front.numpy(), dist.numpy(), it + 1, grid),
               model_bfs_push(tg, front.numpy(), dist.numpy(), it + 1, grid,
                              order_seed=grid),
               (new_p.numpy(), dist_p.numpy())]
        for new, d in got:
            np.testing.assert_array_equal(new, np.asarray(new_j), err_msg=what)
            np.testing.assert_array_equal(d, np.asarray(dist_j), err_msg=what)


@pytest.mark.parametrize("what", ["single hub", "full frontier"])
def test_push_step_entry_point_on_hub_and_full_frontier(bfs_graphs, what):
    """The port's entry point (the plain version on the CPU) updates the
    distances in place and returns the JAX step's new mask."""
    jg, tg = bfs_graphs
    _, front, dist, it = {c[0]: c for c in bfs_push_cases(tg)}[what]
    d = dist.clone()
    new_t, d_t = bfs.bfs_push_step(tg, front, d, it, 0)
    new_j, dist_j = jbfs.bfs_push_step(
        jg, jnp.asarray(front.numpy()), jnp.asarray(dist.numpy()), it,
        tg.n_edges + tg.n_vertices)
    assert d_t is d
    np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))
    np.testing.assert_array_equal(d.numpy(), np.asarray(dist_j))
    assert bool(new_t.any())


def test_push_step_scratch_fits_the_expansion():
    """scratch = [block counts | queue | first]: 2 * max_blocks + 2 * V
    int32, as sssp_push.cu's and expand.cuh's layout (queue at 2 *
    max_blocks, first V after it), the grid never above max_blocks, and
    no memset or second kernel."""
    assert bfs._BLOCKS_PER_SM == 4
    text = (_build.CSRC / "bfs_push.cu").read_text()
    assert "x.queue = x.block_counts + 2 * max_blocks;" in text
    assert "x.first = x.queue + n_vertices;" in text
    assert "if (blocks > max_blocks) blocks = max_blocks;" in text
    assert "cudaMemsetAsync" not in text and "push_expand" not in text
    assert "compact_frontier" not in (_build.CSRC / "common.cuh").read_text()
    assert "scratch = torch.empty(2 * max_blocks + 2 * V" in open(bfs.__file__).read()


# -- the gather's split index math ---------------------------------------------


def fast_div(d):
    """(mul, shift) of csrc/probes.cu's fast_div: n // d == (n * mul >> 32)
    >> shift for n in [0, 2^31); d == 1 is the identity."""
    if d == 1:
        return 0, 0
    L = 0
    while (1 << L) < d:
        L += 1
    return ((1 << (31 + L)) + d - 1) // d, L - 1


def div(n, f, d):
    """FastDiv::div on an int64 array of n (the product kept in uint64)."""
    mul, shift = f
    if d == 1:
        return n
    return ((n.astype(np.uint64) * np.uint64(mul)) >> np.uint64(32 + shift)).astype(np.int64)


def model_gather(x, idx, axis, aligned=True):
    """What the 32-bit kernel writes: thread g takes outputs 4g .. 4g + 3;
    a group shares one split where the rows hold whole groups of four
    (and idx is 16-byte aligned), else each output is split on its own.
    Returns (out, whether the group path ran)."""
    inner, n_axis_idx, n_axis_x = _gather_shape(torch.from_numpy(x),
                                                torch.from_numpy(idx), axis)
    n_out = idx.size
    assert n_out < 2 ** 31 and x.size < 2 ** 31  # the 32-bit path
    by_inner, by_axis = fast_div(inner), fast_div(n_axis_idx)
    flat_idx = idx.reshape(-1).astype(np.int64)
    rows4 = (inner == 1 and n_axis_idx % 4 == 0) or inner % 4 == 0
    vec = rows4 and aligned
    out = np.full(n_out, np.nan, np.float32)
    n_groups = (n_out - 1) // 4 + 1
    o0 = 4 * np.arange(n_groups, dtype=np.int64)
    if vec:
        q = div(o0, by_inner, inner)
        inner_i = o0 - q * inner
        outer = div(q, by_axis, n_axis_idx)
        base = outer * n_axis_x
        step = 0 if inner == 1 else 1
        for k in range(4):
            i = flat_idx[o0 + k]
            xi = (base + i) * inner + inner_i + step * k
            # the group never leaves its row: o0 + k has the same outer
            # and, where inner > 1, the same axis index and inner_i + k
            o = o0 + k
            assert (o // (inner * n_axis_idx) == outer).all()
            if inner > 1:
                assert (o // inner == q).all() and (o % inner == inner_i + k).all()
            out[o] = x.reshape(-1)[xi]
    else:
        for k in range(4):
            o = o0 + k
            o = o[o < n_out]  # the ragged tail
            i = flat_idx[o]
            q = div(o, by_inner, inner)
            outer = div(q, by_axis, n_axis_idx)
            out[o] = x.reshape(-1)[(outer * n_axis_x + i) * inner + (o - q * inner)]
    return out.reshape(idx.shape), vec


def probe_shapes():
    """(name, x, idx, axis) at every shape of the two gather probes."""
    out = []
    for module in (pgather, pgather2):
        for v in module.VARIANTS:
            x, idx, axis = module.inputs(v)[:3]
            out.append((f"{module.__name__.rsplit('.', 1)[1]}:{v}", x, idx, axis))
    return out


@pytest.mark.parametrize("case", probe_shapes(), ids=lambda c: c[0])
def test_gather_model_at_probe_shapes(case):
    _, x, idx, axis = case
    want = (x.reshape(-1)[idx] if axis is None
            else np.take_along_axis(x, idx, axis=axis))
    got, vec = model_gather(x, idx, axis)
    np.testing.assert_array_equal(got, want)
    # every probe shape holds whole groups of four in its rows
    assert vec
    np.testing.assert_array_equal(
        gather(torch.from_numpy(x), torch.from_numpy(idx), axis).numpy(), want)


@pytest.mark.parametrize("dims", [(3, 5, 7), (3, 8, 12), (5, 4, 9)])
@pytest.mark.parametrize("axis", [0, 1, 2, None])
@pytest.mark.parametrize("aligned", [True, False])
def test_gather_model_on_3d_and_flat(dims, axis, aligned):
    """A 3-D tensor on each axis with another index count on the axis, and
    flat with a ragged tail; ``aligned=False`` is the unaligned idx the
    kernel takes one output at a time."""
    rng = np.random.default_rng(sum(dims))
    x = rng.standard_normal(dims, dtype=np.float32)
    if axis is None:
        idx = rng.integers(0, x.size, 2 * x.size + 3, dtype=np.int32)
        want = x.reshape(-1)[idx]
    else:
        shape = list(dims)
        shape[axis] = 6
        idx = rng.integers(0, dims[axis], shape, dtype=np.int32)
        want = np.take_along_axis(x, idx, axis=axis)
    got, _ = model_gather(x, idx, axis, aligned)
    np.testing.assert_array_equal(got, want)


def test_fast_div_matches_floor_division():
    """Every divisor of the probes' shapes, small and awkward ones, powers
    of two and the largest, on dividends across [0, 2^31)."""
    rng = np.random.default_rng(0)
    divisors = [1, 2, 3, 4, 5, 6, 7, 8, 12, 35, 96, 100, 127, 128, 129, 256,
                1000, 4095, 4096, 4097, 65535, 2 ** 20 + 1, 2 ** 30 - 1,
                2 ** 30, 2 ** 30 + 1, 2 ** 31 - 1]
    n = np.concatenate([np.arange(5000), 2 ** 31 - 1 - np.arange(5000),
                        rng.integers(0, 2 ** 31, 100_000)]).astype(np.int64)
    for d in divisors:
        f = fast_div(d)
        assert 0 <= f[0] < 2 ** 32
        np.testing.assert_array_equal(div(n, f, d), n // d, err_msg=f"d={d}")
        np.testing.assert_array_equal(div(d * (n // d), f, d), n // d)


# -- the packages' top-level names ---------------------------------------------


def _names(pkg):
    return {n for n, v in vars(pkg).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


def test_toplevel_names_match_the_jax_package():
    """The same entry points and classes at the top of both packages, the
    frontier classes among them."""
    assert _names(gunrock_tpu_torch) == _names(gunrock_tpu)
    assert {"DenseFrontier", "QueueFrontier"} <= _names(gunrock_tpu_torch)
    for pkg in (gunrock_tpu, gunrock_tpu_torch):
        assert isinstance(pkg.algorithms, types.ModuleType)


ALGORITHMS = ("bfs", "sssp", "pr", "spmv", "hits", "color", "kcore", "tc",
              "bc", "ppr", "mst", "geo", "spgemm")


@pytest.mark.parametrize("name", ALGORITHMS)
def test_algorithm_modules_under_both_packages(name):
    assert isinstance(getattr(gunrock_tpu.algorithms, name), types.ModuleType)
    mod = getattr(gunrock_tpu_torch.algorithms, name)
    assert mod.__name__ == f"gunrock_tpu_torch.algorithms.{name}"
    assert callable(mod.run)


def test_fresh_import_exports_and_pulls_in_no_jax():
    """A fresh import of the package, of the operator layer's modules and
    of the async sweep, the .smtx loader, the error helpers and the native
    IO loads no jax and nothing of gunrock_tpu."""
    code = (
        "import sys, gunrock_tpu_torch as g\n"
        "import gunrock_tpu_torch.ops, gunrock_tpu_torch.framework.frontier\n"
        "import gunrock_tpu_torch.io.sample, gunrock_tpu_torch.examples.regression\n"
        "import gunrock_tpu_torch.ops.search, gunrock_tpu_torch.ops.random\n"
        "import gunrock_tpu_torch.experimental.async_sweep, gunrock_tpu_torch.io.smtx\n"
        "import gunrock_tpu_torch.utils.error, gunrock_tpu_torch.ops.kernels.async_sweep\n"
        "import gunrock_tpu_torch._native\n"
        "missing = [n for n in ('bc_run', 'geo_run', 'spgemm_run', 'tc_run',"
        " 'algorithms') if not hasattr(g, n)]\n"
        f"missing += [n for n in {ALGORITHMS!r} if not hasattr(g.algorithms, n)]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'gunrock_tpu')]\n"
        "print(missing, bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[] []"


# -- the pull probe's --bfs_push lines ------------------------------------------


def test_pull_probe_bfs_push_lines(capsys):
    """On the CPU: the bfs_push_passes line with one entry per push step of
    the eight searches, the largest step's case, and the crossover line
    with one entry per level, pushed or pulled; no device time off the
    card."""
    from gunrock_tpu_torch.probes import pull

    assert pull.main(["--scale", "8", "--device", "cpu", "--num_runs", "1",
                      "--bfs_push"]) == 0
    rows = {r["case"]: r for r in map(json.loads,
                                      capsys.readouterr().out.splitlines())}
    line = rows["bfs_push_passes"]
    assert line["searches"] == 8
    assert line["steps"] == len(line["out_edges"]) == len(line["new"]) > 0
    assert line["device_ms_total"] == "not measured"
    largest = rows["bfs_push_largest"]
    assert largest["out_edges"] == max(line["out_edges"])
    levels = rows["bfs_crossover"]["levels"]
    assert sum(lv["taken"] == "push" for lv in levels) == line["steps"]
    assert {lv["search"] for lv in levels} == set(range(8))
    assert all(lv["push_device_ms"] == "not measured" for lv in levels)


def test_recorded_levels_replay_the_search(bfs_graphs):
    """bfs_levels keeps each level's distances from before the step, so
    replaying the recorded levels in order rebuilds the search's result."""
    from gunrock_tpu_torch.probes.pull import bfs_levels

    _, tg = bfs_graphs
    hub = int(torch.argmax(tg.out_degrees()))
    levels = bfs_levels(tg, [hub])
    want = bfs.run(tg, hub, device="cpu").distances
    dist = None
    for _, kind, args in levels:
        dist = args[2].clone()
        if kind == "push":
            bfs.bfs_push_step(args[0], args[1], dist, *args[3:])
        else:
            bfs._pull(args[0], args[1], dist, args[3])
    np.testing.assert_array_equal(dist.numpy(), want.numpy())
    assert {kind for _, kind, _ in levels} <= {"push", "pull"}
