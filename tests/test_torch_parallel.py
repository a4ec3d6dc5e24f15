"""The port's mesh, collectives and distributed entry points
(``gunrock_tpu_torch/parallel``), and the CLIs' ``--devices``, on gloo CPU
ranks.

- a 2x2 ``make_mesh_2d`` run of bfs, sssp, pagerank and kcore in both
  exchange modes equals the flat mesh's bit for bit (the halo mode goes
  through the two-stage all_to_all), and the JAX package's 2x2 run;
- every collective (``probes.mesh.collectives_probe``) on the flat and
  the 2x2 mesh equals its numpy answer, the two-stage all_to_all the
  flat one;
- ``tc`` and ``tc_replicated`` equal the single-device ``tc.run``;
- the package's exports, a fresh import free of jax in this process and in
  a spawned rank, the device and backend rule, a failing rank;
- the bfs, sssp, pr and tc CLIs with ``--devices 4 --validate`` on the
  vendored chesapeake graph, and the refusals the JAX CLIs make;
- a round's pieces per rank (``probes.mesh.round_costs``) on the CPU.

Each mesh's ranks start once for the module.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gunrock_tpu.parallel import sharded as jsharded
from gunrock_tpu.parallel.mesh import make_mesh_2d as j_make_mesh_2d
from gunrock_tpu_torch.algorithms import tc as ttc
from gunrock_tpu_torch.examples import bfs as bfs_cli
from gunrock_tpu_torch.examples import pr as pr_cli
from gunrock_tpu_torch.examples import sssp as sssp_cli
from gunrock_tpu_torch.examples import tc as tc_cli
from gunrock_tpu_torch.graph import Graph, GraphProperties
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch import parallel as tparallel
from gunrock_tpu_torch.parallel import algorithms as talg
from gunrock_tpu_torch.parallel import mesh as tmesh
from gunrock_tpu_torch.probes import mesh as mesh_probe
from tests.conftest import random_graph

N = 4
V = 103
CHESAPEAKE = str(Path(__file__).resolve().parent.parent / "datasets"
                 / "chesapeake.mtx")
MODES = {"allgather": False, "halo": True}
ON_2D = [("bfs", [0], {}), ("sssp", [0], {}), ("pagerank", [], {}),
         ("kcore", [], {})]


def port_graph(jg) -> Graph:
    return Graph.from_arrays(
        {k: np.array(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")


@pytest.fixture(scope="module")
def graphs():
    jd, _ = random_graph(None, n=V, p=0.06, weighted=True, seed_offset=60)
    js, _ = random_graph(None, n=V, p=0.07, weighted=True, symmetric=True,
                         seed_offset=61)
    return {"dir": jd, "sym": js}


def _cases():
    cases = [{"name": "collectives", "algo": "collectives",
              "kwargs": {"seed": 7}}]
    for mode, halo in MODES.items():
        for algo, args, kw in ON_2D:
            cases.append({"name": f"{algo}-{mode}", "algo": algo,
                          "graph": "sym" if algo == "kcore" else "dir",
                          "use_halo": halo, "args": args, "kwargs": kw})
    return cases


@pytest.fixture(scope="module")
def runs(graphs):
    """(flat run, 2x2 run): the same cases on both meshes; the flat one
    also runs the two distributed triangle counts and a round's pieces."""
    tg = {k: port_graph(g) for k, g in graphs.items()}
    flat_cases = _cases() + [
        {"name": algo, "algo": algo, "graph": "sym"}
        for algo in ("tc", "tc_replicated")] + [
        {"name": "round", "algo": "round", "graph": "dir", "args": [0]}]
    flat = tmesh.spawn(mesh_probe.run_cases, N, tg, flat_cases, "cpu",
                       device="cpu")
    two = tmesh.spawn(mesh_probe.run_cases, N, tg, _cases(), "cpu", (2, 2),
                      device="cpu")
    return ({c["name"]: c for c in flat["cases"]},
            {c["name"]: c for c in two["cases"]}, flat, two)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("algo", [a for a, _, _ in ON_2D])
def test_2d_mesh_equals_flat(runs, algo, mode):
    flat, two, _, _ = runs
    a, b = flat[f"{algo}-{mode}"]["result"], two[f"{algo}-{mode}"]["result"]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("algo", [a for a, _, _ in ON_2D])
def test_2d_mesh_matches_jax(graphs, runs, algo, mode):
    """The 2x2 run against the JAX package's on its (2, 2) mesh of four
    virtual devices: exact for BFS and k-core, SSSP within rtol 1e-5,
    PageRank within rtol 1e-4 (ROADMAP C)."""
    _, two, _, _ = runs
    jg = graphs["sym" if algo == "kcore" else "dir"]
    mesh = j_make_mesh_2d(2, 2)
    sg = jsharded.partition_sharded(jg, N, mesh, use_halo=MODES[mode])
    args = [a for n, a, _ in ON_2D if n == algo][0]
    want = getattr(jsharded, algo)(sg, *args, mesh)
    got = two[f"{algo}-{mode}"]["result"]
    if algo == "pagerank":
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-4,
                                   atol=1e-9)
    elif algo == "sssp":
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5)
    else:
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1] == want[1]


@pytest.mark.parametrize("which", ["flat", "2x2"])
def test_collectives_probe(runs, which):
    """Every collective gives its numpy answer on every rank; over the 2x2
    mesh the two-stage all_to_all equals the flat one."""
    _, _, flat, two = runs
    info, shape = (flat, (N,)) if which == "flat" else (two, (2, 2))
    got = {c["name"]: c for c in info["cases"]}["collectives"]["result"]
    want = mesh_probe.collectives_expected(7, N, shape=shape)
    for r in range(N):
        g, w = got["ranks"][r], want[r]
        assert set(g) == set(w)
        for k in w:
            if k in ("psum",):  # the ranks' sum order is gloo's
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6)
            else:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(w[k]), err_msg=k)


@pytest.mark.parametrize("algo", ["tc", "tc_replicated"])
def test_distributed_tc_equals_single_device(graphs, runs, algo):
    flat, _, _, _ = runs
    counts, total = flat[algo]["result"]
    want = ttc.run(port_graph(graphs["sym"]), device="cpu")
    np.testing.assert_array_equal(counts,
                                  want.vertex_triangles_count.numpy())
    assert total == want.total_triangles_count


def test_ranks_report_backend_and_no_jax(runs):
    _, _, flat, two = runs
    for info in (flat, two):
        assert info["backend"] == "gloo" and not info["staged"]
        assert info["foreign_modules"] == [[]] * N


def test_exports():
    """What ``gunrock_tpu.parallel`` exports, plus ``make_mesh_2d``,
    ``spawn`` and the fourteen sharded entry points."""
    import gunrock_tpu.parallel as jparallel

    for name in ("make_mesh", "ShardedGraph", "partition_sharded",
                 "algorithms"):
        assert hasattr(jparallel, name) and hasattr(tparallel, name)
    for name in ("make_mesh_2d", "spawn", "bfs", "sssp", "pagerank", "spmv",
                 "hits", "kcore", "ppr", "color", "color_greedy", "bc",
                 "geo", "mst", "spgemm_count", "tc_ring"):
        assert callable(getattr(tparallel, name)), name
    for name in ("tc", "tc_replicated", "bfs", "tc_ring"):
        assert callable(getattr(talg, name)), name


def test_fresh_import_loads_no_jax():
    code = ("import sys, gunrock_tpu_torch.parallel, "
            "gunrock_tpu_torch.examples.runner, "
            "gunrock_tpu_torch.probes.mesh\n"
            "print([m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'gunrock_tpu')])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_device_and_backend_rule(monkeypatch):
    assert tmesh.backend_for("cpu", 4) == "gloo"
    assert tmesh.rank_device("cpu", 3) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh.backend_for("cuda", 1) == "nccl"
    assert tmesh.backend_for("cuda", 4) == "gloo"  # four ranks, one card
    assert tmesh.rank_device("cuda", 3) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.backend_for("cuda", 4) == "nccl"
    assert tmesh.rank_device("cuda", 3) == torch.device("cuda", 3)


def test_no_card_no_cpu_run():
    """device="cuda" without a card raises before any rank starts."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.spawn(mesh_probe.run_cases, 2, {}, [], "cuda")


def test_make_mesh_outside_a_rank_raises():
    with pytest.raises(RuntimeError, match="inside a rank"):
        tmesh.make_mesh(device="cpu")


def test_a_failing_rank_fails_spawn():
    with pytest.raises(Exception, match="KeyError"):
        tmesh.spawn(mesh_probe.run_cases, 2, {},
                    [{"algo": "bfs", "graph": "x"}], "cpu", device="cpu")


@pytest.mark.parametrize("cli,extra", [
    (bfs_cli, ["--src", "0"]),
    (sssp_cli, ["--src", "0"]),
    (pr_cli, []),
    (tc_cli, ["-r"]),
], ids=["bfs", "sssp", "pr", "tc"])
def test_cli_devices_validates(cli, extra, capsys):
    argv = ["--market", CHESAPEAKE, "--device", "cpu", "--devices", "4",
            "--validate", *extra]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "distributed: 4 ranks, backend gloo, on the CPU" in out
    assert "validation: PASSED" in out and "FAILED" not in out


@pytest.mark.parametrize("cli,extra,message", [
    (bfs_cli, ["--src", "0", "--mode", "async"], "single-chip"),
    (sssp_cli, ["--src", "0", "--mode", "async"], "single-chip"),
    (pr_cli, ["--alphas", "0.8,0.85"], "mutually exclusive"),
], ids=["bfs_async", "sssp_async", "pr_alphas"])
def test_cli_devices_refusals(cli, extra, message, capsys):
    argv = ["--market", CHESAPEAKE, "--device", "cpu", "--devices", "4",
            *extra]
    assert cli.main(argv) == 1
    out = capsys.readouterr().out
    assert message in out and "distributed:" not in out


def test_mesh_probe_on_the_cpu(graphs, runs):
    """``probes.mesh.round_costs``: every rank's timings of a round's
    pieces, in rank order, its shard's edges summing to the graph's; no
    profile on the CPU."""
    flat, _, _, _ = runs
    ranks = flat["round"]["result"]
    assert [r["rank"] for r in ranks] == list(range(N))
    for r in ranks:
        for k in ("all_gather_f32_ms", "all_gather_bool_ms",
                  "pmax_scalar_ms", "loop_test_ms", "round_local_ms"):
            assert r[k] > 0, k
        assert "bfs_profile" not in r
    assert sum(r["edges"] for r in ranks) == graphs["dir"].n_edges
