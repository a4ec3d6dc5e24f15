"""The port's measurement path against the JAX package's, on the CPU: the
workload counters, the roofline's byte model, the device properties, the
profiler trace and its per-op stats, and the metrics JSON the CLIs export
under ``--export_metrics``. Counts and byte models are held exactly;
times only for their arithmetic (mteps from the recorded times)."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gunrock_tpu.algorithms import bfs as jbfs
from gunrock_tpu.examples import bfs as jbfs_cli
from gunrock_tpu.framework import benchmark as jbenchmark
from gunrock_tpu.io.generators import rmat_graph as j_rmat_graph
from gunrock_tpu.utils import roofline as jroofline

from gunrock_tpu_torch.algorithms import bfs
from gunrock_tpu_torch.device import properties
from gunrock_tpu_torch.framework import benchmark
from gunrock_tpu_torch.graph import Graph, GraphProperties
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.ops.kernels.layout import CHUNK, WINDOW
from gunrock_tpu_torch.utils import profiler, roofline, trace_stats

ROOT = Path(__file__).resolve().parent.parent
CHESAPEAKE = str(ROOT / "datasets" / "chesapeake.mtx")


@pytest.fixture(scope="module")
def graphs():
    jg = j_rmat_graph(scale=9, seed=5)
    tg = Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")
    return jg, tg


def test_bfs_workload_matches_jax(graphs):
    jg, tg = graphs
    deg = np.diff(tg.host["row_offsets"])
    for src in np.argsort(-deg, kind="stable")[[0, 5, 40]].tolist():
        d_t = bfs.run(tg, src, device="cpu").distances
        d_j = jbfs.run(jg, src).distances
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        w_t = benchmark.frontier_workload(
            tg, benchmark.reached_from_distances(d_t), search_depth=4)
        w_j = jbenchmark.frontier_workload(
            jg, jbenchmark.reached_from_distances(d_j), search_depth=4)
        assert dataclasses.asdict(w_t) == dataclasses.asdict(w_j)
        assert w_t.edges_visited > 0
        assert w_t.mteps(2.5) == w_j.mteps(2.5)
    assert dataclasses.asdict(benchmark.dense_workload(tg, 7)) == \
        dataclasses.asdict(jbenchmark.dense_workload(jg, 7))
    inf = np.array([0.5, np.inf, 2.0], np.float32)
    np.testing.assert_array_equal(benchmark.reached_from_distances(torch.from_numpy(inf)),
                                  jbenchmark.reached_from_distances(inf))


ALGOS = ("bfs", "sssp", "pr", "hits", "geo", "spmv", "bc", "color", "kcore",
         "mst", "ppr", "tc", "spgemm", "other")


@pytest.mark.parametrize("algo", ALGOS)
def test_model_bytes_matches_jax(algo):
    for extra in ({}, {"search_depth": 5}, {"iterations": 9}, {"rounds": 3}):
        args = (algo, 1000, 16000, 23456, extra)
        assert roofline.model_bytes(*args) == jroofline.model_bytes(*args)


def test_roofline_on_the_cpu_has_no_device_share():
    r = roofline.roofline("bfs", 1000, 16000, 23456, 2.0, {"search_depth": 5},
                          device="cpu")
    j = jroofline.roofline("bfs", 1000, 16000, 23456, 2.0, {"search_depth": 5})
    assert "pct_peak_bw" not in r and r["device"] == "cpu"
    assert r["model_mb"] == pytest.approx(j["model_mb"], abs=0.005)
    assert r["gbps"] == pytest.approx(j["gbps"], abs=5e-4)
    assert roofline.roofline("bfs", 1, 1, 1, 0.0, {}, device="cpu") == {}
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.bound_ms(1e6, device="cpu")


def test_device_properties_cpu_and_no_card():
    cpu = properties.get_device_properties("cpu")
    assert cpu.platform == "cpu" and cpu.peak_bytes_per_s is None
    assert cpu.peak_f32_per_s is None and cpu.name_power_limit == "cpu, not measured"
    if torch.cuda.is_available():
        pytest.skip("a card is present: asking for it does not raise")
    with pytest.raises(RuntimeError, match="cuda"):
        properties.get_device_properties()


@pytest.mark.parametrize("name,peaks", [
    ("NVIDIA H100 80GB HBM3", (3.35e12, 67e12)),
    ("NVIDIA H100 PCIe", (None, None)),  # another card: no borrowed peaks
])
def test_card_peaks_by_name(monkeypatch, name, peaks):
    """A card's peaks come from its name; one not in the table has none.
    torch.cuda's answers are stood in for, as there is no card here."""
    fake = type("P", (), dict(multi_processor_count=132, total_memory=80 << 30,
                              L2_cache_size=50 << 20, warp_size=32))()
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: fake)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: name)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(properties, "_smi_power_limit", lambda i: "700.00 W")
    p = properties._cuda_properties.__wrapped__(0)
    assert (p.peak_bytes_per_s, p.peak_f32_per_s) == peaks
    assert p.name_power_limit == f"{name}, 700.00 W" and p.sm_count == 132


def test_launch_params_report_the_layouts_windows():
    assert properties.launch_params() == properties.LaunchParams(WINDOW, CHUNK)
    assert properties.launch_params("pr", 1 << 18) == properties.LaunchParams(4096, 1024)
    assert properties.launch_params("hits", 1 << 10) == properties.LaunchParams(WINDOW, CHUNK)
    assert properties.launch_params("bfs", 1 << 18) == properties.LaunchParams(WINDOW, CHUNK)


def test_trace_and_device_op_stats_on_a_cpu_bfs(graphs, tmp_path):
    _, tg = graphs
    with profiler.trace(str(tmp_path)) as log_dir:
        with profiler.annotate("bfs_under_trace"):
            bfs.run(tg, 0, device="cpu")
    path = trace_stats.latest_trace_file(log_dir)
    assert path is not None and path.endswith(".pt.trace.json")
    names = {e.get("name") for e in json.loads(Path(path).read_text())["traceEvents"]}
    assert "bfs_under_trace" in names
    rows = trace_stats.device_op_stats(log_dir, top=8)
    assert 0 < len(rows) <= 8
    assert all(set(r) == {"name", "occurrences", "total_ms", "avg_us"} for r in rows)
    totals = [r["total_ms"] for r in rows]
    assert totals == sorted(totals, reverse=True) and totals[0] > 0
    for r in rows:
        assert r["avg_us"] == pytest.approx(r["total_ms"] * 1e3 / r["occurrences"])
    assert trace_stats.device_busy_ms(log_dir) is None  # no device events
    table = trace_stats.measured_kernel_table(log_dir, 1e6, top=3)
    assert table["trace_device_ms"] == pytest.approx(sum(totals[:3]))
    assert table["gbps_measured"] > 0
    assert trace_stats.device_op_stats(str(tmp_path / "none")) == []


def test_device_busy_counts_an_annotated_kernel_once():
    """A kernel inside a ``kernel.*`` span shows twice in a card's
    ``key_averages()``: as itself and in the span's device-side copy (a
    user annotation). Busy time counts it once, and host ops not at
    all."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def avg(key, device_type, us, annotation):
        return SimpleNamespace(key=key, device_type=device_type, count=1,
                               self_device_time_total=us,
                               is_user_annotation=annotation)

    kernel = avg("gr_bfs_predecessors_kernel", DeviceType.CUDA, 85.0, False)
    averages = [avg("kernel.bfs_predecessors", DeviceType.CUDA, 85.0, True),
                kernel,
                avg("aten::empty", DeviceType.CPU, 85.0, False),
                avg("kernel.bfs_predecessors", DeviceType.CPU, 0.0, True)]
    assert trace_stats.device_events(averages) == [kernel]


def test_profiler_marks_spans_as_user_annotations():
    """The attribute ``device_events`` reads is torch's own: a port span
    under torch.profiler is a user annotation, an op is not."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiler.annotate("kernel.under_test"):
            torch.ones(4).add_(1)
    marks = {e.key: e.is_user_annotation for e in prof.key_averages()}
    assert marks["kernel.under_test"] is True
    assert marks["aten::add_"] is False


def _export(main, tmp_path, argv, name):
    assert main(["--market", CHESAPEAKE, "--export_metrics", "-d",
                 str(tmp_path), "-f", name, "-t", "smoke,cpu", *argv]) in (0, None)
    return json.loads((tmp_path / name).read_text())


def test_bfs_export_matches_jax(tmp_path):
    from gunrock_tpu_torch.examples import bfs as tbfs_cli

    t = _export(tbfs_cli.main, tmp_path, ["--src", "0", "-n", "2",
                                          "--device", "cpu"], "port.json")
    j = _export(jbfs_cli.main, tmp_path, ["--src", "0", "-n", "2"], "jax.json")
    assert set(t) == set(j)
    for k in ("schema", "primitive", "num_vertices", "num_edges",
              "edges_visited", "nodes_visited", "search_depths", "srcs",
              "tags", "graph_type"):
        assert t[k] == j[k], k
    assert t["engine"] == "gunrock_tpu_torch" and t["compiler"] == "torch/CUDA"
    assert t["gpuinfo"]["name"] == "cpu" and t["gpuinfo"]["power_limit"]
    assert t["tags"] == ["smoke", "cpu"] and len(t["process_times"]) == 2
    for m, ms in zip(t["mteps"], t["process_times"]):
        assert m == t["edges_visited"] / ms / 1000


# the fourteen finish calls of the fourteen CLIs' paths (pr twice)
CLIS = [
    ("bfs", ["--src", "0"]), ("sssp", ["--src", "0"]), ("pr", []),
    ("pr", ["--alphas", "0.8,0.9"]), ("hits", []), ("spmv", []),
    ("color", []), ("mst", []), ("kcore", []), ("ppr", ["--src", "0"]),
    ("bc", ["--src", "0"]), ("tc", []), ("spgemm", []), ("geo", []),
]


@pytest.mark.parametrize("algo,argv", CLIS,
                         ids=[a + ("_batch" if v[:1] == ["--alphas"] else "")
                              for a, v in CLIS])
def test_every_cli_exports_its_metrics(tmp_path, algo, argv):
    import importlib

    cli = importlib.import_module(f"gunrock_tpu_torch.examples.{algo}")
    out = _export(cli.main, tmp_path, [*argv, "--device", "cpu"], "m.json")
    assert out["primitive"] == algo and out["engine"] == "gunrock_tpu_torch"
    assert out["schema"] == "2022-10-28" and out["num_vertices"] == 39
    assert out["num_edges"] == 340 and out["tags"] == ["smoke", "cpu"]
    assert len(out["process_times"]) == 1 and out["gpuinfo"]["platform"] == "cpu"
    if "--src" in argv:
        assert out["srcs"] == [0]
    if algo in ("bfs", "sssp"):
        assert out["edges_visited"] == 340 and out["nodes_visited"] == 39
    if algo in ("pr", "hits"):
        assert len(out["search_depths"]) == 1 and out["search_depths"][0] > 0
    if algo == "pr":
        k = 2 if argv else 1
        assert out["edges_visited"] == 340 * out["search_depths"][0] * k
    if algo == "spmv":
        assert (out["edges_visited"], out["nodes_visited"]) == (340, 39)


def test_timer_takes_jax_calls():
    """``end(*arrays)``, ``milliseconds()`` and ``reset()`` in both
    packages, called the same way; ``timed`` still times one call."""
    import jax.numpy as jnp

    from gunrock_tpu.utils.timer import Timer as JTimer
    from gunrock_tpu_torch.utils.timer import Timer, timed

    for timer, x in ((JTimer(), jnp.ones(8)), (Timer("cpu"), torch.ones(8))):
        assert timer.milliseconds() == 0.0
        timer.begin()
        ms = timer.end(x, (x, [x]), {"x": x})
        assert isinstance(ms, float) and ms >= 0.0
        assert timer.milliseconds() == ms
        timer.begin()
        assert timer.end() == timer.milliseconds() >= 0.0
        timer.reset()
        assert timer.milliseconds() == 0.0
    out, ms = timed("cpu", lambda: torch.arange(3).sum())
    assert int(out) == 3 and ms >= 0.0
