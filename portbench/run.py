"""The benchmark of ``gunrock_tpu_torch`` on NVIDIA GPUs: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's configuration, traffic mix,
entry point, limits and metric readers are found by name from
``BENCHMARK.json`` (see ``portbench/README.md``). With ``--trace 0`` the
run reports the cell's end-to-end metrics; with ``--trace 1`` it profiles
the first seconds of the window and reports the per-layer metrics, the
device's busy time and a breakdown. The last line of standard output is
one JSON object; the numbers compared for ``correct`` are the last lines
of standard error and the last key of that object.

Exit codes: 0 with a result; 2 without a card, or with fewer cards than
the cell asks for; 3 when a module of JAX or of the JAX package is
loaded; 1 on any other error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the port builds its kernels into gunrock_tpu_torch/_build in the
# checkout; the driver's JIT cache goes to a fixed path there too
os.environ["CUDA_CACHE_PATH"] = str(ROOT / ".portbench_cache" / "cuda")
os.environ.setdefault("OMP_NUM_THREADS", "4")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that no run may load (compared whole: the port's
# own name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "gunrock_tpu")
TRACE_SECONDS = 3.0  # the profiled part of a --trace 1 window


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _trace_window(cell, seconds: float):
    """The window under torch.profiler: (queries, window seconds, sampler,
    TraceSummary)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.profile import read_trace

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        queries, window_s, sampler = cell.window(seconds)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        summary = read_trace(path)
    return queries, window_s, sampler, summary


def measure(cell, seconds: float, trace: bool) -> tuple[dict, dict]:
    """Set-up, window and check of ``cell``: (the result object, the check
    table). The metric readers (``portbench/metrics/<name>.py``) read the
    run's namespace built here."""
    import torch

    from portbench import bytecount, check, manifest, program

    cell.timings["start_s"] = time.perf_counter() - T_START
    libs = program.kernel_libraries()
    cell.setup()
    # set-up: process start to the window, less the benchmark's own making
    # of the graph (gen_s), which is the yardstick's work and not the port's
    setup_s = time.perf_counter() - T_START - cell.timings["gen_s"]
    cell.timings["kernels_built"] = sorted(program.kernel_libraries() - libs)
    summary = None
    if trace:
        queries, window_s, sampler, summary = _trace_window(
            cell, min(seconds, TRACE_SECONDS))
    else:
        queries, window_s, sampler = cell.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cell.cuda else 0
    cell.release()
    t0 = time.perf_counter()
    readings = cell.verify(sampler.answers())
    ok, table = check.judge(readings, cell.limits)
    cell.timings["verify_s"] = time.perf_counter() - t0
    works, nbytes = cell.work(queries)
    cell.timings["graph"] = {"vertices": cell.edges.n,
                             "slots": cell.edges.n_edges}
    run = types.SimpleNamespace(
        setup_s=setup_s, timings=cell.timings, queries=queries,
        works=works, bytes=nbytes, window_s=window_s, trace=summary,
        memory_peak_bytes=peak,
        peak_bytes_per_s=bytecount.PEAK_BYTES_PER_S.get(_device_name(cell)))
    metrics = {}
    bench = manifest.benchmark()
    for m in manifest.metrics_for(bench, cell.name, trace):
        val = manifest.reader(m["name"]).read(run)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    result = {
        "correct": bool(ok and cell.failed == 0 and queries),
        "attempted": len(queries) + cell.failed,
        "failed": cell.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cell.cuda else "cpu",
                   "kind": _device_name(cell), "count": cell.chips,
                   "memory_peak_bytes": peak},
    }
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=window_s)
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    return result, table


def _device_name(cell) -> str:
    import torch

    return torch.cuda.get_device_name(0) if cell.cuda else "cpu"


def main(argv=None) -> int:
    args = _args(argv)
    import torch

    from portbench import manifest
    from portbench.cell import Cell

    bench = manifest.benchmark()
    chips = int(manifest.workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    cell = Cell(args.workload, args.seed, "cuda", bench=bench)
    result, table = measure(cell, args.seconds, bool(args.trace))
    found = banned_modules()
    if found:
        print(f"portbench: modules loaded that the port must not load: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps({"timings": cell.timings}), file=sys.stderr)
    result["checks"] = table
    for name, row in table.items():
        print(f"check {name}: {row['value']} (limit {row['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
