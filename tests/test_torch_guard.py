"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package, and its entry points default to the card and raise without one
instead of running on the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
CHESAPEAKE = str(ROOT / "datasets" / "chesapeake.mtx")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import gunrock_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gunrock_tpu_torch.__path__,
                                              "gunrock_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "gunrock_tpu"))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 62 else 0)
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _entry_points():
    """Each entry point called with its default device."""
    import numpy as np

    from gunrock_tpu_torch import interop
    from gunrock_tpu_torch.algorithms import (
        bc, bfs, color, geo, hits, kcore, mst, ppr, pr, spgemm, spmv, sssp, tc,
    )
    from gunrock_tpu_torch.examples import bc as bc_cli
    from gunrock_tpu_torch.examples import geo as geo_cli
    from gunrock_tpu_torch.examples import spgemm as spgemm_cli
    from gunrock_tpu_torch.examples import tc as tc_cli
    from gunrock_tpu_torch.examples import bfs as bfs_cli
    from gunrock_tpu_torch.examples import color as color_cli
    from gunrock_tpu_torch.examples import kcore as kcore_cli
    from gunrock_tpu_torch.examples import mst as mst_cli
    from gunrock_tpu_torch.examples import ppr as ppr_cli
    from gunrock_tpu_torch.examples import pr as pr_cli
    from gunrock_tpu_torch.formats import Coo
    from gunrock_tpu_torch.graph import build_graph
    from gunrock_tpu_torch.device import get_device_properties
    from gunrock_tpu_torch.io import load_graph_file, rmat_graph
    from gunrock_tpu_torch.probes import dma as dma_probe
    from gunrock_tpu_torch.probes import gather as gather_probe
    from gunrock_tpu_torch.probes import gather2 as gather2_probe
    from gunrock_tpu_torch.probes import v5_floor
    from gunrock_tpu_torch.utils import roofline
    from gunrock_tpu_torch.utils.performance import export_performance_stats

    def cpu_graph():
        return load_graph_file(CHESAPEAKE, device="cpu")[0]

    one = np.ones(1, np.int32)
    nan = np.full(39, np.nan, np.float32)
    return {
        "bc.run": lambda: bc.run(cpu_graph(), 0),
        "bc.run_all_sources": lambda: bc.run_all_sources(cpu_graph()),
        "bc.run_all_sources_spmm": lambda: bc.run_all_sources_spmm(cpu_graph()),
        "tc.run": lambda: tc.run(cpu_graph()),
        "spgemm.run": lambda: spgemm.run(cpu_graph(), cpu_graph()),
        "geo.run": lambda: geo.run(cpu_graph(), nan, nan),
        "interop.bc_run": lambda: interop.bc_run(cpu_graph(), 0),
        "interop.tc_run": lambda: interop.tc_run(cpu_graph()),
        "interop.spgemm_run": lambda: interop.spgemm_run(cpu_graph(),
                                                         cpu_graph()),
        "interop.geo_run": lambda: interop.geo_run(cpu_graph(), nan, nan),
        "bc_cli": lambda: bc_cli.main(["--market", CHESAPEAKE, "--src", "0"]),
        "tc_cli": lambda: tc_cli.main(["--market", CHESAPEAKE]),
        "spgemm_cli": lambda: spgemm_cli.main(["--market", CHESAPEAKE]),
        "geo_cli": lambda: geo_cli.main(["--market", CHESAPEAKE]),
        "build_graph": lambda: build_graph(Coo(2, 2, 0 * one, one, one * 1.0)),
        "load_graph_file": lambda: load_graph_file(CHESAPEAKE),
        "rmat_graph": lambda: rmat_graph(4),
        "bfs.run": lambda: bfs.run(cpu_graph(), 0),
        "interop.bfs": lambda: interop.bfs(cpu_graph(), 0),
        "cli": lambda: bfs_cli.main(["--market", CHESAPEAKE, "--src", "0"]),
        "sssp.run": lambda: sssp.run(cpu_graph(), 0),
        "pr.run": lambda: pr.run(cpu_graph()),
        "pr.run_batch": lambda: pr.run_batch(cpu_graph(), (0.85,)),
        "hits.run": lambda: hits.run(cpu_graph()),
        "spmv.run": lambda: spmv.run(cpu_graph(), np.ones(39, np.float32)),
        "interop.sssp": lambda: interop.sssp(cpu_graph(), 0),
        "pr_cli": lambda: pr_cli.main(["--market", CHESAPEAKE]),
        "color.run": lambda: color.run(cpu_graph()),
        "mst.run": lambda: mst.run(cpu_graph()),
        "kcore.run": lambda: kcore.run(cpu_graph()),
        "ppr.run": lambda: ppr.run(cpu_graph(), 0),
        "ppr.run_batch": lambda: ppr.run_batch(cpu_graph(), [0, 1]),
        "interop.color_run": lambda: interop.color_run(cpu_graph()),
        "interop.mst_run": lambda: interop.mst_run(cpu_graph()),
        "interop.kcore_run": lambda: interop.kcore_run(cpu_graph()),
        "interop.ppr_run": lambda: interop.ppr_run(cpu_graph(), 0),
        "color_cli": lambda: color_cli.main(["--market", CHESAPEAKE]),
        "mst_cli": lambda: mst_cli.main(["--market", CHESAPEAKE]),
        "kcore_cli": lambda: kcore_cli.main(["--market", CHESAPEAKE]),
        "ppr_cli": lambda: ppr_cli.main(["--market", CHESAPEAKE, "--src",
                                         "0"]),
        "get_device_properties": lambda: get_device_properties(),
        "roofline": lambda: roofline.roofline("bfs", 39, 340, 340, 1.0, {}),
        "bound_ms": lambda: roofline.bound_ms(1e6),
        "export_performance_stats": lambda: export_performance_stats(
            "bfs", [1.0], json_dir=str(ROOT / "nonexistent_never_written")),
        "probes.v5_floor": lambda: v5_floor.main(["dma", "--scale", "4"]),
        "probes.gather": lambda: gather_probe.main(["lane"]),
        "probes.gather2": lambda: gather2_probe.main(["wide"]),
        "probes.dma": lambda: dma_probe.main(["check"]),
    }


@pytest.mark.parametrize("name", ["build_graph", "load_graph_file", "rmat_graph",
                                  "bfs.run", "interop.bfs", "cli", "sssp.run",
                                  "pr.run", "pr.run_batch", "hits.run",
                                  "spmv.run", "interop.sssp", "pr_cli",
                                  "color.run", "mst.run", "kcore.run",
                                  "ppr.run", "ppr.run_batch",
                                  "interop.color_run", "interop.mst_run",
                                  "interop.kcore_run", "interop.ppr_run",
                                  "color_cli", "mst_cli", "kcore_cli",
                                  "ppr_cli", "bc.run", "bc.run_all_sources",
                                  "bc.run_all_sources_spmm", "tc.run",
                                  "spgemm.run", "geo.run", "interop.bc_run",
                                  "interop.tc_run", "interop.spgemm_run",
                                  "interop.geo_run", "bc_cli", "tc_cli",
                                  "spgemm_cli", "geo_cli",
                                  "get_device_properties", "roofline",
                                  "bound_ms", "export_performance_stats",
                                  "probes.v5_floor", "probes.gather",
                                  "probes.gather2", "probes.dma"])
def test_entry_point_default_device_needs_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_points()[name]()


@pytest.mark.parametrize("kernel", ["weiszfeld_step_sums",
                                    "weiszfeld_step_sums_sparse",
                                    "banded_gather"])
def test_new_kernel_wrappers_are_built_and_counted(kernel):
    """Each kernel of this slice has its CUDA source in the build list, a
    plain version beside the wrapper, and a launch counter of its own name
    that a CPU call (which runs the plain version) leaves alone."""
    from gunrock_tpu_torch.ops.kernels import _build, banded, geo_step

    module = banded if kernel == "banded_gather" else geo_step
    source = "banded" if kernel == "banded_gather" else "geo_step"
    assert source in _build.SOURCES
    text = (_build.CSRC / f"{source}.cu").read_text()
    assert "GR_IN_RANGE" in text and "gr::finish" in text
    assert callable(getattr(module, kernel))
    assert callable(getattr(module, f"{kernel}_plain"))
    before = _build.LAUNCHES[kernel]
    if kernel == "banded_gather":
        banded.banded_gather(torch.zeros((4, 128), dtype=torch.int32),
                             torch.zeros(128, dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32), span_rows=2,
                             block_t=128)
    assert _build.LAUNCHES[kernel] == before
    wrapper = (Path(module.__file__)).read_text()
    assert f'_build.LAUNCHES[what] += 1' in wrapper or \
        f'_build.LAUNCHES["{kernel}"] += 1' in wrapper
