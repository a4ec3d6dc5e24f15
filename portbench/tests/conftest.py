"""Tests of the benchmark itself, on the CPU at small sizes:

    python -m pytest portbench/tests -q

Tests marked ``card`` need a CUDA device and skip without one; they are
run on the card by the same command.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def small_configs() -> dict:
    """Each cell's configuration at a size the CPU runs in a moment."""
    from portbench import manifest

    bench = manifest.benchmark()
    small = {"kron-g500-s20": {"scale": 9}, "delaunay-n20": {"log2_n": 9}}
    return {w["name"]: dict(manifest.config(w["config"]), **small[w["config"]])
            for w in bench["workloads"]}
