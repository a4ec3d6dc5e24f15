"""The control of every cell fails its limits where the program passes
them, at small sizes on the CPU. On the card, at the cells' own sizes:
``python3 portbench/control.py`` (see PERF.md)."""

import pytest

from conftest import small_configs
from portbench import check, control, manifest

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    limits = manifest.limits(cell)
    for seed in (1, 2**31 + 5, 77):
        (row,) = control.readings([cell], seed, 0.2, "cpu",
                                  small_configs())
        assert row["queries"] > 0 and row["failed"] == 0
        assert check.judge(row["program"], limits)[0], row
        assert not check.judge(row["control"], limits)[0], row
