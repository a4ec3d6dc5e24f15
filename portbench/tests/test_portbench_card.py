"""On the card: each cell's whole run at a small size, correct, with the
device's numbers from the trace."""

import sys

import pytest

from conftest import small_configs
from portbench import manifest
from portbench.cell import Cell

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    sys.path.insert(0, str(manifest.HERE))
    try:
        import run
    finally:
        sys.path.remove(str(manifest.HERE))
    c = Cell(cell, 2**31 + 7, card, config=small_configs()[cell])
    result, table = run.measure(c, 0.5, True)
    assert result["correct"], table
    assert result["device"]["busy_s"] > 0
    assert 0 < result["metrics"][f"roofline_pct.{cell}"]["value"] <= 100
