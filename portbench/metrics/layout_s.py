"""Seconds to build the cell's bucketed layout
(``ops/kernels/layout.pull_layout``)."""


def read(run):
    return run.timings.get("layout_s")
