"""Seconds in the port's graph load: ``graph/build.build_graph`` (with
``_native/``'s sort) and the relabeling the cell uses
(``graph/reorder.degree_sort``, or the RCM relabeling of the async
sweep)."""


def read(run):
    return run.timings.get("build_s")
