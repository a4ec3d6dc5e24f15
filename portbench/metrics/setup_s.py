"""Seconds from the start of the process to the start of the window, less
the benchmark's own making of the graph (``gen_s``): imports, the CUDA
context, the port's load, relabeling and layouts, the warm-up queries,
and in a fresh checkout the build of the port's kernels."""


def read(run):
    return run.setup_s
