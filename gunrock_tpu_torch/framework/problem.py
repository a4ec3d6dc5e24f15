"""Problem base: per-algorithm persistent state (port of
``gunrock_tpu/framework/problem.py``; role of reference
``framework/problem.hxx``). Holds the graph; ``reset()`` returns the
initial state dict of tensors that the enactor threads through its
loop."""

from __future__ import annotations

from gunrock_tpu_torch.graph import Graph


class Problem:
    def __init__(self, graph: Graph):
        self.graph = graph

    def init(self):  # one-time setup (override as needed)
        return None

    def reset(self):
        """Return the initial algorithm state dict. Must be overridden."""
        raise NotImplementedError
