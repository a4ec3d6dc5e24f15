"""Enactor: the BSP iteration loop (port of
``gunrock_tpu/framework/enactor.py``).

The reference enactor (``framework/enactor.hxx``) runs a host-driven loop,
``enact() = prepare_frontier -> while (!is_converged) { loop();
++iteration; } -> finalize``, with one host read per iteration for the
convergence check. This port is that loop in Python: ``is_converged``
returns a one-element tensor on the device and the loop reads it back
once per iteration. The JAX package compiles the same loop into one
``lax.while_loop``; the virtuals (``prepare_frontier``, ``loop``,
``is_converged``, ``finalize``) and the ``iteration`` key are the same.

State contract: ``prepare_frontier()`` returns a dict of tensors (and
frontier objects); ``loop``
takes it and returns a new one without writing into the tensors it was
given, so one initial state can feed the warm-up and the timed run. The
iteration count doubles as the reference's ``search_depth``.
"""

from __future__ import annotations

from gunrock_tpu_torch.utils.timer import timed


class Enactor:
    """Subclass and override ``prepare_frontier``, ``loop`` and
    (optionally) ``is_converged`` / ``finalize``."""

    def __init__(self, problem, max_iterations: int | None = None):
        self.problem = problem
        # safety bound on the loop (algorithms converge earlier); BFS-like
        # algorithms can never exceed V iterations
        self.max_iterations = max_iterations

    # -- virtuals --------------------------------------------------------
    def prepare_frontier(self) -> dict:
        """Return the initial state dict (enactor.hxx:311)."""
        raise NotImplementedError

    def loop(self, state: dict) -> dict:
        """One BSP iteration: state -> state (enactor.hxx:304). The current
        iteration index is ``state['iteration']``."""
        raise NotImplementedError

    def is_converged(self, state: dict):
        """Convergence predicate as a bool tensor (or bool). Default:
        ``state['frontier']`` is empty, a dense mask or a frontier object
        with ``is_empty`` (``framework/frontier.py``); either way a 0-d
        tensor on the device, read once per iteration by :meth:`run`."""
        frontier = state["frontier"]
        if hasattr(frontier, "is_empty"):
            return frontier.is_empty()
        return ~frontier.any()

    def finalize(self, state: dict) -> dict:
        """Post-loop extraction (enactor.hxx:342). Default: identity."""
        return state

    # -- the loop ---------------------------------------------------------
    def run(self, state: dict) -> dict:
        """Loop from ``state`` to convergence; one host read per
        iteration. ``iteration`` ends as the number of iterations run."""
        max_it = self.max_iterations
        if max_it is None:
            max_it = self.problem.graph.n_vertices + 1
        state = dict(state)
        it = 0
        while it < max_it and not bool(self.is_converged(state)):
            state["iteration"] = it
            state = dict(self.loop(state))
            it += 1
        state["iteration"] = it
        return self.finalize(state)

    def enact(self, warmup: bool = True):
        """Run to convergence. Returns ``(final_state, elapsed_ms)``, the
        time of one run (after a warm-up run when ``warmup``) by
        ``utils/timer.timed``, CUDA events on the card."""
        if warmup:
            self.run(self.prepare_frontier())
        state0 = self.prepare_frontier()
        return timed(self.problem.graph.device, lambda: self.run(state0),
                     warmup=False)
