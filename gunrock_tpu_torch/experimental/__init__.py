"""Experimental subsystems (the port's counterpart of
``gunrock_tpu/experimental``).

The reference's experimental async runtime (persistent-kernel MPMC work
queues driving barrier-free BFS, reference
include/gunrock/container/experimental/async/queue.hxx:17-356) is
delivered, as in the JAX package, by its semantics rather than its
queues: :mod:`gunrock_tpu_torch.experimental.async_sweep` runs
deterministic Gauss-Seidel block sweeps, where a relaxation sees the
values earlier blocks of the same sweep produced. On the card the whole
loop of a search is one cooperative launch (``csrc/async_sweep.cu``).
``--mode async`` on the bfs and sssp CLIs runs it; ``ordering="rcm"``
restores path monotonicity on scrambled meshes (``graph/reorder.rcm_sort``).
"""
