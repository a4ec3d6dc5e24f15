"""Distributed execution: one process (rank) per vertex shard, on
``torch.distributed`` (port of ``gunrock_tpu/parallel``).

- ``mesh``        — the mesh of ranks (flat or (host, chip)), the device
                    and backend rule, and ``spawn``, which starts the ranks
- ``collectives`` — all_gather, psum/pmax/pmin, axis_index, all_to_all
                    (flat and two-stage) and ppermute over a mesh
- ``sharded``     — the vertex-sharded partition and the fourteen sharded
                    algorithms, the kernel path through per-rank layouts
- ``algorithms``  — the public entry points and triangle counting's two
                    forms

Each rank holds 1/n of the vertex state and the edges grouped by the owner
of the reduction key; the only V-sized traffic is the boundary exchange of
the x operand (all_gather or a halo all_to_all) plus scalar convergence
reductions. Entry points run on the card unless asked for the CPU.
"""

from gunrock_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    make_mesh_2d,
    spawn,
)
from gunrock_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedGraph,
    bc,
    bfs,
    color,
    color_greedy,
    geo,
    hits,
    kcore,
    mst,
    pagerank,
    partition_sharded,
    ppr,
    spgemm_count,
    spmv,
    sssp,
    tc_ring,
)
from gunrock_tpu_torch.parallel import algorithms  # noqa: F401
