"""Time the span kernels at R-MAT scale 18 (edge factor 16, seed 1,
degree-sorted): the semiring pull, B1 (``bucketed_semiring_spmv_sparse``)
and B3 (``bucketed_semiring_spmv``), the fused HITS pass, B8
(``hits_fused_pass``), and the frontier-sparse SpMM, B5
(``bucketed_spmm_sparse``); and sweep the span length P and B5's K tile.

One JSON line per case, each with the card's name and power limit:

  b1_full    unit plus_times over the unit pull layout (W=2048/C=256), every
             vertex active and in out_mask: DO-BFS's pull on a full frontier
  b1_tenth   the same on a 10% frontier with a 50% out_mask
  b1_empty   the same with no vertex active
  b3_pr      valued plus_times over the W=4096/C=1024 pull layout (PageRank)
  b3_valued  valued plus_times over the W=2048/C=256 pull layout (the floor
             probe's layout, ``probes/v5_floor.py``)
  b3_min     min_plus over the W=2048/C=256 pull layout (the dense SSSP)
  b8_hits    B8 over the unit push layout at W=4096/C=1024 (HITS), random
             auth and hub
  b5_color   B5 over greedy coloring's layout (W=2048/C=256, 0/1 values),
             K=32, every vertex changed and in out_mask, X the one-hot of
             the rank-init colors: coloring's first round
  b5_color_tenth  the same with 10% of the rows changed (X zero elsewhere)
             and a 50% out_mask
  b5_float   the same layout, K=32, random X, full frontier
  b5_spgemm  B5 as the dense SpGEMM count calls it: K=512 columns, X the
             unit columns of A's row block 4 (rows 2048-2559) over the
             unit pull layout, its columns active
  b5_spgemm_hub  the same for row block 0 (the hubs' rows)
and with ``--b4_b6`` (after them):

  b4_k4      B4 (``bucketed_spmm``) as batch PageRank calls it: K=4, random
             X, over the valued pull layout (W=2048/C=256)
  b4_k8      B4 as batch PPR calls it: K=8, random X, unit pull layout
  b4_k32     B4 at K=32 on random X over the unit pull layout (the kernel
             table's row; SpMV's multi-vector, BC's batch of 32)
  b4_msbfs   B4 as multi-source BFS calls it: K=32 over the unit pull
             layout, X the frontier of the third SpMM of a search from the
             32 highest-degree vertices (the vertices at distance 2)
  b4_k4_keep, b4_k8_keep  b4_k4 and b4_k8 through the keep pass
  b4_k32_walk, b4_msbfs_walk  b4_k32 and b4_msbfs with the tile pass
             walking the metadata itself in K tiles of 8, no keep pass
  b6_full    B6 (``bucketed_semiring_spmv_sparse_minmax``) as Luby's first
             round calls it: the symmetrized unit push layout, every
             vertex active and in out_mask, x a permutation of 1..V
  b6_tenth, b6_hundredth, b6_empty  the same on 10%, 1% and no active
             vertices (x 0 off them)
  b6_*_nomask  the same four without out_mask

with ``ms`` (CUDA events, mean of ``--num_runs`` warm calls), ``device_ms``
(the card's busy time per call) and ``kernels`` (the device microseconds
per call of each kernel the call ran), both from one
``utils/trace_stats.device_profile`` of ``--num_runs`` calls, ``bound_ms``
(real slots only; for B5 and B6 those of the active chunks) and, where
PyTorch has one call computing the same function, its wall and device
time: ``sparse_mm_ms`` and ``sparse_mm_device_ms``, one
``torch.sparse.mm`` over the same matrix (for B8 over [[0, A], [A^T, 0]]
times (hub; auth), beside ``sparse_mm_two_calls_ms``, A.auth and A^T.hub).
B5's and B6's lines add ``active_chunks``.

``--greedy`` adds one line, ``greedy_passes``: the active chunks (of the
layout's), changed rows and nonzero X rows of every B5 pass of one greedy
coloring (``color.run``, which runs its loop twice, warm-up and timed;
the line keeps the timed run's passes).

``--luby`` adds one line, ``luby_passes``: the active chunks of every B6
pass of one Luby coloring (``color.run``, warm-up and timed; the timed
run's passes), the device time of all of them (``device_ms_total``: the
busy time of replaying the recorded passes, per replay of the whole
sequence) split by kernel, and the row runs of Luby's layout
(:func:`row_runs`).

``--b2_b9`` adds (after them):

  b2_unit_<front>[_nomask]  B2 (``chunk_activity``, as the span passes
             call it: the mask, no queue) over the unit pull layout
             (20,548 chunks at R-MAT 18) on a full, 10%, 1% and empty
             frontier, with a 50% out_mask and without
  b2_luby_<front>[_nomask]  the same over Luby's layout (36,028 chunks),
             out_mask the frontier (as Luby's rounds call it)
  b9_dense   B9 (``weiszfeld_step_sums``) over the unit push layout, 10%
             of the vertices labeled, every 8th row's iterate on a
             labeled neighbour (distance 0)
  b9_sparse_full, b9_sparse_tenth, b9_sparse_none  the chunk-skipping B9
             (``weiszfeld_step_sums_sparse``, its chunk plan included) on
             the same inputs with every, 10% and no row iterating

``--geo`` adds one line, ``geo_passes``: the active chunks of every
chunk-skipping Weiszfeld step of one ``geo.run`` (the example's default
labels, 10% of the vertices), the device time of replaying all of them
(``device_ms_total``, chunk plan included) split by kernel, and the
on-path bound (``bound_ms_total``): each step's active chunks' real slots
at 16 B (row, coordinates, ok) plus the four sums' 16 B a vertex, over
the card's memory rate.

``--sssp_push`` adds one line, ``sssp_push_passes``: every push step
that the DO switch takes in eight DO-SSSP searches (``sssp.run`` from
the 8 highest-degree vertices, as ``chip_smoke.py``'s semiring path runs
them), each step's frontier and out-edges, the device time of replaying
all of them (``device_ms_total``) split by kernel, and the on-path bound
(``bound_ms_total``: each step's frontier mask, distances in and out,
improved mask, queued rows' offsets and distances, and each out-edge's
column, weight and target distance, over the card's memory rate); then
the case ``sssp_push_largest``, the step with the most out-edges, alone.

``--bfs_push`` adds one line, ``bfs_push_passes``: every push step that
the DO switch takes in eight DO-BFS searches (``bfs.run`` from the 8
highest-degree vertices, as ``bench.py`` and ``chip_smoke.py``'s BFS path
run them), each step's frontier and out-edges, the device time of
replaying all of them (``device_ms_total``) split by kernel, and the
on-path bound (``bound_ms_total``: each step's frontier mask and new mask
over V, queued rows' offsets, each out-edge's column and target distance,
and each new vertex's distance, over the card's memory rate); then the
case ``bfs_push_largest``, the step with the most out-edges, alone; then
the line ``bfs_crossover``: for every level of the eight searches, pushed
or pulled, the device time of the push step and of the pull
(``bfs._pull`` over the unit pull layout) on the same frontier and
distances, beside the DO switch's ``edge_budget``. The steps update the
distances in place, so every replayed call gets its own copy of the
distances the search had before that level, made before the timing.

``--mst`` adds one line, ``mst_passes``: every min-cut pass (B7,
``bucketed_min_rank_cut``) of one ``mst.run`` with its real roots, each
pass's cut slots and device time, their replayed total and the on-path
bound (12 B a real slot, 8 B a chunk and the roots and y, a pass); then
the cases ``b7_round1`` (every vertex a root) and ``b7_round2`` (the
roots after round 1).

``--async`` prints instead (no other case) one line for each sweep kernel
case of ``chip_smoke.py``'s async path (phase g): ``async_rmat18_sssp``,
``async_rmat18_bfs`` (``gs_sweep_min`` from the top-degree vertex, 32
blocks), ``async_rmat18_pr_1e-7``, ``async_rmat18_pr_1e-9``
(``gs_sweep_pr``), ``async_mesh18_sssp_natural``, ``async_mesh18_sssp_rcm``
and ``async_mesh18_bfs_rcm`` (``gs_sweep_min`` on
``delaunay_graph(2**18, seed=3)`` from its top-degree vertex, natural and
RCM order; the inputs from ``probes/async_cases.py``); each with
``sweeps``, ``block_passes``, ``ms`` and ``device_ms`` as above,
``us_per_pass`` and ``device_us_per_pass``, ``bound_ms`` (each pass reads
its block's edges, 12 B each, and vertices, 8 B each), and what the
kernel counted on the card: ``grid_barriers`` (one a block pass, and one,
for PageRank two, before the sweeps), ``ctas`` and ``cluster_ctas``. It
uses only the kernels' public calls, so this file and
``async_cases.py`` copied into an earlier tree time that tree's kernels
(whose wrappers count no barriers, and no PageRank passes: there sweeps
x blocks): ``git archive`` the parent into ``_chip/parent/``, copy the
two files into its ``gunrock_tpu_torch/probes/``, and run the probe from
there.

``--banded`` prints instead (no other case) one line for each slab of
the banded gather, B10 (``banded_gather``): ``banded_real``, the first of
the slabbed triangle count's five slabs on this graph (at R-MAT 18:
40,925,184 positions, span_rows 37, a table of 3,775,104 ints; as
``chip_smoke.py``'s kernel row captures it), ``banded_real_unaligned``
(the same slab with idx a view one int off 16-byte alignment: the
kernel's scalar instance), and ``banded_span1``, ``banded_span37``,
``banded_span120``, ``banded_span200`` (synthetic slabs of 20,000 blocks
of 2,048 over a table of the real one's size, span_rows 1 to
``tc.MAX_SPAN_ROWS``); the inputs from ``probes/banded_cases.py``. Each
has ``ms``, ``device_ms`` and ``kernels`` as above, ``bound_ms`` (idx
and out 8 B a position, block_lo, the table's reach once),
``share_of_bound`` (``bound_ms`` over ``device_ms``) and
``index_select_ms`` and ``index_select_device_ms``: one
``torch.index_select`` of the indices the kernel reads (the clamped
ones). Every slab is first held bit for bit against
``banded_gather_plain``. Then the line ``banded_tc``: three ``tc.run``
times in one sort (``ms``) and in five slabs (``slabbed_ms``). Copied
with ``banded_cases.py`` into an earlier tree's
``gunrock_tpu_torch/probes/`` (a ``git archive`` of the parent in
``_chip/parent/``), it times that tree's kernel on the same inputs.

``--predecessors`` prints instead (no other case) one line for each kind
of the predecessor pass, ``pred_bfs`` and ``pred_sssp``, on an undirected
R-MAT graph of ``--scale`` (edge factor 16, seed 1, degree-sorted: the
benchmark's Kronecker shape) with the distances of eight searches from
seeded random sources of nonzero degree (the DO searches over their pull
layouts). Each has, a pass, ``ms`` (CUDA events) and ``device_ms`` of the
kernel (``bfs_predecessors``, ``sssp_predecessors``), ``plain_ms`` and
``plain_device_ms`` of ``predecessors_plain`` on the same inputs,
``bound_ms`` (what the early exit needs: the offsets, the distances and
pred over V, and each reached vertex's slots up to its first tight one, 4
B a slot, 8 B for SSSP's weights) and ``full_bound_ms`` (every slot), and
``equal`` (the kernel's pred bit for bit the plain version's on every
source).

``--sweep 4,8,16,32`` adds one line per P: b3_valued, b3_pr, b1_full, b8_hits
and b5_color with both span tables cut at P
(``BucketedEdges.with_span_chunks``); ``--k_tiles 4,8,16`` one line per K
tile for b5_color, b5_float and b5_spgemm (and b4_k32 with ``--b4_b6``).
On a tree without a span table, a column span table, B5's K tile or B4's
K tile and walk, those lines are skipped, so the same file times an
earlier tree's kernels.

``--msbfs`` prints instead (no other case) one line, ``msbfs_level``, for
each level of a K=32 multi-source BFS (``msbfs_pull``) on an undirected
R-MAT graph of ``--scale`` (edge factor 16, seed 1, degree-sorted; 20 for
the benchmark's shape) from 32 seeded random sources of nonzero degree:
``n_front`` (the vertices entering the level), ``slots`` (the CSC slots
its scans needed), ``scan_share`` (those over every slot), ``gained``
(the distances it wrote), ``device_ms`` (the kernel's device time a call,
the level replayed on its own inputs), ``replay_device_ms`` (with the
copies of ``seen`` and ``aux`` that each replay restores) and
``bound_ms`` (:func:`msbfs_level_bytes` over the card's memory rate);
then one line, ``msbfs_query``: the depth, the query's slots and
``scan_share``, its ``ms`` (CUDA events) and ``device_ms``, and the
levels' device times summed.

Usage: python -m gunrock_tpu_torch.probes.pull [--scale 18] [--num_runs 20]
       [--sweep 4,8,16,32] [--k_tiles 4,8,16] [--greedy] [--b4_b6]
       [--luby] [--b2_b9] [--geo] [--sssp_push] [--bfs_push] [--mst]
       [--async] [--banded] [--predecessors] [--msbfs] [--device cuda]
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys

import torch

from gunrock_tpu_torch.probes import device_label, time_ms


def _n_real(layout) -> int:
    return int((layout.row_local != layout.window).sum())


def _profile(fn, n: int, dev):
    """(the card's busy ms per call, {kernel: device us per call}) of ``n``
    calls of ``fn`` under ``trace_stats.device_profile``; "not measured"
    off the card or where three profiles hold no device events."""
    from gunrock_tpu_torch.device.properties import NOT_MEASURED
    from gunrock_tpu_torch.utils.trace_stats import device_profile

    if dev.type == "cuda":
        for _ in range(3):
            prof = device_profile(lambda: [fn() for _ in range(n)])
            if "busy_us" in prof:
                return prof["busy_us"] / n / 1e3, {
                    k: us / n for k, (us, _) in prof["top_us"].items()}
    return NOT_MEASURED, NOT_MEASURED


def cases(graph, layouts: dict, gen, k_tile=None) -> dict:
    """{case: (call, bytes the call must move, operations, {name: library
    call, or ``plain``: the plain version}, extra keys)} at the layouts ``unit``, ``valued``, ``pr``,
    ``big``, ``hits`` and ``color``; B5's calls take the K tile
    ``k_tile`` when given."""
    from gunrock_tpu_torch.ops.kernels import chunkplan, hits_fused, semiring, spmm

    dev = graph.device
    V = graph.n_vertices
    full = torch.ones(V, dtype=torch.bool, device=dev)
    none = torch.zeros(V, dtype=torch.bool, device=dev)
    tenth = torch.rand(V, device=dev, generator=gen) < 0.1
    half = torch.rand(V, device=dev, generator=gen) < 0.5
    x = torch.rand(V, device=dev, generator=gen)
    xb = torch.where(torch.rand(V, device=dev, generator=gen) < 0.5, x,
                     semiring._BIG)
    A_unit = torch.sparse_csr_tensor(
        graph.csc_offsets.long(), graph.csc_rows.long(),
        torch.ones(graph.n_edges, device=dev), size=(V, V))
    A = torch.sparse_csr_tensor(graph.csc_offsets.long(),
                                graph.csc_rows.long(), graph.csc_values,
                                size=(V, V))
    unit, pr = layouts["unit"], layouts["pr"]
    valued, big = layouts["valued"], layouts["big"]

    def sparse(act, om):
        xa = act.float()
        return lambda: semiring.bucketed_semiring_spmv_sparse(
            unit, xa, act, "plus_times", out_mask=om, unit=True)

    def dense(lay, xv, sr):
        return lambda: semiring.bucketed_semiring_spmv(lay, xv, sr)

    def b1_bytes(lay):  # slots, x, the two masks, y, the chunk metadata
        return 8 * _n_real(lay) + 4 * V + 2 * V + 4 * V + 16 * lay.n_chunks

    def b3_bytes(lay):
        return 12 * _n_real(lay) + 8 * lay.n_chunks + 4 * V + 4 * V

    xf = full.float()
    out = {
        "b1_full": (sparse(full, full), b1_bytes(unit), _n_real(unit),
                    {"sparse_mm": lambda: torch.sparse.mm(A_unit, xf[:, None])}),
        "b1_tenth": (sparse(tenth, half), None, None, {}),
        "b1_empty": (sparse(none, full), None, None, {}),
        "b3_pr": (dense(pr, x, "plus_times"), b3_bytes(pr), 2 * _n_real(pr),
                  {"sparse_mm": lambda: torch.sparse.mm(A, x[:, None])}),
        "b3_valued": (dense(valued, x, "plus_times"), b3_bytes(valued),
                      2 * _n_real(valued),
                      {"sparse_mm": lambda: torch.sparse.mm(A, x[:, None])}),
        "b3_min": (dense(big, xb, "min_plus"), b3_bytes(big), 2 * _n_real(big),
                   {}),
    }
    out = {k: (*v, {}) for k, v in out.items()}

    # B8: hub_raw = A.auth and auth_raw = A^T.hub in one call, as
    # [[0, A], [A^T, 0]] . (hub; auth)
    hits = layouts["hits"]
    auth = torch.rand(V, device=dev, generator=gen)
    hub = torch.rand(V, device=dev, generator=gen)
    src, dst = graph.edge_src.long(), graph.col_indices.long()
    ones = torch.ones(graph.n_edges, device=dev)
    A_push = torch.sparse_csr_tensor(graph.row_offsets.long(), dst, ones,
                                     size=(V, V))
    A_t = torch.sparse_csr_tensor(graph.csc_offsets.long(),
                                  graph.csc_rows.long(), ones, size=(V, V))
    M = torch.sparse_coo_tensor(
        torch.stack([torch.cat([src, V + dst]), torch.cat([V + dst, src])]),
        torch.cat([ones, ones]), size=(2 * V, 2 * V)).coalesce().to_sparse_csr()
    hub_auth = torch.cat([hub, auth])[:, None]
    out["b8_hits"] = (
        lambda: hits_fused.hits_fused_pass(hits, auth, hub),
        8 * _n_real(hits) + 8 * hits.n_chunks + 4 * 4 * V, 2 * _n_real(hits),
        {"sparse_mm": lambda: torch.sparse.mm(M, hub_auth),
         "sparse_mm_two_calls": lambda: (torch.sparse.mm(A_push, auth[:, None]),
                                         torch.sparse.mm(A_t, hub[:, None]))},
        {})

    # B5 at coloring's and SpGEMM's shapes
    lay, rank = layouts["color"]
    K = 32
    x1 = torch.nn.functional.one_hot(torch.clamp(rank, max=K - 1).long(),
                                     K).float()
    xr = torch.rand((V, K), device=dev, generator=gen)
    x10 = torch.where(tenth[:, None], x1, 0.0)
    lsrc, ldst = _sym_edges(graph)
    A_color = torch.sparse_coo_tensor(
        torch.stack([lsrc, ldst]), (ldst < lsrc).float(),
        size=(V, V)).coalesce().to_sparse_csr()
    kw = {} if k_tile is None else {"k_tile_cols": k_tile}

    def b5(L, xk, act, om, library):
        ch_act = chunkplan.chunk_activity(L, act, om)[0]
        n_act = int(ch_act.sum())
        real = L.row_local.view(-1, L.chunk)[ch_act] != L.window
        n_real = int(real.sum())
        Kx = xk.shape[1]
        return (lambda: spmm.bucketed_spmm_sparse(L, xk, act, om, **kw),
                12 * n_real + 8 * n_act + 2 * 4 * V * Kx + 2 * V,
                2 * n_real * Kx, library,
                {"active_chunks": n_act, "k": Kx})

    out["b5_color"] = b5(lay, x1, full, full,
                         {"sparse_mm": lambda: torch.sparse.mm(A_color, x1)})
    out["b5_color_tenth"] = b5(lay, x10, tenth, half, {})
    out["b5_float"] = b5(lay, xr, full, full,
                         {"sparse_mm": lambda: torch.sparse.mm(A_color, xr)})
    offs = graph.row_offsets.long()
    rows = min(512, V)  # the count's block of rows (fewer on a tiny graph)
    for name, r0 in (("b5_spgemm", min(4 * rows, V - rows)),
                     ("b5_spgemm_hub", 0)):
        e0, e1 = int(offs[r0]), int(offs[r0 + rows])
        c = graph.col_indices[e0:e1].long()
        xs = torch.zeros((V, rows), device=dev)
        xs[c, graph.edge_src[e0:e1].long() - r0] = 1.0
        act = torch.zeros(V, dtype=torch.bool, device=dev)
        act[c] = True
        out[name] = b5(unit, xs, act, None, {
            "sparse_mm": lambda xs=xs: torch.sparse.mm(A_unit, xs),
            # the plain version, for the kernel table's plain column
            "plain": lambda xs=xs, act=act: spmm.bucketed_spmm_sparse_plain(
                unit, xs, act, None)})
    return out


def b4_cases(graph, layouts: dict, gen, k_tile=None) -> dict:
    """B4's cases (see the module docstring), at the K tile ``k_tile`` when
    given; the walking tile pass and another K tile only on a tree whose
    ``bucketed_spmm`` takes them."""
    from gunrock_tpu_torch.ops.kernels import spmm

    dev, V = graph.device, graph.n_vertices
    unit, valued = layouts["unit"], layouts["valued"]
    A_unit = torch.sparse_csr_tensor(
        graph.csc_offsets.long(), graph.csc_rows.long(),
        torch.ones(graph.n_edges, device=dev), size=(V, V))
    A = torch.sparse_csr_tensor(graph.csc_offsets.long(),
                                graph.csc_rows.long(), graph.csc_values,
                                size=(V, V))
    # multi-source BFS from the 32 highest-degree vertices: the frontier
    # the third SpMM takes, by torch.sparse.mm (any tree has it)
    K = 32
    src = torch.argsort(graph.out_degrees(), descending=True,
                        stable=True)[:K]
    front = torch.zeros((V, K), device=dev)
    front[src, torch.arange(K, device=dev)] = 1.0
    seen = front > 0
    for _ in range(2):
        new = (torch.sparse.mm(A_unit, front) > 0.5) & ~seen
        seen |= new
        front = new.float()
    params = inspect.signature(spmm.bucketed_spmm).parameters
    walk = "walk" in params
    tile = {} if k_tile is None else {"k_tile_cols": k_tile}
    if tile and "k_tile_cols" not in params:
        return {}
    out = {}

    def case(name, L, x, A_lib, **kw):
        kw.update(tile)
        n_real = _n_real(L)
        k = x.shape[1]
        out[name] = (lambda: spmm.bucketed_spmm(L, x, **kw),
                     12 * n_real + 8 * L.n_chunks + 2 * 4 * V * k,
                     2 * n_real * k,
                     {"sparse_mm": lambda: torch.sparse.mm(A_lib, x)},
                     {"k": k, "nonzero_x_rows": int((x != 0).any(dim=1).sum())})

    x4 = torch.rand((V, 4), device=dev, generator=gen)
    x8 = torch.rand((V, 8), device=dev, generator=gen)
    case("b4_k4", valued, x4, A)
    case("b4_k8", unit, x8, A_unit)
    x32 = torch.rand((V, K), device=dev, generator=gen)
    case("b4_k32", unit, x32, A_unit)
    case("b4_msbfs", unit, front, A_unit)
    if walk and not tile:
        # the other tile pass of each: K <= 8 through the keep pass; K=32
        # walking the metadata, in four K tiles of 8 over the whole window
        case("b4_k4_keep", valued, x4, A, walk=False)
        case("b4_k8_keep", unit, x8, A_unit, walk=False)
        case("b4_k32_walk", unit, x32, A_unit, walk=True, k_tile_cols=8)
        case("b4_msbfs_walk", unit, front, A_unit, walk=True, k_tile_cols=8)
    return out


def b6_cases(graph, layouts: dict, gen) -> dict:
    """B6's cases (see the module docstring)."""
    from gunrock_tpu_torch.ops.kernels import chunkplan, semiring

    dev, V = graph.device, graph.n_vertices
    L = layouts["luby"]
    prio = torch.randperm(V, device=dev, generator=gen).float() + 1.0
    fronts = {"full": torch.ones(V, dtype=torch.bool, device=dev),
              "tenth": torch.rand(V, device=dev, generator=gen) < 0.1,
              "hundredth": torch.rand(V, device=dev, generator=gen) < 0.01,
              "empty": torch.zeros(V, dtype=torch.bool, device=dev)}
    out = {}
    for front, act in fronts.items():
        x = torch.where(act, prio, 0.0)
        for om, tag in ((act, ""), (None, "_nomask")):
            ch_act = chunkplan.chunk_activity(L, act, om)[0]
            n_act = int(ch_act.sum())
            n_real = int((L.row_local.view(-1, L.chunk)[ch_act]
                          != L.window).sum())
            # slots, x, the two masks, ymax and ymin, the chunk metadata
            out[f"b6_{front}{tag}"] = (
                lambda x=x, act=act, om=om:
                    semiring.bucketed_semiring_spmv_sparse_minmax(L, x, act, om),
                12 * n_real + 8 * n_act + 4 * V + 2 * V + 8 * V, 3 * n_real,
                {}, {"active_chunks": n_act})
    return out


def _plan(chunkplan, L, act, om):
    """B2 as the span passes call it: the mask alone on a tree whose
    ``chunk_activity`` can leave the queue out, the whole plan on an
    earlier one."""
    if "queue" in inspect.signature(chunkplan.chunk_activity).parameters:
        return lambda: chunkplan.chunk_activity(L, act, om, queue=False)
    return lambda: chunkplan.chunk_activity(L, act, om)


def b2_cases(graph, layouts: dict, gen) -> dict:
    """B2's cases (see the module docstring)."""
    from gunrock_tpu_torch.ops.kernels import chunkplan

    dev, V = graph.device, graph.n_vertices
    half = torch.rand(V, device=dev, generator=gen) < 0.5
    fronts = {"full": torch.ones(V, dtype=torch.bool, device=dev),
              "tenth": torch.rand(V, device=dev, generator=gen) < 0.1,
              "hundredth": torch.rand(V, device=dev, generator=gen) < 0.01,
              "empty": torch.zeros(V, dtype=torch.bool, device=dev)}
    out = {}
    for key in ("unit", "luby"):
        L = layouts[key]
        for front, act in fronts.items():
            for om, tag in ((half if key == "unit" else act, ""),
                            (None, "_nomask")):
                n_act = int(chunkplan.chunk_activity_plain(L, act, om)[0].sum())
                # the masks, four metadata words a chunk, the mask out
                out[f"b2_{key}_{front}{tag}"] = (
                    _plan(chunkplan, L, act, om),
                    (2 if om is not None else 1) * V + 17 * L.n_chunks, 0,
                    {}, {"n_chunks": L.n_chunks, "active_chunks": n_act})
    return out


def wstep_inputs(L, gen, labeled_share: float = 0.1):
    """(y_lat, y_lon, mlat3, mlon3, ok3) for B9 over layout ``L``: a
    ``labeled_share`` of the vertices carry random coordinates, the slot
    tables as ``geo_kernel`` builds them, a random iterate except on every
    8th row, which sits on one of its labeled neighbours."""
    from gunrock_tpu_torch.algorithms import geo
    from gunrock_tpu_torch.ops.kernels.layout import slot_indices

    dev, V = L.device, L.n_vertices

    def coords():
        return (torch.rand(V, device=dev, generator=gen) * 120 - 60,
                torch.rand(V, device=dev, generator=gen) * 360 - 180)

    labeled = torch.rand(V, device=dev, generator=gen) < labeled_share
    (lat, lon), (y_lat, y_lon) = coords(), coords()
    slot_dst, slot_valid = geo.slot_tables(L)
    ok_slot = slot_valid & labeled[slot_dst]
    mlat3 = torch.where(ok_slot, lat[slot_dst], 0.0)
    mlon3 = torch.where(ok_slot, lon[slot_dst], 0.0)
    row, _, slot = slot_indices(L)
    keep = ok_slot[slot]
    best = torch.full((V,), -1, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, row[keep], slot[keep], reduce="amax",
                         include_self=True)
    on = (best >= 0) & (torch.arange(V, device=dev) % 8 == 0)
    at = torch.clamp(best, min=0)
    y_lat = torch.where(on, mlat3[at], y_lat)
    y_lon = torch.where(on, mlon3[at], y_lon)
    return y_lat, y_lon, mlat3, mlon3, ok_slot.float()


def _wstep_bytes(L, ch_act=None) -> int:
    """What a Weiszfeld step must move: 16 B per real slot of the (active)
    chunks and the four sums' 16 B per vertex."""
    real = L.row_local.view(-1, L.chunk) != L.window
    if ch_act is not None:
        real = real[ch_act]
    return 16 * int(real.sum()) + 16 * L.n_vertices


def b9_cases(graph, layouts: dict, gen) -> dict:
    """B9's cases (see the module docstring)."""
    from gunrock_tpu_torch.ops.kernels import chunkplan, geo_step

    dev, V = graph.device, graph.n_vertices
    L = layouts["geo"]
    args = wstep_inputs(L, gen)
    n_ok = int(args[4].sum())
    out = {"b9_dense": (lambda: geo_step.weiszfeld_step_sums(L, *args),
                        _wstep_bytes(L), 30 * n_ok, {}, {"labeled_slots": n_ok})}
    for name, undone in (
            ("full", torch.ones(V, dtype=torch.bool, device=dev)),
            ("tenth", torch.rand(V, device=dev, generator=gen) < 0.1),
            ("none", torch.zeros(V, dtype=torch.bool, device=dev))):
        ch_act = chunkplan.chunk_activity_plain(L, torch.ones_like(undone),
                                                undone)[0]
        out[f"b9_sparse_{name}"] = (
            lambda undone=undone: geo_step.weiszfeld_step_sums_sparse(
                L, *args, undone),
            _wstep_bytes(L, ch_act), 30 * n_ok, {},
            {"active_chunks": int(ch_act.sum()), "labeled_slots": n_ok})
    return out


def record_calls(module, name: str, fn):
    """(fn's result, calls): run ``fn()`` with ``module.name`` wrapped so
    that each call's positional arguments are kept, as passed (not
    copied), in ``calls``."""
    kernel, calls = getattr(module, name), []

    def record(*args):
        calls.append(args)
        return kernel(*args)

    setattr(module, name, record)
    try:
        return fn(), calls
    finally:
        setattr(module, name, kernel)


def geo_passes(graph, n: int) -> dict:
    """The ``geo_passes`` line: every chunk-skipping Weiszfeld step of one
    ``geo.run``, recorded by wrapping the kernel's entry point, replayed
    ``n`` times under one profile."""
    from gunrock_tpu_torch.algorithms import geo
    from gunrock_tpu_torch.examples.geo import default_labels
    from gunrock_tpu_torch.ops.kernels import chunkplan
    from gunrock_tpu_torch.utils.roofline import bound_ms

    kernel = geo.weiszfeld_step_sums_sparse
    lat, lon = default_labels(graph.n_vertices)
    res, calls = record_calls(geo, "weiszfeld_step_sums_sparse", lambda: geo.run(
        graph, lat, lon, warmup=False, device=graph.device))
    active, n_bytes = [], 0
    for args in calls:
        L, undone = args[0], args[-1]
        ch_act = chunkplan.chunk_activity_plain(L, torch.ones_like(undone),
                                                undone)[0]
        active.append(int(ch_act.sum()))
        n_bytes += _wstep_bytes(L, ch_act)
    total, kernels = _profile(lambda: [kernel(*a) for a in calls], n,
                              graph.device)
    row = {"probe": "pull", "case": "geo_passes", "steps": res.steps,
           "n_chunks": calls[0][0].n_chunks if calls else 0,
           "active_chunks": active, "active_chunks_sum": sum(active),
           "device_ms_total": total, "kernels_us_total": kernels,
           "geo_ms": res.elapsed_ms}
    if graph.device.type == "cuda":
        row["bound_ms_total"] = bound_ms(n_bytes, 0, device=graph.device)[0]
    row["device"] = device_label(graph.device)
    return row


def _push_bytes(V: int, n_front: int, n_out: int) -> int:
    """What a push step must move (``chip_smoke.py``'s bound): the
    frontier mask, the distances in and out and the improved mask over V,
    each queued row's offsets and distance, each out-edge's column, weight
    and target distance."""
    return V + 4 * V + 4 * V + V + 12 * n_front + 12 * n_out


def sssp_push_passes(graph, n: int) -> list:
    """The ``sssp_push_passes`` line and the ``sssp_push_largest`` case
    (see the module docstring): the push steps of eight DO-SSSP searches,
    recorded by wrapping the kernel's entry point, replayed ``n`` times
    under one profile."""
    from gunrock_tpu_torch.algorithms import sssp
    from gunrock_tpu_torch.utils.roofline import bound_ms

    dev, V = graph.device, graph.n_vertices
    deg = graph.out_degrees()
    kernel = sssp.sssp_push_step
    sources = torch.argsort(deg, descending=True, stable=True)[:8].tolist()
    _, calls = record_calls(sssp, "sssp_push_step", lambda: [
        sssp.run(graph, src, warmup=False, device=dev) for src in sources])
    sizes = [torch.stack([front.sum(), torch.where(front, deg, 0).sum()]).tolist()
             for _, front, _, _ in calls]

    def replay():
        return [kernel(*a) for a in calls]

    total, kernels = _profile(replay, n, dev)
    row = {"probe": "pull", "case": "sssp_push_passes", "searches": len(sources),
           "steps": len(calls), "frontier": [f for f, _ in sizes],
           "out_edges": [e for _, e in sizes],
           "out_edges_sum": sum(e for _, e in sizes),
           "ms_total": time_ms(dev, replay, n), "device_ms_total": total,
           "kernels_us_total": kernels}
    if dev.type == "cuda":
        row["bound_ms_total"] = sum(
            bound_ms(_push_bytes(V, f, e), e, device=dev)[0] for f, e in sizes)
    row["device"] = device_label(dev)
    rows = [row]
    if calls:
        i = max(range(len(calls)), key=lambda j: sizes[j][1])
        n_front, n_out = sizes[i]
        rows.append(time_case("sssp_push_largest", (
            lambda: kernel(*calls[i]), _push_bytes(V, n_front, n_out), n_out,
            {}, {"frontier": n_front, "out_edges": n_out}), n, dev))
    return rows


def _bfs_push_bytes(V: int, n_front: int, n_out: int, n_new: int) -> int:
    """What a BFS push step must move (``chip_smoke.py``'s bound): the
    frontier mask and the new mask over V, each queued row's two offsets,
    each out-edge's column and target distance, each new vertex's
    distance."""
    return V + V + 8 * n_front + 8 * n_out + 4 * n_new


def bfs_levels(graph, sources) -> list:
    """[(search, "push" | "pull", args)]: every level of the DO-BFS
    searches ``bfs.run`` makes from ``sources``, recorded by wrapping the
    push step and the pull; args are the step's positional arguments with
    the distances copied before the step (both update them in place)."""
    from gunrock_tpu_torch.algorithms import bfs

    levels, search = [], [0]

    def wrap(kind, step):
        def record(*args):
            levels.append((search[0], kind, (*args[:2], args[2].clone(),
                                             *args[3:])))
            return step(*args)
        return record

    push, pull = bfs.bfs_push_step, bfs._pull
    bfs.bfs_push_step, bfs._pull = wrap("push", push), wrap("pull", pull)
    try:
        for search[0], src in enumerate(sources):
            bfs.run(graph, src, warmup=False, device=graph.device)
    finally:
        bfs.bfs_push_step, bfs._pull = push, pull
    return levels


def _fresh(calls, uses: int):
    """An iterator over ``uses`` copies of ``calls`` (argument tuples with
    the distances third), each with its own distances, made now, before
    any timing."""
    return iter([[(*a[:2], a[2].clone(), *a[3:]) for a in calls]
                 for _ in range(uses)])


def bfs_push_passes(graph, n: int) -> list:
    """The ``bfs_push_passes`` line, the ``bfs_push_largest`` case and the
    ``bfs_crossover`` line (see the module docstring)."""
    from gunrock_tpu_torch.algorithms import bfs
    from gunrock_tpu_torch.ops.kernels.layout import pull_layout
    from gunrock_tpu_torch.utils.roofline import bound_ms

    dev, V = graph.device, graph.n_vertices
    deg = graph.out_degrees()
    kernel, pull = bfs.bfs_push_step, bfs._pull
    sources = torch.argsort(deg, descending=True, stable=True)[:8].tolist()
    levels = bfs_levels(graph, sources)
    calls = [a for _, kind, a in levels if kind == "push"]
    sizes = [torch.stack([front.sum(), torch.where(front, deg, 0).sum()]).tolist()
             for _, front, _, _, _ in calls]
    new = [int(bfs.bfs_push_step_plain(*a[:4])[0].sum())
           for a in next(_fresh(calls, 1))]
    # a profile replays 2n times a try, at most three tries; time_ms n + 1
    pool = _fresh(calls, 7 * n + 1)

    def replay():
        return [kernel(*a) for a in next(pool)]

    total, kernels = _profile(replay, n, dev)
    row = {"probe": "pull", "case": "bfs_push_passes", "searches": len(sources),
           "steps": len(calls), "frontier": [f for f, _ in sizes],
           "out_edges": [e for _, e in sizes],
           "out_edges_sum": sum(e for _, e in sizes), "new": new,
           "ms_total": time_ms(dev, replay, n), "device_ms_total": total,
           "kernels_us_total": kernels}
    if dev.type == "cuda":
        row["bound_ms_total"] = sum(
            bound_ms(_bfs_push_bytes(V, f, e, k), 0, device=dev)[0]
            for (f, e), k in zip(sizes, new))
    row["device"] = device_label(dev)
    rows = [row]
    if calls:
        i = max(range(len(calls)), key=lambda j: sizes[j][1])
        n_front, n_out = sizes[i]
        one = _fresh([calls[i]], 7 * n + 1)
        rows.append(time_case("bfs_push_largest", (
            lambda: kernel(*next(one)[0]),
            _bfs_push_bytes(V, n_front, n_out, new[i]), 0, {},
            {"frontier": n_front, "out_edges": n_out, "new": new[i]}), n, dev))

    # the crossover: the push step and the pull on every level's inputs
    layout = pull_layout(graph, unit=True)
    reps = 3
    per_level = []
    for search, kind, a in levels:
        front, dist, it = a[1], a[2], a[3]
        push_args = _fresh([(graph, front, dist, it, 0)], 6 * reps)
        pull_args = _fresh([(layout, front, dist, it)], 6 * reps)
        n_front, n_out = torch.stack(
            [front.sum(), torch.where(front, deg, 0).sum()]).tolist()
        per_level.append({
            "search": search, "level": it, "taken": kind,
            "frontier": n_front, "out_edges": n_out,
            "push_device_ms": _profile(
                lambda: kernel(*next(push_args)[0]), reps, dev)[0],
            "pull_device_ms": _profile(
                lambda: pull(*next(pull_args)[0]), reps, dev)[0]})
    rows.append({"probe": "pull", "case": "bfs_crossover",
                 "edge_budget": calls[0][4] if calls else None,  # the switch's
                 "levels": per_level, "device": device_label(dev)})
    return rows


def _cut_bytes(L) -> int:
    """What a min-cut pass must move: 12 B a real slot (row, col, rank),
    8 B a chunk, the roots and y (``chip_smoke.py``'s bound)."""
    return 12 * _n_real(L) + 8 * L.n_chunks + 4 * L.n_vertices + 4 * L.n_vertices


def mst_passes(graph, n: int) -> list:
    """The ``mst_passes`` line and the B7 cases (see the module
    docstring): the min-cut passes of one ``mst.run``, recorded by
    wrapping the kernel's entry point, replayed ``n`` times under one
    profile."""
    from gunrock_tpu_torch.algorithms import mst
    from gunrock_tpu_torch.ops.kernels.layout import slot_indices
    from gunrock_tpu_torch.utils.roofline import bound_ms

    dev = graph.device
    kernel = mst.bucketed_min_rank_cut
    res, calls = record_calls(mst, "bucketed_min_rank_cut", lambda: mst.run(
        graph, warmup=False, device=dev))
    L, ranks = calls[0][:2]
    row_ids, col_ids, _ = slot_indices(L)
    cut = [int((roots[col_ids] != roots[row_ids]).sum()) for _, _, roots in calls]
    total, kernels = _profile(lambda: [kernel(*a) for a in calls], n, dev)
    row = {"probe": "pull", "case": "mst_passes", "rounds": res.rounds,
           "passes": len(calls), "n_chunks": L.n_chunks,
           "real_slots": _n_real(L), "cut_slots": cut,
           "device_ms": [_profile(lambda a=a: kernel(*a), n, dev)[0]
                         for a in calls],
           "device_ms_total": total, "kernels_us_total": kernels,
           "mst_ms": res.elapsed_ms}
    if dev.type == "cuda":
        row["bound_ms_total"] = len(calls) * bound_ms(
            _cut_bytes(L), 2 * _n_real(L), device=dev)[0]
    row["device"] = device_label(dev)
    rows = [row]
    cases = {"b7_round1": torch.arange(L.n_vertices, dtype=torch.int32,
                                       device=dev)}
    if len(calls) > 1:
        cases["b7_round2"] = calls[1][2]
    for name, roots in cases.items():
        rows.append(time_case(name, (
            lambda roots=roots: kernel(L, ranks, roots), _cut_bytes(L),
            2 * _n_real(L), {}, {"cut_slots": int(
                (roots[col_ids] != roots[row_ids]).sum())}), n, dev))
    return rows


def _sym_edges(graph):
    """(src, dst) int64 of greedy coloring's symmetrized loop-free edges, on
    the graph's device."""
    from gunrock_tpu_torch.algorithms import color

    src, dst = color._sym_loopfree_edges(graph)
    return (torch.from_numpy(src.astype("int64")).to(graph.device),
            torch.from_numpy(dst.astype("int64")).to(graph.device))


def time_case(name: str, case, n: int, dev, **extra) -> dict:
    from gunrock_tpu_torch.utils.roofline import bound_ms

    fn, n_bytes, n_ops, library, keys = case
    row = {"probe": "pull", "case": name, **keys, **extra,
           "ms": time_ms(dev, fn, n)}
    row["device_ms"], row["kernels"] = _profile(fn, n, dev)
    if n_bytes is not None and dev.type == "cuda":  # the card's peaks
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops, device=dev)
    for lib_name, call in library.items():
        row[f"{lib_name}_ms"] = time_ms(dev, call, n)
        row[f"{lib_name}_device_ms"] = _profile(call, n, dev)[0]
    row["device"] = device_label(dev)
    return row


def sweep(graph, layouts: dict, spans: list, k_tiles: list, n: int,
          gen, b4: bool = False) -> list:
    """The sweep's lines (see the module docstring); the span lines only
    with a span table, B8's and B5's only with a column span table, the
    K-tile lines only where B5 takes a K tile."""
    from gunrock_tpu_torch.ops.kernels import spmm

    rows = []
    if spans and hasattr(layouts["unit"], "with_span_chunks"):
        b85 = hasattr(layouts["unit"], "chunk_by_cb")
        for p in spans:
            cut = {k: (lay[0].with_span_chunks(p), lay[1]) if k == "color"
                   else lay.with_span_chunks(p) for k, lay in layouts.items()}
            cs = cases(graph, cut, gen)
            for name, key in (("b3_valued", "valued"), ("b3_pr", "pr"),
                              ("b1_full", "unit"), ("b8_hits", "hits"),
                              ("b5_color", "color")):
                if name[:2] in ("b8", "b5") and not b85:
                    continue
                lay = cut[key][0] if key == "color" else cut[key]
                rows.append(time_case(name, cs[name], n, graph.device,
                                      span_chunks=p, n_spans=lay.n_spans))
    if k_tiles and hasattr(spmm, "K_TILES"):
        for kt in k_tiles:
            cs = cases(graph, layouts, gen, k_tile=kt)
            if b4:
                cs.update(b4_cases(graph, layouts, gen, k_tile=kt))
            for name in ("b5_color", "b5_float", "b5_spgemm", "b4_k32"):
                if name in cs:
                    rows.append(time_case(name, cs[name], n, graph.device,
                                          k_tile=kt))
    return rows


def greedy_passes(graph) -> dict:
    """The ``greedy_passes`` line: what each B5 pass of one greedy coloring
    ran over, recorded by wrapping the kernel's entry point."""
    from gunrock_tpu_torch.algorithms import color
    from gunrock_tpu_torch.ops.kernels import chunkplan

    kernel, passes = color.bucketed_spmm_sparse, []

    def record(layout, x, active, out_mask=None, exact=False):
        ch_act = chunkplan.chunk_activity(layout, active, out_mask)[0]
        passes.append((int(ch_act.sum()), int(active.sum()),
                       int((x != 0).any(dim=1).sum())))
        return kernel(layout, x, active, out_mask=out_mask, exact=exact)

    color.bucketed_spmm_sparse = record
    try:
        res = color.run(graph, seed=1, strategy="greedy", device=graph.device)
    finally:
        color.bucketed_spmm_sparse = kernel
    timed = passes[len(passes) - res.iterations:]
    return {"probe": "pull", "case": "greedy_passes",
            "iterations": res.iterations,
            "n_chunks": color._greedy_color_setup(graph)[0].n_chunks,
            "active_chunks": [p[0] for p in timed],
            "changed_rows": [p[1] for p in timed],
            "nonzero_x_rows": [p[2] for p in timed],
            "active_chunks_sum": sum(p[0] for p in timed)}


def row_runs(layout, group: int = 32) -> dict:
    """Runs of one output row in ``layout``: consecutive real slots of one
    row within each aligned group of ``group`` slots (a warp's), as a
    kernel folding runs on a warp's lanes meets them. ``mean_run``: real
    slots per run; ``share_ge_<n>``: the share of real slots in runs of
    n or more."""
    import numpy as np

    row = layout.row_local.cpu().numpy().reshape(-1, group)
    real = row != layout.window
    head = np.ones_like(real)
    head[:, 1:] = row[:, 1:] != row[:, :-1]
    run_id = np.cumsum(head.ravel()) - 1
    length = np.bincount(run_id)[run_id].reshape(row.shape)[real]
    n_runs = int((head & real).sum())
    out = {"group": group, "real_slots": int(real.sum()),
           "mean_run": float(real.sum() / max(n_runs, 1))}
    for n in (2, 8, group):
        out[f"share_ge_{n}"] = float((length >= n).mean()) if length.size else 0.0
    return out


def luby_passes(graph, n: int) -> dict:
    """The ``luby_passes`` line: what each B6 pass of one Luby coloring ran
    over, recorded by wrapping the kernel's entry point, and the device
    time of replaying the timed run's passes (``n`` replays under one
    profile)."""
    from gunrock_tpu_torch.algorithms import color
    from gunrock_tpu_torch.ops.kernels import chunkplan

    kernel, passes = color.bucketed_semiring_spmv_sparse_minmax, []

    def record(layout, x, active, out_mask=None):
        ch_act = chunkplan.chunk_activity(layout, active, out_mask)[0]
        passes.append((int(ch_act.sum()), (layout, x, active, out_mask)))
        return kernel(layout, x, active, out_mask)

    color.bucketed_semiring_spmv_sparse_minmax = record
    try:
        res = color.run(graph, seed=1, strategy="luby", device=graph.device)
    finally:
        color.bucketed_semiring_spmv_sparse_minmax = kernel
    timed = passes[len(passes) - res.iterations:]
    calls = [args for _, args in timed]
    total, kernels = _profile(lambda: [kernel(*a) for a in calls], n,
                              graph.device)
    return {"probe": "pull", "case": "luby_passes",
            "iterations": res.iterations,
            "n_chunks": color._color_layout(graph).n_chunks,
            "active_chunks": [p[0] for p in timed],
            "active_chunks_sum": sum(p[0] for p in timed),
            "device_ms_total": total, "kernels_us_total": kernels,
            "row_runs": row_runs(color._color_layout(graph)),
            "device": device_label(graph.device)}


def async_lines(graph, n: int) -> list:
    """``--async``'s lines: each sweep case timed, with its time a pass."""
    from gunrock_tpu_torch.ops.kernels import async_sweep
    from gunrock_tpu_torch.probes import async_cases as ac

    rows = []
    cases = ac.kernel_cases(graph, *ac.mesh_graphs(graph.device))
    for name, (g, kernel, args) in cases.items():
        fn = getattr(async_sweep, kernel)
        res = fn(*args)
        pr = kernel == "gs_sweep_pr"
        # an earlier tree's wrappers count no passes of PageRank and no
        # barriers (one pass a block a sweep there)
        run = dict(getattr(async_sweep, "LAST_RUN", {}).get(kernel, {}))
        passes = run.pop("block_passes", res[1] * ac.ASYNC_BLOCKS if pr
                         else res[2])
        n_bytes, n_ops = ac.bound_work(g, passes, 3 if pr else 2)
        row = time_case("async_" + name, (lambda fn=fn, args=args: fn(*args),
                                          n_bytes, n_ops, {}, {
            "kernel": kernel, "vertices": g.n_vertices, "edges": g.n_edges,
            "sweeps": res[1], "block_passes": passes, **run}), n, graph.device)
        row["us_per_pass"] = row["ms"] * 1e3 / passes
        if isinstance(row["device_ms"], float):
            row["device_us_per_pass"] = row["device_ms"] * 1e3 / passes
        rows.append(row)
    return rows


def banded_lines(graph, n: int) -> list:
    """``--banded``'s lines: each slab checked against the plain version,
    then timed beside ``index_select``; then the triangle count's
    times."""
    from gunrock_tpu_torch.algorithms import tc
    from gunrock_tpu_torch.ops.kernels import banded
    from gunrock_tpu_torch.probes import banded_cases as bc

    dev = graph.device
    real = bc.real_slab(graph)
    table2, idx, block_lo, block_t, span_rows = real
    buf = torch.empty(idx.numel() + 1, dtype=idx.dtype, device=dev)
    buf[1:] = idx
    slabs = {"real": real,
             "real_unaligned": (table2, buf[1:], block_lo, block_t, span_rows),
             **bc.synthetic_slabs(dev)}
    rows = []
    for name, (table2, idx, block_lo, block_t, span_rows) in slabs.items():
        def call(t2=table2, ix=idx, lo=block_lo, r=span_rows, t=block_t):
            return banded.banded_gather(t2, ix, lo, span_rows=r, block_t=t)

        if not torch.equal(call(), banded.banded_gather_plain(
                table2, idx, block_lo, span_rows=span_rows, block_t=block_t)):
            raise AssertionError(f"banded_{name}: not its plain version")
        flat = table2.view(-1)
        read = bc.read_indices(idx, block_lo, span_rows, block_t)
        row = time_case("banded_" + name, (
            call, bc.bound_bytes(idx, block_lo), 0,
            {"index_select": lambda f=flat, r=read: f.index_select(0, r)},
            {"positions": idx.numel(), "span_rows": span_rows,
             "block_t": block_t, "table": flat.numel(),
             "aligned": idx.data_ptr() % 16 == 0}), n, dev)
        row["share_of_bound"] = (
            row["bound_ms"] / row["device_ms"]
            if isinstance(row["device_ms"], float) and "bound_ms" in row
            else row["device_ms"])
        rows.append(row)
    rk = tc.ranked_dag(graph)
    rows.append({
        "probe": "pull", "case": "banded_tc", "wedges": rk["n_wedges"],
        "slabs": bc.TC_SLABS,
        "ms": [tc.run(graph, device=dev).elapsed_ms for _ in range(3)],
        "slabbed_ms": [tc.run(graph, max_wedges=-(-rk["n_wedges"]
                                                  // bc.TC_SLABS),
                              device=dev).elapsed_ms for _ in range(3)],
        "device": device_label(dev)})
    return rows


def build_layouts(graph) -> dict:
    from gunrock_tpu_torch.algorithms import color
    from gunrock_tpu_torch.ops.kernels.layout import (
        dense_window_chunk,
        pull_layout,
        push_layout,
    )
    from gunrock_tpu_torch.ops.kernels.semiring import _BIG

    dense_w, dense_c = dense_window_chunk(graph.n_vertices) or (2048, 256)
    return {"unit": pull_layout(graph, unit=True), "valued": pull_layout(graph),
            "pr": pull_layout(graph, window=dense_w, chunk=dense_c),
            "big": pull_layout(graph, pad_value=_BIG),
            "hits": push_layout(graph, window=dense_w, chunk=dense_c,
                                unit=True),
            "color": color._greedy_color_setup(graph),
            "luby": color._color_layout(graph),
            "geo": push_layout(graph, unit=True)}


def predecessor_lines(scale: int, n: int, device) -> list:
    """The ``pred_bfs`` and ``pred_sssp`` lines (see the module
    docstring)."""
    from gunrock_tpu_torch.algorithms import bfs, sssp
    from gunrock_tpu_torch.graph.reorder import degree_sort
    from gunrock_tpu_torch.io.generators import rmat_graph
    from gunrock_tpu_torch.ops.kernels import predecessors as P
    from gunrock_tpu_torch.ops.kernels.layout import pull_layout
    from gunrock_tpu_torch.ops.kernels.semiring import _BIG
    from gunrock_tpu_torch.probes.predecessor_cases import bound_bytes
    from gunrock_tpu_torch.utils.roofline import bound_ms

    graph, _ = degree_sort(rmat_graph(scale, 16, seed=1, undirected=True,
                                      device=device))
    dev = graph.device
    live = torch.nonzero(graph.out_degrees().cpu() > 0).flatten()
    gen = torch.Generator().manual_seed(1)
    sources = live[torch.randperm(live.numel(), generator=gen)[:8]].tolist()
    rows = []
    for kind in ("bfs", "sssp"):
        if kind == "bfs":
            lay = pull_layout(graph, unit=True)
            dists = [bfs.bfs_kernel_do(graph, s, layout=lay)[0]
                     for s in sources]
            kernel = P.bfs_predecessors
        else:
            lay = pull_layout(graph, pad_value=_BIG)
            dists = [sssp.sssp_kernel_do(graph, s, layout=lay)[0]
                     for s in sources]
            kernel = P.sssp_predecessors

        def run():
            return [kernel(graph, d) for d in dists]

        def plain():
            return [P.predecessors_plain(graph, d, kind) for d in dists]

        equal = all(torch.equal(a, b) for a, b in zip(run(), plain()))
        k = len(dists)
        row = {"probe": "pull", "case": f"pred_{kind}", "scale": scale,
               "vertices": graph.n_vertices, "slots": graph.n_edges,
               "sources": sources, "equal": equal,
               "ms": time_ms(dev, run, n) / k}
        busy, kernels = _profile(run, n, dev)
        row["device_ms"] = busy / k if isinstance(busy, float) else busy
        row["kernels"] = kernels
        row["plain_ms"] = time_ms(dev, plain, n) / k
        busy = _profile(plain, n, dev)[0]
        row["plain_device_ms"] = busy / k if isinstance(busy, float) else busy
        if dev.type == "cuda":
            need, full = zip(*(bound_bytes(graph, d, kind) for d in dists))
            row["bound_ms"] = sum(bound_ms(b, 0, device=dev)[0]
                                  for b in need) / k
            row["full_bound_ms"] = sum(bound_ms(b, 0, device=dev)[0]
                                       for b in full) / k
        row["device"] = device_label(dev)
        rows.append(row)
    return rows


def msbfs_level_bytes(graph, n_words: int, slots: int, gained: int) -> int:
    """Bytes one level of ``msbfs_pull`` must move: the offsets, the
    front, seen and next words over V (front once: its gathers hit L2),
    4 B a slot its scans need, and 4 B a distance it writes (``gained``
    searches reaching a vertex). The frontier bitmaps' V / 4 bytes are
    left out."""
    V = graph.n_vertices
    return 4 * (V + 1) + 12 * V * n_words + 4 * slots + 4 * gained


def msbfs_lines(scale: int, n: int, device) -> list:
    """The ``msbfs_level`` lines and the ``msbfs_query`` line (see the
    module docstring)."""
    from gunrock_tpu_torch.algorithms import bfs
    from gunrock_tpu_torch.graph.reorder import degree_sort
    from gunrock_tpu_torch.io.generators import rmat_graph
    from gunrock_tpu_torch.ops.kernels import msbfs as M
    from gunrock_tpu_torch.utils.roofline import bound_ms

    graph, _ = degree_sort(rmat_graph(scale, 16, seed=1, undirected=True,
                                      device=device))
    dev, V, E, K = graph.device, graph.n_vertices, graph.n_edges, 32
    live = torch.nonzero(graph.out_degrees().cpu() > 0).flatten()
    gen = torch.Generator().manual_seed(1)
    src = live[torch.randperm(live.numel(), generator=gen)[:K]].to(dev)
    nw = M.n_words(K)
    st = M.MsbfsState.empty(V, K, dev)
    M.msbfs_start(graph, src, st)
    label = device_label(dev)
    rows, level, c = [], 0, st.counts.tolist()
    while c[level % 2]:
        n_front, before = c[level % 2], c[2]
        saved = {k: t.clone() for k, t in st.tensors().items()}
        M.msbfs_pull(graph, st, level)
        c = st.counts.tolist()
        slots = c[2] - before
        gained = int((st.dist == level + 1).sum())
        # replays on the level's own inputs, in a state of their own: the
        # distances they write are the same again
        again = M.MsbfsState(**saved)
        seen0, aux0 = again.seen.clone(), again.aux.clone()
        front, spare = again.front, again.next

        def replay(again=again, seen0=seen0, aux0=aux0, front=front,
                   spare=spare, level=level):
            again.seen.copy_(seen0)
            again.aux.copy_(aux0)
            again.front, again.next = front, spare
            M.msbfs_pull(graph, again, level)

        row = {"probe": "pull", "case": "msbfs_level", "scale": scale,
               "vertices": V, "slots_total": E, "level": level,
               "n_front": n_front, "slots": slots, "scan_share": slots / E,
               "gained": gained}
        busy, kernels = _profile(replay, n, dev)
        row["device_ms"] = (sum(us for k, us in kernels.items()
                                if "msbfs_pull" in k) / 1e3
                            if isinstance(kernels, dict) else kernels)
        row["replay_device_ms"] = busy  # with the copies of seen and aux
        if dev.type == "cuda":
            row["bound_ms"] = bound_ms(msbfs_level_bytes(
                graph, nw, slots, gained), 0, device=dev)[0]
        row["device"] = label
        rows.append(row)
        level += 1
    query = {"probe": "pull", "case": "msbfs_query", "scale": scale,
             "sources": K, "depth": level, "slots": c[2],
             "scan_share": c[2] / (level * E * nw),
             "ms": time_ms(dev, lambda: bfs.msbfs_kernel(graph, src), n),
             "device_ms": _profile(lambda: bfs.msbfs_kernel(graph, src), n,
                                   dev)[0],
             "level_device_ms_sum": (sum(r["device_ms"] for r in rows)
                                     if dev.type == "cuda" else None),
             "device": label}
    return rows + [query]


def main(argv=None) -> int:
    from gunrock_tpu_torch.probes.v5_floor import probe_graph

    p = argparse.ArgumentParser(prog="gunrock_tpu_torch.probes.pull")
    p.add_argument("--scale", type=int, default=18)
    p.add_argument("--num_runs", type=int, default=20)
    p.add_argument("--sweep", default="",
                   help="comma-separated span lengths P to time")
    p.add_argument("--k_tiles", default="",
                   help="comma-separated K tiles of B5 to time")
    p.add_argument("--greedy", action="store_true",
                   help="count each B5 pass's active chunks in one greedy "
                        "coloring")
    p.add_argument("--b4_b6", action="store_true",
                   help="also time B4's and B6's cases")
    p.add_argument("--luby", action="store_true",
                   help="count each B6 pass's active chunks in one Luby "
                        "coloring and time them all")
    p.add_argument("--b2_b9", action="store_true",
                   help="also time B2's and B9's cases")
    p.add_argument("--geo", action="store_true",
                   help="count each Weiszfeld step's active chunks in one "
                        "geo run and time them all")
    p.add_argument("--sssp_push", action="store_true",
                   help="time every push step of eight DO-SSSP searches")
    p.add_argument("--bfs_push", action="store_true",
                   help="time every push step of eight DO-BFS searches, and "
                        "the push and the pull on every level")
    p.add_argument("--mst", action="store_true",
                   help="time every min-cut pass of one MST run, and B7's "
                        "cases")
    p.add_argument("--async", dest="async_", action="store_true",
                   help="time only the async sweep kernels on the async "
                        "path's seven cases")
    p.add_argument("--banded", action="store_true",
                   help="time only the banded gather on the triangle "
                        "count's real slab and on synthetic slabs")
    p.add_argument("--predecessors", action="store_true",
                   help="time only the predecessor pass of BFS and SSSP "
                        "against its plain version")
    p.add_argument("--msbfs", action="store_true",
                   help="time only multi-source BFS's level kernel, level "
                        "by level, at K=32")
    p.add_argument("--device", default="cuda")
    ns = p.parse_args(argv)
    if ns.msbfs:
        for row in msbfs_lines(ns.scale, ns.num_runs, ns.device):
            print(json.dumps(row), flush=True)
        return 0
    if ns.predecessors:
        for row in predecessor_lines(ns.scale, ns.num_runs, ns.device):
            print(json.dumps(row), flush=True)
        return 0
    graph = probe_graph(ns.scale, ns.device)
    for flag, lines in ((ns.async_, async_lines), (ns.banded, banded_lines)):
        if flag:
            for row in lines(graph, ns.num_runs):
                print(json.dumps(row), flush=True)
            return 0
    layouts = build_layouts(graph)
    gen = torch.Generator(device=graph.device).manual_seed(1)
    timed = cases(graph, layouts, gen)
    if ns.b4_b6:
        timed.update(b4_cases(graph, layouts, gen))
        timed.update(b6_cases(graph, layouts, gen))
    if ns.b2_b9:
        timed.update(b2_cases(graph, layouts, gen))
        timed.update(b9_cases(graph, layouts, gen))
    for name, case in timed.items():
        print(json.dumps(time_case(name, case, ns.num_runs, graph.device)),
              flush=True)
    spans = [int(s) for s in ns.sweep.split(",") if s]
    k_tiles = [int(s) for s in ns.k_tiles.split(",") if s]
    for row in sweep(graph, layouts, spans, k_tiles, ns.num_runs, gen,
                     ns.b4_b6):
        print(json.dumps(row), flush=True)
    if ns.greedy:
        print(json.dumps(greedy_passes(graph)), flush=True)
    if ns.luby:
        print(json.dumps(luby_passes(graph, 3)), flush=True)
    if ns.geo:
        print(json.dumps(geo_passes(graph, 3)), flush=True)
    if ns.sssp_push:
        for row in sssp_push_passes(graph, ns.num_runs):
            print(json.dumps(row), flush=True)
    if ns.bfs_push:
        for row in bfs_push_passes(graph, ns.num_runs):
            print(json.dumps(row), flush=True)
    if ns.mst:
        for row in mst_passes(graph, ns.num_runs):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
