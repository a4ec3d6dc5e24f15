"""Boruvka min-cut pass: per row, the least rank over its cut edges.

Port of ``gunrock_tpu/ops/pallas/mst_min.py::bucketed_min_rank_cut``
(kernel ``_make_mst_min_kernel``):

    y[row] = min over the edges e at row with root[col_e] != root[row]
             of rank_e, else NO_CUT

over a layout of the doubled canonical edge set (every undirected edge
seen from both endpoints), where ``rank_e`` is the edge's position in the
global (weight, id) order, so one min packs Boruvka's (min weight, min id)
choice.

Ranks and roots are int32 here, and "no cut edge" is the one sentinel
``NO_CUT`` = 2**30 from the kernel to the caller: the JAX kernel's f32
ranks, f32 roots and ``_BIG`` are a TPU constraint (exact only below
2**24). The layout's ``values`` are f32 and are not read; the ranks come
as an int32 tensor in slot order beside the layout (``NO_CUT`` on padding
slots), which ``algorithms/mst.py::_mst_rank_layout`` builds.

CUDA source: ``csrc/mst_min.cu``: a block per span of the layout's span
table reduces its cut edges' ranks into the row window in shared memory
(int atomicMin), and a combine pass takes the min of each row block's
spans into y, which the kernel writes whole.
"""

from __future__ import annotations

import ctypes

import torch

from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.layout import BucketedEdges, slot_indices

NO_CUT = 2**30
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gr_min_rank_cut": [_I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                        _I, _I, _I, _P],
}
# a span block holds the row block's roots and its window, W ints each,
# beside 1 KB of its own: within the 227 KB one block can take on Hopper
MAX_WINDOW = (227 * 1024 - 1024) // 8


def bucketed_min_rank_cut(layout: BucketedEdges, ranks: torch.Tensor,
                          roots: torch.Tensor) -> torch.Tensor:
    """int32[V]: ``y[v]`` = the least rank over v's cut edges, ``NO_CUT`` if
    it has none. ``ranks``: int32 per slot of ``layout``; ``roots``:
    int32[V], each vertex's component."""
    dev = layout.device
    V, W = layout.n_vertices, layout.window
    _build.check_tensor(roots, "roots", torch.int32, (V,), dev)
    _build.check_tensor(ranks, "ranks", torch.int32,
                        (layout.n_chunks * layout.chunk,), dev)
    if layout.n_chunks == 0:
        return torch.full((V,), NO_CUT, dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        return bucketed_min_rank_cut_plain(layout, ranks, roots)
    if dev.type != "cuda":
        raise ValueError(f"no min-cut kernel for device {dev}")
    if W % 4 or W > MAX_WINDOW:
        raise ValueError(f"the min-cut pass takes a window that is a multiple "
                         f"of 4 and at most {MAX_WINDOW}, got {W}")
    y = torch.empty(layout.n_row_blocks * W, dtype=torch.int32, device=dev)
    # the partial windows of the spans, then their touched flags
    scratch = torch.empty(layout.n_spans * (W + 1), dtype=torch.int32,
                          device=dev)
    lib = _build.load("mst_min", _SIGNATURES)
    err = lib.gr_min_rank_cut(
        layout.n_spans, _build.ptr(layout.span_first_chunk),
        _build.ptr(layout.rb_first_span), layout.n_chunks,
        _build.ptr(layout.chunk_rb), _build.ptr(layout.chunk_cb),
        _build.ptr(layout.row_local), _build.ptr(layout.col_local),
        _build.ptr(ranks), _build.ptr(roots), _build.ptr(y),
        _build.ptr(scratch), W, layout.chunk, V, layout.n_row_blocks,
        _build.stream(dev),
    )
    _build.check(err, "bucketed_min_rank_cut")
    _build.LAUNCHES["bucketed_min_rank_cut"] += 1
    return y[:V]


def bucketed_min_rank_cut_plain(layout: BucketedEdges, ranks: torch.Tensor,
                                roots: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bucketed_min_rank_cut`."""
    y = torch.full((layout.n_row_blocks * layout.window,), NO_CUT,
                   dtype=torch.int32, device=roots.device)
    if layout.n_chunks:
        row, col, slot = slot_indices(layout)
        cut = roots[col] != roots[row]
        y.scatter_reduce_(0, row[cut], ranks[slot[cut]], reduce="amin",
                          include_self=True)
    return y[: layout.n_vertices]
