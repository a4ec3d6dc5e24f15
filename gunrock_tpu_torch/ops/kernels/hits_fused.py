"""Fused HITS pass: both Jacobi accumulations in one edge sweep.

Port of ``gunrock_tpu/ops/pallas/hits_fused.py::hits_fused_pass`` (kernel
``_make_hits_kernel``). Over the unit push layout (rows = sources, cols =
destinations):

    hub_raw[src]  = sum over edges (src, dst) of auth[dst]
    auth_raw[dst] = sum over edges (src, dst) of hub[src]

Both read the previous iteration's vectors, so one sweep computes both.
Padding slots (``row_local == W``, ``col_local == 0``) take part in
neither sum. Vertices no edge reaches get 0.

CUDA source: ``csrc/hits_fused.cu``: one block per span of the layout's
row span table (hub side) and of its column span table (auth side), each
reducing into a window in shared memory, then a pass that combines each
block's spans into ``hub_raw`` and ``auth_raw``.
"""

from __future__ import annotations

import ctypes

import torch

from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.layout import BucketedEdges, slot_indices
from gunrock_tpu_torch.ops.kernels.semiring import check_window

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gr_hits_fused": [_I, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                      _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def hits_fused_pass(layout: BucketedEdges, auth: torch.Tensor,
                    hub: torch.Tensor):
    """(hub_raw f32[V], auth_raw f32[V]): both unnormalized sums from one
    sweep of the push layout (its values are not read)."""
    dev = layout.device
    V, W = layout.n_vertices, layout.window
    _build.check_tensor(auth, "auth", torch.float32, (V,), dev)
    _build.check_tensor(hub, "hub", torch.float32, (V,), dev)
    if layout.n_chunks == 0:
        z = torch.zeros(V, dtype=torch.float32, device=dev)
        return z, z.clone()
    if dev.type == "cpu":
        return hits_fused_pass_plain(layout, auth, hub)
    if dev.type != "cuda":
        raise ValueError(f"no HITS kernel for device {dev}")
    check_window(W)
    hub_raw = torch.empty(layout.n_row_blocks * W, dtype=torch.float32,
                          device=dev)
    auth_raw = torch.empty(layout.n_col_blocks * W, dtype=torch.float32,
                           device=dev)
    # the partial windows of the row spans and then the column spans, then
    # their touched flags
    n_spans = layout.n_spans + layout.n_col_spans
    scratch = torch.empty(n_spans * (W + 1), dtype=torch.float32, device=dev)
    lib = _build.load("hits_fused", _SIGNATURES)
    err = lib.gr_hits_fused(
        layout.n_spans, _build.ptr(layout.span_first_chunk),
        _build.ptr(layout.rb_first_span), layout.n_col_spans,
        _build.ptr(layout.chunk_by_cb), _build.ptr(layout.col_span_first_chunk),
        _build.ptr(layout.cb_first_span), layout.n_chunks,
        _build.ptr(layout.chunk_rb), _build.ptr(layout.chunk_cb),
        _build.ptr(layout.row_local), _build.ptr(layout.col_local),
        _build.ptr(auth), _build.ptr(hub), _build.ptr(hub_raw),
        _build.ptr(auth_raw), _build.ptr(scratch), W, layout.chunk, V,
        layout.n_row_blocks, layout.n_col_blocks, _build.stream(dev),
    )
    _build.check(err, "hits_fused_pass")
    _build.LAUNCHES["hits_fused_pass"] += 1
    return hub_raw[:V], auth_raw[:V]


def hits_fused_pass_plain(layout: BucketedEdges, auth: torch.Tensor,
                          hub: torch.Tensor):
    """Plain PyTorch version of :func:`hits_fused_pass`."""
    V = layout.n_vertices
    src, dst, _ = slot_indices(layout)  # real slots only
    hub_raw = torch.zeros(V, dtype=torch.float32, device=auth.device)
    auth_raw = torch.zeros(V, dtype=torch.float32, device=auth.device)
    hub_raw.index_add_(0, src, auth[dst])
    auth_raw.index_add_(0, dst, hub[src])
    return hub_raw, auth_raw
