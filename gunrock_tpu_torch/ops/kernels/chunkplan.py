"""Active-chunk plan of the frontier-sparse kernels.

Port of ``gunrock_tpu/ops/pallas/chunkplan.py::chunk_activity`` together
with the word packing and compaction of
``gunrock_tpu/ops/pallas/semiring.py::_sparse_chunk_select``. A chunk is
active iff one of its real edges' source sub-blocks (W/32 vertices) holds
an ``active`` vertex and, with ``out_mask``, one of its destination
sub-blocks holds an ``out_mask`` vertex:

    ch_act[i] = (act_words[chunk_cb[i]] & src_bits[i]) != 0
                [& (om_words[chunk_rb[i]] & dst_bits[i]) != 0]

``active=None`` means every source is active: the first test becomes
``src_bits[i] != 0`` (the chunk has a real slot).

Returns ``(ch_act, queue, count)``: the bool mask, the ids of the active
chunks in ascending order in ``queue[:count]`` and ``count`` as a
one-element int32 tensor on the device (read by the next kernel, never by
the host). With ``queue=False`` only the mask is made: ``(ch_act, None,
None)``, what the span passes take.

CUDA source: ``csrc/chunkplan.cu`` (one cooperative launch).
"""

from __future__ import annotations

import ctypes

import torch

from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.layout import BucketedEdges

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGNATURES = {
    "gr_chunk_activity": [_P, _P, _L, _I, _I, _I, _P, _P, _P, _P, _I, _P,
                          _I, _P, _P, _P],
}
_NOT_SUPPORTED = 801  # cudaErrorNotSupported: no cooperative launch


def chunk_activity(layout: BucketedEdges, active: torch.Tensor | None,
                   out_mask: torch.Tensor | None = None, queue: bool = True):
    """(ch_act bool[n_chunks], queue int32[n_chunks], count int32[1]);
    ``(ch_act, None, None)`` with ``queue=False``."""
    dev = layout.device
    V = layout.n_vertices
    if active is not None:
        _build.check_tensor(active, "active", torch.bool, (V,), dev)
    if out_mask is not None:
        _build.check_tensor(out_mask, "out_mask", torch.bool, (V,), dev)
    if dev.type == "cpu":
        return chunk_activity_plain(layout, active, out_mask, queue)
    if dev.type != "cuda":
        raise ValueError(f"no chunk_activity kernel for device {dev}")
    n, n_cb, n_rb = layout.n_chunks, layout.n_col_blocks, layout.n_row_blocks
    blocks = _build.sm_count(dev)
    # one buffer: [count | act_words | om_words | block counts | queue |
    # ch_act (bytes)]
    n_words = 1 + n_cb + n_rb + blocks
    n_q = n if queue else 0
    buf = torch.empty(n_words + n_q + -(-n // 4), dtype=torch.int32,
                      device=dev)
    q = buf[n_words:n_words + n_q]
    ch_act = buf[n_words + n_q:].view(torch.uint8)[:n].view(torch.bool)
    # pointers from buf's own (an empty view's data_ptr() is 0)
    lib = _build.load("chunkplan", _SIGNATURES)
    err = lib.gr_chunk_activity(
        _build.ptr(active), _build.ptr(out_mask), V, layout.window, n_cb,
        n_rb, _build.ptr(layout.chunk_cb), _build.ptr(layout.chunk_rb),
        _build.ptr(layout.src_bits), _build.ptr(layout.dst_bits), n,
        _build.ptr(buf), blocks, buf.data_ptr() + 4 * (n_words + n_q),
        buf.data_ptr() + 4 * n_words if queue else None, _build.stream(dev),
    )
    if err == _NOT_SUPPORTED:
        raise RuntimeError("chunk_activity: the device has no cooperative "
                           "launch (cudaDevAttrCooperativeLaunch)")
    _build.check(err, "chunk_activity")
    _build.LAUNCHES["chunk_activity"] += 1
    if not queue:
        return ch_act, None, None
    return ch_act, q, buf[:1]


def _pack_words(mask: torch.Tensor, window: int, n_blocks: int) -> torch.Tensor:
    """int32[n_blocks]: bit b of word w set iff sub-block b of window w
    holds a vertex of ``mask``."""
    pad = torch.zeros(n_blocks * window, dtype=torch.bool, device=mask.device)
    pad[: mask.shape[0]] = mask
    blk = pad.view(n_blocks, 32, window // 32).any(dim=2)
    bits = torch.ones(32, dtype=torch.int64, device=mask.device) << torch.arange(
        32, device=mask.device)
    words = (blk.to(torch.int64) * bits).sum(dim=1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def chunk_activity_plain(layout: BucketedEdges, active: torch.Tensor | None,
                         out_mask: torch.Tensor | None = None,
                         queue: bool = True):
    """Plain PyTorch version of :func:`chunk_activity`."""
    W = layout.window
    if active is None:
        ch_act = layout.src_bits != 0
    else:
        act_words = _pack_words(active, W, layout.n_col_blocks)
        ch_act = (act_words[layout.chunk_cb.long()] & layout.src_bits) != 0
    if out_mask is not None:
        om_words = _pack_words(out_mask, W, layout.n_row_blocks)
        ch_act &= (om_words[layout.chunk_rb.long()] & layout.dst_bits) != 0
    if not queue:
        return ch_act, None, None
    ids = torch.nonzero(ch_act).flatten().to(torch.int32)
    q = torch.zeros(layout.n_chunks, dtype=torch.int32, device=ch_act.device)
    q[: ids.shape[0]] = ids
    count = torch.tensor([ids.shape[0]], dtype=torch.int32, device=ch_act.device)
    return ch_act, q, count
