"""The TPU probes' kernels on Hopper: the dense pass's floor modes, a
gather, and a bulk block copy. Each wrapper runs its plain PyTorch version
for CPU tensors and its CUDA kernel for CUDA tensors.

- :func:`spmv_floor` replaces ``benchmarks/probe_v5_floor.py::run_variant``
  (variants ``dma`` and ``gather``; ``full`` is the dense pass itself,
  ``semiring.bucketed_semiring_spmv``). CUDA source: the floor modes of
  the dense template in ``csrc/semiring.cu``.
- :func:`gather` replaces the gathers of ``benchmarks/probe_gather.py``
  and ``benchmarks/probe_gather2.py``: ``take_along_axis`` on any axis of
  a 1-3-D tensor, or the flat ``x[idx]``. CUDA source: ``csrc/probes.cu``.
- :func:`block_copy_sum` replaces ``benchmarks/probe_dma.py``'s kernel:
  the sum of the index-named blocks ``x[meta[i]]``, i < cnt, copied into
  shared memory by the Tensor Memory Accelerator. CUDA source:
  ``csrc/probes.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels.layout import BucketedEdges
from gunrock_tpu_torch.ops.kernels.semiring import _SIGNATURES as _SEMIRING_SIGNATURES

FLOOR_MODES = {"gather": 1, "dma": 2}  # probe variant: kernel mode
FLOOR_SCALE = 1e-30  # the probe's weight on each row block's sum
_COPY_STAGES = 4  # kStages in csrc/probes.cu: the ring's buffers
_MAX_COPY_SMEM = 200 * 1024  # the block copy's ring, within 227 KB

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "gr_gather": [_I, _P, _P, _P, _L, _L, _L, _L, _P],
    "gr_block_copy_sum": [_I, _P, _P, _I, _P, _I, _I, _P, _P, _P],
}


def _cuda_or_raise(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no {what} kernel for device {dev}")


# ---- floor modes of the dense pass ------------------------------------

def spmv_floor(layout: BucketedEdges, x: torch.Tensor,
               mode: str) -> torch.Tensor:
    """f32[n_row_blocks, W]: the probe's floor of the dense plus_times pass
    over the valued ``layout``. Every entry of row block rb is 1e-30 times
    the sum, over rb's chunks and their real slots, of ``values`` (``mode=
    "dma"``: the stream alone) or of ``values * x[col]`` (``"gather"``: the
    stream and the gather, no scatter). Blocks no chunk reaches are 0.
    The kernel walks the layout's span table, the dense pass's loop."""
    dev = layout.device
    _build.check_tensor(x, "x", torch.float32, (layout.n_vertices,), dev)
    if mode not in FLOOR_MODES:
        raise ValueError(f"mode must be one of {sorted(FLOOR_MODES)}, got {mode!r}")
    W = layout.window
    if layout.n_chunks == 0:
        return torch.zeros((layout.n_row_blocks, W), dtype=torch.float32,
                           device=dev)
    if dev.type == "cpu":
        return spmv_floor_plain(layout, x, mode)
    _cuda_or_raise(dev, "floor")
    t_span = torch.empty(layout.n_spans, dtype=torch.float32, device=dev)
    y = torch.empty((layout.n_row_blocks, W), dtype=torch.float32, device=dev)
    lib = _build.load("semiring", _SEMIRING_SIGNATURES)
    err = lib.gr_spmv_dense_floor(
        FLOOR_MODES[mode], layout.n_spans, _build.ptr(layout.span_first_chunk),
        _build.ptr(layout.rb_first_span), layout.n_chunks,
        _build.ptr(layout.chunk_cb),
        _build.ptr(layout.row_local), _build.ptr(layout.col_local),
        _build.ptr(layout.values), _build.ptr(x), _build.ptr(t_span),
        _build.ptr(y), W, layout.chunk, layout.n_vertices,
        layout.n_row_blocks, _build.stream(dev),
    )
    what = f"semiring_floor_{mode}"
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    return y


def spmv_floor_plain(layout: BucketedEdges, x: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """Plain PyTorch version of :func:`spmv_floor`."""
    W, C, n = layout.window, layout.chunk, layout.n_chunks
    real = layout.row_local != W
    terms = torch.where(real, layout.values, 0.0)
    if mode == "gather":
        x_pad = torch.zeros(layout.n_col_blocks * W, dtype=torch.float32,
                            device=x.device)
        x_pad[: layout.n_vertices] = x
        base = layout.chunk_cb.long().repeat_interleave(C) * W
        terms = terms * x_pad[base + layout.col_local]
    acc = torch.zeros(layout.n_row_blocks, dtype=torch.float32,
                      device=x.device)
    acc.index_add_(0, layout.chunk_rb.long(), terms.view(n, C).sum(1))
    return (acc * FLOOR_SCALE)[:, None].expand(-1, W).contiguous()


# ---- gather ------------------------------------------------------------

def _gather_shape(x: torch.Tensor, idx: torch.Tensor, axis):
    """(inner, n_axis_idx, n_axis_x) of the kernel for these shapes;
    raises where they do not fit."""
    if axis is None:
        return 1, idx.numel(), x.numel()
    if not 1 <= x.dim() <= 3 or idx.dim() != x.dim():
        raise ValueError(f"x and idx must both be 1-3-D, got {tuple(x.shape)} "
                         f"and {tuple(idx.shape)}")
    axis = axis % x.dim()
    other = [d for d in range(x.dim()) if d != axis]
    if [x.shape[d] for d in other] != [idx.shape[d] for d in other]:
        raise ValueError(f"x {tuple(x.shape)} and idx {tuple(idx.shape)} "
                         f"must agree on every axis but {axis}")
    inner = 1
    for d in range(axis + 1, x.dim()):
        inner *= x.shape[d]
    return inner, idx.shape[axis], x.shape[axis]


def gather(x: torch.Tensor, idx: torch.Tensor, axis: int | None) -> torch.Tensor:
    """f32 of idx's shape: ``take_along_axis(x, idx, axis)``, or the flat
    ``x.reshape(-1)[idx]`` for ``axis=None``. x: contiguous f32; idx:
    contiguous int32 on x's device, every entry in [0, x's size along the
    axis) (range-checked in the checked build only)."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 tensor, got {x.dtype}")
    if idx.dtype != torch.int32 or not idx.is_contiguous() or idx.device != x.device:
        raise ValueError(f"idx must be a contiguous int32 tensor on {x.device}, "
                         f"got {idx.dtype} on {idx.device}")
    inner, n_axis_idx, n_axis_x = _gather_shape(x, idx, axis)
    dev = x.device
    if dev.type == "cpu":
        return gather_plain(x, idx, axis)
    _cuda_or_raise(dev, "gather")
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    if idx.numel() == 0:
        return out
    # four outputs a thread, 256 threads a block
    blocks = min(-(-idx.numel() // 1024), 32 * _build.sm_count(dev))
    lib = _build.load("probes", _SIGNATURES)
    err = lib.gr_gather(blocks, _build.ptr(x), _build.ptr(idx), _build.ptr(out),
                        idx.numel(), inner, n_axis_idx, n_axis_x,
                        _build.stream(dev))
    _build.check(err, "gather")
    _build.LAUNCHES["gather"] += 1
    return out


def gather_plain(x: torch.Tensor, idx: torch.Tensor, axis: int | None) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather`."""
    if axis is None:
        return x.reshape(-1)[idx.long()]
    return torch.take_along_dim(x, idx.long(), dim=axis)


# ---- bulk block copy ----------------------------------------------------

def _check_block_copy(x: torch.Tensor, meta: torch.Tensor, cnt: torch.Tensor) -> None:
    if (x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] != 128
            or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous float32 [n_blocks, rows, 128] "
                         f"tensor, got {x.dtype}{tuple(x.shape)}")
    _build.check_tensor(meta, "meta", torch.int32, (meta.numel(),), x.device)
    _build.check_tensor(cnt, "cnt", torch.int32, (1,), x.device)


def block_copy_sum(x: torch.Tensor, meta: torch.Tensor,
                   cnt: torch.Tensor) -> torch.Tensor:
    """f32[1, rows, 128] filled with the sum of every element of the blocks
    ``x[meta[i]]`` for i < ``cnt[0]`` (read on the device), as the TPU
    probe's y. x: [n_blocks, rows, 128] f32; meta: int32[n] with entries in
    [0, n_blocks); cnt: int32[1]."""
    _check_block_copy(x, meta, cnt)
    dev = x.device
    if dev.type == "cpu":
        return block_copy_sum_plain(x, meta, cnt)
    _cuda_or_raise(dev, "block copy")
    n_blocks, rows = x.shape[0], x.shape[1]
    block_floats = rows * 128
    if _COPY_STAGES * block_floats * 4 > _MAX_COPY_SMEM:
        raise ValueError(f"blocks of {rows} rows do not fit the shared-memory "
                         "ring")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned for the bulk copy")
    total = torch.zeros(1, dtype=torch.float32, device=dev)
    y = torch.empty((1, rows, 128), dtype=torch.float32, device=dev)
    blocks = max(1, min(_build.sm_count(dev), -(-meta.numel() // 64)))
    lib = _build.load("probes", _SIGNATURES)
    err = lib.gr_block_copy_sum(blocks, _build.ptr(x), _build.ptr(meta),
                                meta.numel(), _build.ptr(cnt), n_blocks,
                                block_floats, _build.ptr(total), _build.ptr(y),
                                _build.stream(dev))
    _build.check(err, "block_copy_sum")
    _build.LAUNCHES["block_copy_sum"] += 1
    return y


def block_copy_sum_plain(x: torch.Tensor, meta: torch.Tensor,
                         cnt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`block_copy_sum`."""
    n = min(int(cnt[0]), meta.numel())
    total = x[meta[:n].long()].sum()
    return total.expand(1, x.shape[1], 128).contiguous()
