"""Banded gather: ``out[t] = table[idx[t]]`` when each block of ``idx``
stays inside a bounded window of ``table``.

Port of ``gunrock_tpu/ops/pallas/banded.py::banded_gather`` (kernel
``_make_banded_kernel``), the per-slab adjacency gather of triangle
counting's wedge enumeration: a block of ``block_t`` consecutive wedges
reads adjacency positions inside a window of ``2 * block_t + max_degree``
(``algorithms/tc.py::build_dag_ranked``).

    lo_g = block_lo[t // block_t] * 128
    out[t] = table.flat[lo_g + clamp(idx[t] - lo_g, 0, span_rows*128 - 1)]

An index inside its block's window gives ``table.flat[idx[t]]``; one
outside gives the clamped element (the one the JAX kernel returns too) and
never reads outside the window. The caller keeps ``block_lo[g] + span_rows
<= n_rows_pad`` (:func:`pad_table`).

On the card a flat gather is native, so the window is the contract and
not a correctness device: the kernel reads the table in global memory
(L2-resident) from a persistent grid, 16-byte vectors of ``idx`` loaded
ahead of their gathers and ``idx``/``out`` streamed past L2; an ``idx``
view off 16-byte alignment takes the kernel's scalar instance.

CUDA source: ``csrc/banded.cu``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gunrock_tpu_torch.ops.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGNATURES = {
    "gr_banded_gather": [_P, _I, _P, _P, _P, _L, _I, _I, _P],
}


def _check(table2, idx, block_lo, span_rows: int, block_t: int):
    dev = table2.device
    if table2.dim() != 2 or table2.shape[1] != 128:
        raise ValueError(f"table2 must be [n_rows_pad, 128], got shape "
                         f"{tuple(table2.shape)}")
    _build.check_tensor(table2, "table2", torch.int32, table2.shape, dev)
    B = idx.numel()
    if block_t <= 0 or block_t % 128 or B % block_t:
        raise ValueError(f"idx length {B} must be a multiple of block_t "
                         f"{block_t}, itself a multiple of 128")
    _build.check_tensor(idx, "idx", torch.int32, (B,), dev)
    _build.check_tensor(block_lo, "block_lo", torch.int32, (B // block_t,),
                        dev)
    if not 0 < span_rows <= table2.shape[0]:
        raise ValueError(f"span_rows {span_rows} outside (0, "
                         f"{table2.shape[0]}]")


def banded_gather(table2: torch.Tensor, idx: torch.Tensor,
                  block_lo: torch.Tensor, *, span_rows: int,
                  block_t: int = 2048) -> torch.Tensor:
    """int32[B]. ``table2``: int32[n_rows_pad, 128]; ``idx``: int32[B], B a
    multiple of ``block_t``; ``block_lo``: int32[B // block_t], each
    block's first window row. See the module docstring."""
    _check(table2, idx, block_lo, span_rows, block_t)
    dev = table2.device
    if dev.type == "cpu":
        return banded_gather_plain(table2, idx, block_lo,
                                   span_rows=span_rows, block_t=block_t)
    if dev.type != "cuda":
        raise ValueError(f"no banded-gather kernel for device {dev}")
    out = torch.empty_like(idx)
    if idx.numel() == 0:
        return out
    lib = _build.load("banded", _SIGNATURES)
    err = lib.gr_banded_gather(
        _build.ptr(table2), table2.shape[0], _build.ptr(idx),
        _build.ptr(block_lo), _build.ptr(out), idx.numel(), block_t,
        span_rows, _build.stream(dev),
    )
    _build.check(err, "banded_gather")
    _build.LAUNCHES["banded_gather"] += 1
    return out


def banded_gather_plain(table2: torch.Tensor, idx: torch.Tensor,
                        block_lo: torch.Tensor, *, span_rows: int,
                        block_t: int = 2048) -> torch.Tensor:
    """Plain PyTorch version of :func:`banded_gather`."""
    lo = torch.repeat_interleave(block_lo.long() * 128, block_t)
    local = torch.clamp(idx.long() - lo, 0, span_rows * 128 - 1)
    return torch.take(table2, lo + local)


def pad_table(table: np.ndarray, span_rows: int) -> np.ndarray:
    """A flat int32 table padded with zeros to [n_rows_pad, 128], so that
    a window of ``span_rows`` rows starting at any row that holds data
    stays in bounds."""
    n_rows = -(-max(table.size, 1) // 128)
    n_rows_pad = n_rows + span_rows + 1
    out = np.zeros(n_rows_pad * 128, np.int32)
    out[: table.size] = table
    return out.reshape(n_rows_pad, 128)
