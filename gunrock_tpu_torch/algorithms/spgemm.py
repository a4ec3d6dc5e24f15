"""SpGEMM: C = A . B for sparse CSR matrices.

Port of ``gunrock_tpu/algorithms/spgemm.py`` (role of reference
``algorithms/spgemm.hxx``, a 3-phase upper-bound / scan / sorted-merge
multiply, spgemm.hxx:124-250). Two strategies:

- **ESC** (expand-sort-contract): every product a_ik * b_kj becomes one
  (i, j, value) triple; the triples are sorted by (i, j); equal keys are
  contracted with a per-run sum. When the expansion exceeds
  ``block_products`` it streams in row-aligned blocks: C rows of different
  blocks are disjoint, so contracting each block alone is exact.
- **dense**: row blocks of A as the columns of a dense operand,
  C_block^T = B^T . dense(A_block^T), through the frontier-sparse bucketed
  SpMM (``ops/kernels/spmm.py``) with the block's distinct columns as the
  active set. Its cost is ceil(V_A / block_rows) passes over B's edges,
  whatever the product count.

What the port does differently from the JAX package, which needs static
shapes: a streamed block is expanded at its own size (no padded edge
slices, no oversized-row executable, no fused device loop over blocks),
the (i, j) sort key is one int64 (``i * n_cols + j``) rather than a
two-key sort, compaction is ``torch.nonzero`` rather than a scatter into a
capped buffer (so the dense path has no ``block_cap``), and results stay
on the device until the caller reads them.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from gunrock_tpu_torch.device import DEFAULT
from gunrock_tpu_torch.formats import Csr
from gunrock_tpu_torch.graph import Graph
from gunrock_tpu_torch.ops.configs import Options
from gunrock_tpu_torch.ops.kernels.layout import pull_layout
from gunrock_tpu_torch.ops.kernels.spmm import bucketed_spmm_sparse
from gunrock_tpu_torch.utils.timer import timed


@dataclasses.dataclass
class Result:
    row_indices: torch.Tensor  # int32, row-sorted (-1 past nnz if padded)
    col_indices: torch.Tensor  # int32
    values: torch.Tensor  # float32; count_only: [checksum]
    nnz: int
    elapsed_ms: float

    def to_csr(self, n_rows: int, n_cols: int) -> Csr:
        """Materialize a host CSR (drops padding)."""
        nnz = int(self.nnz)
        rows = self.row_indices[:nnz].cpu().numpy()
        offsets = np.zeros(n_rows + 1, dtype=np.int32)
        np.cumsum(np.bincount(rows, minlength=n_rows), out=offsets[1:])
        return Csr(
            n_rows=n_rows,
            n_cols=n_cols,
            row_offsets=offsets,
            col_indices=self.col_indices[:nnz].cpu().numpy().astype(np.int32),
            values=self.values[:nnz].cpu().numpy().astype(np.float32),
        )


def _count_result(nnz: int, checksum: float, elapsed_ms: float, dev) -> Result:
    e = torch.zeros(0, dtype=torch.int32, device=dev)
    return Result(row_indices=e, col_indices=e,
                  values=torch.tensor([checksum], dtype=torch.float32,
                                      device=dev),
                  nnz=nnz, elapsed_ms=elapsed_ms)


def _piecewise(first, steps, off, total: int, slope: int):
    """int64[total]: the cumulative sum of a stream that starts at
    ``first``, rises by ``slope`` per slot, and takes the correction
    ``steps[e]`` at slot ``off[e + 1]`` (corrections at or past ``total``
    are dropped; coincident ones add up)."""
    pos = torch.clamp(off[1:], max=total)  # slot `total` is cut below
    d = torch.full((total + 1,), slope, dtype=torch.int64, device=off.device)
    d.index_add_(0, pos, steps)
    return torch.cumsum(d[:total], 0) + (first - slope)


def _piecewise_constant(rows, off, total: int):
    """int64[total]: ``rows[e]`` over the slots ``off[e]`` to ``off[e+1]``
    of each edge e (see :func:`_piecewise_expand`)."""
    rows, off = rows.long(), off.long()
    return _piecewise(rows[0], rows[1:] - rows[:-1], off, total, 0)


def _piecewise_expand(rows, b_start, off, total: int):
    """Expand per-edge (row, B-row-start) to per-product (i, b_e).

    Within the product segment of A-edge ``e`` (slots ``off[e]`` to
    ``off[e+1]``), ``i`` is constant ``rows[e]`` and ``b_e`` counts up from
    ``b_start[e]``: both are piecewise-arithmetic over the product axis,
    so they are the cumulative sum of a delta stream with per-edge
    corrections added at the segment starts (empty segments telescope:
    coincident corrections sum to the last edge's value). ``rows``,
    ``b_start`` and ``off`` (the expansion offset of each edge, off[0] ==
    0) have one entry per edge; segment starts at or past ``total`` are
    dropped. Returns int64 (i, b_e) of length ``total``; slots past the
    last real segment are the caller's to mask."""
    b_start, off = b_start.long(), off.long()
    steps = (b_start[1:] - b_start[:-1]) - (off[1:] - off[:-1])
    return (_piecewise_constant(rows, off, total),
            _piecewise(b_start[0], steps, off, total, 1))


def _expand(a_row, a_col, a_val, b_offsets, b_col, b_val, off, total: int):
    """The (i, j, value) triples of the products of the A edges given,
    ``off`` (int[n_edges + 1], off[0] == 0, off[-1] == total) being their
    expansion offsets."""
    n_edges = a_row.numel()
    off = off.long()
    marks = torch.zeros(total + 1, dtype=torch.int64, device=a_row.device)
    marks.index_add_(0, off, torch.ones_like(off))
    a_id = torch.clamp(torch.cumsum(marks[:total], 0) - 1, 0, n_edges - 1)
    b_start = b_offsets[a_col.long()]
    i, b_e = _piecewise_expand(a_row, b_start, off[:-1], total)
    return i, b_col[b_e].long(), a_val[a_id] * b_val[b_e]


def _sort_runs(i, j, n_cols: int):
    """Sort the (i, j) keys; returns (perm, sorted i, sorted j, first:
    whether each sorted entry starts a run of equal keys)."""
    key, perm = torch.sort(i * n_cols + j)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    return perm, key // n_cols, key % n_cols, first


def _contract(i, j, v, n_cols: int):
    """Contract equal (i, j) keys. Returns (rows int32, cols int32, vals
    f32) of the distinct keys in (i, j) order, and their count as a
    tensor. Values are summed within each run (not as differences of a
    global prefix, which loses the small runs at the tail)."""
    perm, i_s, j_s, first = _sort_runs(i, j, n_cols)
    run = torch.cumsum(first, 0) - 1
    n_runs = first.sum()
    vals = torch.zeros(int(n_runs), dtype=torch.float32, device=v.device)
    vals.index_add_(0, run, v[perm])
    return i_s[first].int(), j_s[first].int(), vals, n_runs


def spgemm_kernel(a_row, a_col, a_val, b_offsets, b_col, b_val, exp_offsets,
                  total: int):
    """ESC SpGEMM of the A edges (CSR order) with B, ``exp_offsets``
    (int[Ea + 1]) being the expansion offsets. Returns (rows, cols, vals,
    nnz) padded to ``total`` with -1 / 0."""
    dev = a_row.device
    rows = torch.full((total,), -1, dtype=torch.int32, device=dev)
    cols = torch.full((total,), -1, dtype=torch.int32, device=dev)
    vals = torch.zeros(total, dtype=torch.float32, device=dev)
    if total == 0:
        return rows, cols, vals, torch.zeros((), dtype=torch.int64, device=dev)
    r, c, v, n_runs = _contract(
        *_expand(a_row, a_col, a_val, b_offsets, b_col, b_val, exp_offsets,
                 total), b_offsets.numel() - 1)
    k = r.numel()
    rows[:k], cols[:k], vals[:k] = r, c, v
    return rows, cols, vals, n_runs


def _block_kernel(A: Graph, B: Graph, e0: int, e1: int, off,
                  count_only: bool = False):
    """One streamed ESC block: the A edges [e0, e1) (whole rows) against
    B, ``off`` (int[e1 - e0 + 1], rebased to 0) being their expansion
    offsets. ``count_only`` keeps the values out of the sort and returns
    (distinct keys, value checksum) as tensors; otherwise (rows, cols,
    vals, distinct keys, checksum)."""
    total = int(off[-1])
    off = torch.as_tensor(off, device=A.device)
    i, j, v = _expand(A.edge_src[e0:e1], A.col_indices[e0:e1],
                      A.values[e0:e1], B.row_offsets, B.col_indices,
                      B.values, off, total)
    if count_only:
        return _sort_runs(i, j, B.n_vertices)[3].sum(), v.sum()
    rows, cols, vals, n_runs = _contract(i, j, v, B.n_vertices)
    return rows, cols, vals, n_runs, vals.sum()


def _plan_blocks(exp_row_offsets: np.ndarray, budget: int):
    """Greedy row-aligned block plan: consecutive A-row ranges whose
    expansion fits the product budget. A single row larger than the budget
    gets its own (oversized) block. Returns list of (row_start, row_end)."""
    n_rows = exp_row_offsets.shape[0] - 1
    blocks = []
    r = 0
    while r < n_rows:
        limit = exp_row_offsets[r] + budget
        # last row end with cumulative expansion <= limit
        e = int(np.searchsorted(exp_row_offsets, limit, side="right")) - 1
        if e <= r:
            e = r + 1  # oversized single row
        blocks.append((r, min(e, n_rows)))
        r = min(e, n_rows)
    return blocks


def _gather_result(parts, count_only: bool, elapsed, dev) -> Result:
    """The Result of per-block outputs (tuples ending in distinct keys,
    checksum). Counts and checksums are summed on the host in int64 /
    float64: count_only exists for products too big to materialize."""
    nnz = int(torch.stack([p[-2] for p in parts]).cpu().numpy()
              .astype(np.int64).sum()) if parts else 0
    if count_only:
        checksum = float(torch.stack([p[-1] for p in parts]).double().sum()
                         ) if parts else 0.0
        return _count_result(nnz, checksum, elapsed, dev)

    def cat(k, dtype):
        return (torch.cat([p[k] for p in parts]) if parts
                else torch.zeros(0, dtype=dtype, device=dev))

    return Result(row_indices=cat(0, torch.int32),
                  col_indices=cat(1, torch.int32),
                  values=cat(2, torch.float32), nnz=nnz, elapsed_ms=elapsed)


def _run_streaming(A: Graph, a_offsets: np.ndarray, exp_offsets: np.ndarray,
                   B: Graph, budget: int, count_only: bool) -> Result:
    """Row-blocked streaming ESC over the plan of :func:`_plan_blocks`, in
    row order. In ``count_only`` mode the Result carries nnz and a value
    checksum (in ``values[0]``) and nothing is read back before the end."""
    blocks = _plan_blocks(exp_offsets[a_offsets], budget)

    def fn():
        parts = []
        for r0, r1 in blocks:
            e0, e1 = int(a_offsets[r0]), int(a_offsets[r1])
            off = exp_offsets[e0: e1 + 1] - exp_offsets[e0]
            if off[-1]:
                parts.append(_block_kernel(A, B, e0, e1, off, count_only))
        return parts

    parts, elapsed = timed(A.device, fn, warmup=False)
    return _gather_result(parts, count_only, elapsed, A.device)


def _dense_block_kernel(layout, A: Graph, e0: int, e1: int, row_start: int,
                        block_rows: int, count_only: bool = False):
    """One dense row block: C[r0:r0+K, :] = A[r0:r0+K, :] @ B computed as
    C_block^T = B^T @ dense(A_block^T) through the bucketed SpMM over
    ``layout`` (B's pull layout): one pass over B's edges, no sort. The
    operand is row-sparse (only the block's distinct columns are
    nonzero), so the pass is the frontier-sparse SpMM with those columns
    active. ``count_only`` (unit values in ``layout``) counts structure
    and returns (nonzeros, checksum) as tensors; otherwise (rows, cols,
    vals, nonzeros, checksum), row-major."""
    V, dev = A.n_vertices, A.device
    c = A.col_indices[e0:e1].long()
    k_slot = A.edge_src[e0:e1].long() - row_start
    v = torch.ones_like(c, dtype=torch.float32) if count_only \
        else A.values[e0:e1]
    x = torch.zeros((V, block_rows), dtype=torch.float32, device=dev)
    x.index_put_((c, k_slot), v, accumulate=True)
    active = torch.zeros(V, dtype=torch.bool, device=dev)
    active[c] = True
    y = bucketed_spmm_sparse(layout, x, active, exact=count_only)  # C_block^T
    if count_only:
        return (y != 0).sum(), y.sum()
    yt = y.T
    at = torch.nonzero(yt)  # row-major over (k, j)
    vals = yt[at[:, 0], at[:, 1]]
    return ((row_start + at[:, 0]).int(), at[:, 1].int(), vals,
            torch.as_tensor(at.shape[0], device=dev), vals.sum())


def _run_dense(A: Graph, B: Graph, count_only: bool,
               block_rows: int | None = None) -> Result:
    """Dense row-block SpGEMM (strategy="dense"). Materializing mode
    counts NUMERICAL nonzeros (an exactly-zero accumulation is dropped);
    ``count_only`` counts STRUCTURAL ones with unit values (matches ESC;
    identical for positive weights), and its checksum has the closed form
    sum(C) = sum_j colsum_A(j) * rowsum_B(j), taken on the host in
    float64. ``block_rows`` defaults to 512 when counting and 256 when
    materializing, the JAX package's widths."""
    V = A.n_vertices
    if block_rows is None:
        block_rows = 512 if count_only else 256
    layout = pull_layout(B, unit=count_only)
    a_off = A.host["row_offsets"]

    def fn():
        parts = []
        for r0 in range(0, V, block_rows):
            r1 = min(r0 + block_rows, V)
            e0, e1 = int(a_off[r0]), int(a_off[r1])
            if e1 > e0:
                parts.append(_dense_block_kernel(
                    layout, A, e0, e1, r0, r1 - r0, count_only))
        return parts

    parts, elapsed = timed(A.device, fn, warmup=False)
    res = _gather_result(parts, count_only, elapsed, A.device)
    if count_only:
        colsum_a = np.bincount(A.host["col_indices"],
                               weights=A.host["values"].astype(np.float64),
                               minlength=B.n_vertices)
        rowsum_b = np.bincount(B.host["edge_src"],
                               weights=B.host["values"].astype(np.float64),
                               minlength=B.n_vertices)
        res = _count_result(res.nnz, float(np.dot(colsum_a, rowsum_b)),
                            elapsed, A.device)
    return res


def product_count(A: Graph, B: Graph) -> int:
    """The number of partial products a_ik * b_kj of A . B."""
    deg_b = np.diff(B.host["row_offsets"]).astype(np.int64)
    return int(deg_b[A.host["col_indices"]].sum())


def pick_strategy(A: Graph, B: Graph) -> str:
    """What ``strategy="auto"`` runs: "dense" when the partial products
    exceed K * ceil(V_A / 128) * E_B, else "esc". K comes from the
    GUNROCK_SPGEMM_AUTO_K environment variable and defaults to 0.16, the
    JAX package's crossover as calibrated on its TPU (not yet on the
    card)."""
    k = float(os.environ.get("GUNROCK_SPGEMM_AUTO_K", "0.16"))
    dense_work = (-(-A.n_vertices // 128)) * max(B.n_edges, 1)
    return "dense" if product_count(A, B) > k * dense_work else "esc"


def run(
    A: Graph,
    B: Graph,
    options: Options | None = None,
    warmup: bool = True,
    block_products: int = 8_000_000,
    count_only: bool = False,
    strategy: str = "auto",
    device=DEFAULT,
) -> Result:
    """Role of reference ``spgemm::run`` (spgemm.hxx:287-315) on
    ``device``: C = A.B over the CSR views of two graphs.

    ``strategy="esc"``: expand-sort-contract, streamed in row-aligned
    blocks when the expansion exceeds ``block_products``.
    ``strategy="dense"``: dense row blocks through the bucketed SpMM
    kernel. ``strategy="auto"`` (default): :func:`pick_strategy`.
    ``count_only=True`` returns only nnz and a value checksum
    (``values[0]``): the structure-analysis mode for products too large to
    materialize."""
    del options
    A, B = A.to(device), B.to(device)
    if A.n_vertices != B.n_vertices:
        raise ValueError(f"A has {A.n_vertices} columns, B {B.n_vertices} "
                         "rows")
    if strategy == "auto":
        strategy = pick_strategy(A, B)
    if strategy == "dense":
        return _run_dense(A, B, count_only)
    if strategy != "esc":
        raise ValueError(f"unknown SpGEMM strategy {strategy!r}")
    a_offsets = A.host["row_offsets"]
    deg_b = np.diff(B.host["row_offsets"]).astype(np.int64)
    exp_offsets = np.zeros(A.n_edges + 1, dtype=np.int64)
    np.cumsum(deg_b[A.host["col_indices"]], out=exp_offsets[1:])
    total = int(exp_offsets[-1])
    if total > block_products:
        return _run_streaming(A, a_offsets, exp_offsets, B, block_products,
                              count_only)
    eo = torch.from_numpy(exp_offsets).to(A.device)

    def fn():
        return spgemm_kernel(A.edge_src, A.col_indices, A.values,
                             B.row_offsets, B.col_indices, B.values, eo, total)

    (rows, cols, vals, nnz), elapsed_ms = timed(A.device, fn,
                                                warmup and total > 0)
    if count_only:
        return _count_result(int(nnz), float(vals.sum()), elapsed_ms,
                             A.device)
    return Result(row_indices=rows, col_indices=cols, values=vals,
                  nnz=int(nnz), elapsed_ms=elapsed_ms)
