"""The banded gather's inputs, in one place for ``probes/pull.py
--banded``, ``chip_smoke.py`` and the tests.

``real_slab`` captures what the first slab of the slabbed triangle count
hands the kernel (``algorithms/tc.py``); ``banded_case`` builds a
synthetic slab (random windows, 10% of the indices out of their window);
``synthetic_slabs`` the probe's slabs of the real slab's size at
``SYNTH_SPANS``; ``edge_cases`` the shapes the main path does not give
the kernel (a window of one row and of ``tc.MAX_SPAN_ROWS``, the sink
window at the table's last rows, indices below and above their window, a
single block, blocks of 128, an idx view off 16-byte alignment);
``bound_bytes`` the bytes a call must move; ``read_indices`` the
positions the kernel reads, for ``index_select``. Only the kernel's and the
triangle count's public calls are used, so the probe copied with this
file into an earlier tree builds that tree's inputs the same way.
"""

from __future__ import annotations

import numpy as np
import torch

TC_SLABS = 5  # slabs of the slabbed triangle count
SYNTH_SPANS = (1, 37, 120, 200)  # 200 is tc.MAX_SPAN_ROWS
SYNTH_BLOCKS = 20_000  # 40,960,000 positions: the real slab's size
SYNTH_TABLE = 3_775_104  # the real slab's table (R-MAT 18), 15 MB


def real_slab(graph) -> tuple:
    """(table2, idx, block_lo, block_t, span_rows) of the first slab of
    ``tc.run`` in ``TC_SLABS`` slabs on ``graph``: what the wrapper was
    given."""
    from gunrock_tpu_torch.algorithms import tc

    slab = []
    kernel = tc.banded_gather

    def capture(table2, idx, block_lo, *, span_rows, block_t):
        if not slab:
            slab.append((table2, idx, block_lo, block_t, span_rows))
        return kernel(table2, idx, block_lo, span_rows=span_rows,
                      block_t=block_t)

    rk = tc.ranked_dag(graph)
    tc.banded_gather = capture
    try:
        tc.run(graph, max_wedges=-(-rk["n_wedges"] // TC_SLABS), warmup=False,
               device=graph.device)
    finally:
        tc.banded_gather = kernel
    return slab[0]


def banded_case(gen, n_table: int, n_blocks: int, block_t: int,
                span_rows: int, device) -> tuple:
    """(table2, idx, block_lo): a random table padded by ``pad_table``,
    every block's window at a random row, 90% of its indices inside the
    window and the rest anywhere in the table or before it (out of
    window: the kernel must return the clamped element). ``gen`` is a
    torch.Generator on ``device``."""
    from gunrock_tpu_torch.ops.kernels.banded import pad_table

    table = torch.randint(0, 1 << 30, (n_table,), generator=gen,
                          device=device, dtype=torch.int32)
    table2 = torch.from_numpy(pad_table(table.cpu().numpy(), span_rows)).to(
        device)
    n_rows = -(-n_table // 128)
    block_lo = torch.randint(0, n_rows, (n_blocks,), generator=gen,
                             device=device, dtype=torch.int32)
    B = n_blocks * block_t
    inside = torch.randint(0, span_rows * 128, (B,), generator=gen,
                           device=device)
    anywhere = torch.randint(-128, table2.numel(), (B,), generator=gen,
                             device=device)
    lo = torch.repeat_interleave(block_lo.long() * 128, block_t)
    out = torch.rand(B, device=device, generator=gen) < 0.1
    idx = torch.where(out, anywhere, lo + inside).int()
    return table2, idx, block_lo


def synthetic_slabs(device, seed: int = 18) -> dict:
    """{"span<r>": (table2, idx, block_lo, block_t, span_rows)} for r in
    ``SYNTH_SPANS``: ``SYNTH_BLOCKS`` blocks of ``tc.BLOCK_T`` over a
    table of ``SYNTH_TABLE`` ints."""
    from gunrock_tpu_torch.algorithms.tc import BLOCK_T

    gen = torch.Generator(device=device).manual_seed(seed)
    return {f"span{r}": banded_case(gen, SYNTH_TABLE, SYNTH_BLOCKS, BLOCK_T,
                                    r, device) + (BLOCK_T, r)
            for r in SYNTH_SPANS}


def bound_bytes(idx, block_lo) -> int:
    """Bytes a call must move: idx read and out written (8 B a position),
    block_lo read, and the table between the least and the greatest index
    read once."""
    reach = int(idx.max()) - int(idx.min()) + 1
    return 8 * idx.numel() + 4 * block_lo.numel() + 4 * reach


def read_indices(idx, block_lo, span_rows: int, block_t: int):
    """int32: the table position each index reads (its clamped one), for
    the library call that gathers the same elements."""
    lo = torch.repeat_interleave(block_lo.long() * 128, block_t)
    return (lo + torch.clamp(idx.long() - lo, 0, span_rows * 128 - 1)).int()


def edge_cases(device, seed: int = 18) -> dict:
    """{name: (table2, idx, block_lo, block_t, span_rows)} at the shapes
    the main path does not give the kernel, each window inside the table
    (the contract): ``span1`` and ``span200`` (a window of one row and of
    ``tc.MAX_SPAN_ROWS`` rows), ``last_rows`` (every window at the padded
    table's last rows, tc's sink window, with indices past the table's
    end), ``clamp`` (every index below or above its window, int32's
    extremes among them, in a block whose window starts at 0, where
    JAX's int32 ``idx - lo`` does not wrap), ``one_block``, ``t128``
    (blocks of 128) and ``unaligned`` (idx a view one int past 16-byte alignment: the
    kernel's scalar instance). Made with numpy from ``seed``, so every
    device gets the same inputs."""
    from gunrock_tpu_torch.ops.kernels.banded import pad_table

    rng = np.random.default_rng(seed)
    i32 = np.iinfo(np.int32)

    def case(n_table, span_rows, block_t, n_blocks, where="random",
             inside=0.9, offset=0):
        table2 = pad_table(rng.integers(0, 1 << 30, n_table).astype(np.int32),
                           span_rows)
        last = table2.shape[0] - span_rows  # the last window that fits
        block_lo = (np.full(n_blocks, last) if where == "last"
                    else rng.integers(0, last + 1, n_blocks))
        if inside == 0.0:
            block_lo[0] = 0  # the extremes' block: idx - lo stays in int32
        lo = np.repeat(block_lo.astype(np.int64) * 128, block_t)
        span = span_rows * 128
        idx = lo + rng.integers(0, span, lo.size)
        out = rng.random(lo.size) >= inside
        below = rng.random(lo.size) < 0.5
        idx[out & below] = lo[out & below] - rng.integers(
            1, 1 << 20, int((out & below).sum()))
        idx[out & ~below] = lo[out & ~below] + span + rng.integers(
            0, 1 << 20, int((out & ~below).sum()))
        if where == "last":  # also past the table's end
            idx[-block_t:] = table2.size + rng.integers(0, 1000, block_t)
        idx = np.clip(idx, i32.min, i32.max).astype(np.int32)
        if inside == 0.0:
            idx[:2], idx[2:4] = i32.min, i32.max
        buf = torch.from_numpy(np.concatenate(
            [np.zeros(offset, np.int32), idx])).to(device)
        return (torch.from_numpy(table2).to(device), buf[offset:],
                torch.from_numpy(block_lo.astype(np.int32)).to(device),
                block_t, span_rows)

    return {
        "span1": case(20_000, 1, 2048, 6),
        "span200": case(60_000, 200, 2048, 3),
        "last_rows": case(10_000, 37, 2048, 4, where="last"),
        "clamp": case(10_000, 5, 256, 8, inside=0.0),
        "one_block": case(5_000, 5, 2048, 1),
        "t128": case(5_000, 3, 128, 40),
        "unaligned": case(8_000, 5, 256, 5, offset=1),
    }
